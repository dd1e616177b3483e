"""The decoder-only LM: the training loss, prefill and per-lane decode,
ported from the reference's ``repro/models/lm.py`` for the dense, SSM and
hybrid families.

The reference scans over layer-stacked params; here each layer group is a
list of per-layer parameter modules and the scan is a Python loop. Caches
keep the reference's stacked layout — ``{"s0": {"attn": {"k": (L, B, S, KV,
Dh), "v": ...}, "ssm": {"conv": (L, B, K-1, C), "state": (L, B, H, P, N)}}}``
— and decode writes each lane's new row, conv window and state into them
in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map
from .blocks import (
    _norm,
    _norm_params,
    block_apply,
    block_cache_shape,
    block_params,
    check_supported,
)
from .common import DTYPES, ParamTree, StackedInit, init_params, resolve_device


@dataclass(frozen=True)
class StackGroup:
    kind: str  # scan | single
    count: int
    name: str
    moe: bool
    is_global: bool  # full attention (ignores cfg.window)


def stack_plan(
    cfg, num_layers: Optional[int] = None, *, block_kind: str = "decoder"
) -> list[StackGroup]:
    L = num_layers if num_layers is not None else cfg.num_layers
    g_set = set(cfg.global_layers) if block_kind != "encoder" else set()
    first_dense = cfg.first_dense_layers if block_kind == "decoder" else L + 1

    def attrs(layer: int) -> tuple[bool, bool]:
        is_global = layer in g_set
        is_moe = cfg.is_moe and block_kind == "decoder" and layer >= first_dense
        return is_global, is_moe

    groups: list[StackGroup] = []
    i = 0
    while i < L:
        is_global, is_moe = attrs(i)
        if is_global:
            groups.append(StackGroup("single", 1, f"g{len(groups)}", is_moe, True))
            i += 1
        else:
            j = i
            while j < L and attrs(j) == (False, is_moe):
                j += 1
            groups.append(StackGroup("scan", j - i, f"s{len(groups)}", is_moe, False))
            i = j
    return groups


def param_tree(cfg, a) -> dict:
    """The parameter tree, with the reference's names and shapes. A scan
    group's leaves are drawn stacked (as the reference draws them) and
    split into one entry per layer."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    p: dict = {"embed": a.param((V, d), "embed", scale=d**-0.5)}
    layers: dict = {}
    for grp in stack_plan(cfg):
        if grp.kind == "scan":
            stacked = block_params(cfg, StackedInit(a, grp.count))
            layers[grp.name] = [
                tree_map(lambda t, i=i: t[i], stacked) for i in range(grp.count)
            ]
        else:
            layers[grp.name] = block_params(cfg, a)
    p["layers"] = layers
    p["final_norm"] = _norm_params(cfg, a)
    if not cfg.tie_embeddings:
        p["lm_head"] = a.param((d, V))
    return p


def cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE in f32. Returns (loss, token_count)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    ce = lse - ll
    if mask is None:
        return ce.mean(), torch.tensor(float(ce.numel()), device=ce.device)
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    return (ce * m).sum() / n, n


class Model:
    """Decoder LM (dense, SSM or hybrid) over a parameter tree (``ParamTree``).

    ``device`` defaults to ``cuda:0`` and raises without a GPU; tests pass
    ``device="cpu"``. ``loss`` builds the autograd graph (the layers under
    ``torch.utils.checkpoint`` when ``cfg.remat`` is not "none");
    ``prefill`` and ``decode_step`` run under ``torch.inference_mode`` on the
    calling thread.
    """

    def __init__(self, cfg, device=None) -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.plan = stack_plan(cfg)

    def init(self, seed: int = 0) -> ParamTree:
        """Random parameters from ``seed`` (the reference's init laws)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return init_params(self.cfg, g, self.device, self.dtype)

    # -- helpers ------------------------------------------------------------------

    def _as_index(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.long)
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def _embed_tokens(self, p, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its backward sums rows without atomics on the card
        x = F.embedding(tokens, p["embed"]).to(self.dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype)
        return x

    def _head(self, p, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, p["embed"])
        return torch.einsum("bsd,dv->bsv", x, p["lm_head"])

    def _layers(self, p, x, positions, *, caches=None, cache_index=None, forward=False):
        """The layer loop. Prefill (no ``caches``) returns the new caches,
        stacked per scan group; decode hands each layer views of its slice
        of ``caches``, writes into them in place and returns None. The
        training ``forward`` builds no cache and, when ``cfg.remat`` is not
        "none" and grad is on, runs each layer under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward, as the reference's ``jax.checkpoint``)."""
        if forward:
            remat = self.cfg.remat != "none" and torch.is_grad_enabled()
            for grp in self.plan:
                window = None if grp.is_global else self.cfg.window
                gp = p["layers"][grp.name]
                for lp in gp if grp.kind == "scan" else [gp]:
                    run = lambda xx, lp=lp, w=window: block_apply(  # noqa: E731
                        self.cfg, lp, xx, positions, window=w
                    )[0]
                    x = checkpoint(run, x, use_reentrant=False) if remat else run(x)
            return x, None
        prefill = caches is None
        caches_out: dict = {}
        for grp in self.plan:
            window = None if grp.is_global else self.cfg.window
            gp = p["layers"][grp.name]
            layer_params = gp if grp.kind == "scan" else [gp]
            new = []
            for i, lp in enumerate(layer_params):
                cache = None
                if not prefill:
                    cache = caches[grp.name]
                    if grp.kind == "scan":
                        cache = tree_map(lambda c, i=i: c[i], cache)
                x, nc = block_apply(
                    self.cfg, lp, x, positions, cache=cache, cache_index=cache_index,
                    return_cache=prefill, window=window,
                )
                new.append(nc)
            if prefill:
                caches_out[grp.name] = (
                    tree_map(lambda *cs: torch.stack(cs), *new) if grp.kind == "scan" else new[0]
                )
        return x, (caches_out if prefill else None)

    # -- train -------------------------------------------------------------------

    def loss(self, p, batch: dict) -> Tuple[torch.Tensor, dict]:
        """Token-mean cross-entropy of ``batch["targets"]`` (optionally
        weighted by ``batch["loss_mask"]``) given ``batch["tokens"]``, both
        (B, S), with autograd: ``loss.backward()`` or ``torch.autograd.grad``
        gives every parameter's gradient. Returns (loss, {"ce", "aux",
        "tokens"}); the dense, SSM and hybrid families have no auxiliary
        loss, so ``aux`` is 0. On the card, SSM layers raise until the SSD
        kernel has a backward."""
        cfg = self.cfg
        tokens = self._as_index(batch["tokens"])
        x = self._embed_tokens(p, tokens)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, _ = self._layers(p, x, positions, forward=True)
        x = _norm(cfg, p["final_norm"], x)
        targets = self._as_index(batch["targets"])
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        if cfg.loss_chunk and S > cfg.loss_chunk:
            ce, n = self._chunked_ce(p, x, targets, mask, cfg.loss_chunk)
        else:
            ce, n = cross_entropy(self._head(p, x), targets, mask)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": n}

    def _chunked_ce(self, p, x, targets, mask, chunk: int):
        """CE over ``chunk``-position slices whose logits are recomputed in
        the backward (``torch.utils.checkpoint``), so the full (B, S, V)
        logits never exist at once. Positions past the last whole chunk are
        dropped, as in the reference."""
        S = x.shape[1]
        nc = S // chunk
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=x.device)

        def one(xx, tt, mm):
            lf = self._head(p, xx).float()
            lse = torch.logsumexp(lf, dim=-1)
            ll = torch.gather(lf, -1, tt[..., None].long())[..., 0]
            return ((lse - ll) * mm).sum()

        sums, ns = [], []
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            mm = mask[:, sl].float()
            part = (checkpoint(one, x[:, sl], targets[:, sl], mm, use_reentrant=False)
                    if torch.is_grad_enabled() else one(x[:, sl], targets[:, sl], mm))
            sums.append(part)
            ns.append(mm.sum())
        n = torch.clamp(torch.stack(ns).sum(), min=1.0)
        return torch.stack(sums).sum() / n, n

    # -- serving ------------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, p, batch: dict, *, last_pos=None) -> Tuple[torch.Tensor, dict]:
        """Fill the KV cache for a prompt; logits for the next-token position.

        ``last_pos`` (int, optional) selects which position's logits to
        return; default is the final one. The engine uses it for
        right-padded prompt buckets: pad tokens fill cache slots beyond
        ``last_pos`` but are causally invisible to it, and decode masks them
        via the valid length before they are ever attended.
        """
        tokens = self._as_index(batch["tokens"])
        x = self._embed_tokens(p, tokens)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, caches = self._layers(p, x, positions)
        x = _norm(self.cfg, p["final_norm"], x)
        t = S - 1 if last_pos is None else int(last_pos)
        return self._head(p, x[:, t : t + 1]), caches

    @torch.inference_mode()
    def decode_step(self, p, tokens, caches: dict, index) -> Tuple[torch.Tensor, dict]:
        """One new token per lane. tokens: (B, 1); index: (B,) — each lane's
        position, which is also its cache write offset and valid length
        minus one. ``caches`` is updated in place and returned."""
        tokens = self._as_index(tokens)
        index = self._as_index(index).reshape(-1)
        x = self._embed_tokens(p, tokens)
        x, _ = self._layers(p, x, index[:, None], caches=caches, cache_index=index)
        x = _norm(self.cfg, p["final_norm"], x)
        return self._head(p, x), caches

    def cache_shapes(self, batch: int, seq: int) -> dict:
        """Meta tensors with the shape and dtype of every cache leaf."""
        out = {}
        for grp in self.plan:
            one = block_cache_shape(self.cfg, batch, seq, self.dtype, is_global=grp.is_global)
            if grp.kind == "scan":
                one = tree_map(
                    lambda m, n=grp.count: torch.empty((n, *m.shape), dtype=m.dtype, device="meta"),
                    one,
                )
            out[grp.name] = one
        return out


def extend_caches(caches: dict, extra: int, *, window: Optional[int] = None) -> dict:
    """Pad attention caches by ``extra`` positions (decode continuation);
    ``window`` re-lays sliding-window rings to ``min(window, prompt + extra)``."""
    from ..serve.kv import pad_caches_to, ring_modulus

    ring_w = None
    if window is not None:
        w0 = ring_modulus(caches)
        if w0 is not None:
            ring_w = min(window, w0 + extra)
    return pad_caches_to(caches, extra, ring_w=ring_w)


def build_model(cfg, device=None) -> Model:
    return Model(cfg, device=device)
