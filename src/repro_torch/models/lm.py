"""The language models: the training loss, prefill and per-lane decode,
ported from the reference's ``repro/models/lm.py`` for the decoder-only
dense, MoE, SSM, hybrid and VLM families and the whisper-style
encoder-decoder. The VLM's prompt is its projected image patches followed
by its text, under a prefix-LM mask over the patches, and its loss is taken
over the text; the encoder-decoder encodes precomputed audio frames
(bidirectional, sinusoidal positions) and its decoder cross-attends to
them, from a static ``cross`` cache in decode.

The reference scans over layer-stacked params; here each layer group is a
list of per-layer parameter modules and the scan is a Python loop. Caches
keep the reference's stacked layout — ``{"s0": {"attn": {"k": (L, B, S, KV,
Dh), "v": ...}, "ssm": {"conv": (L, B, K-1, C), "state": (L, B, H, P, N)}}}``,
MLA's ``{"ckv": (L, B, S, kv_lora), "krope": (L, B, S, rope)}`` — and
decode writes each lane's new row, conv window and state into them
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
from .common import DTYPES, Abstract, Axes, ParamTree, StackedInit, init_params, resolve_device


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


def encoder_plan(cfg) -> Optional[list[StackGroup]]:
    """The encoder's layer plan, or None for a decoder-only config."""
    return stack_plan(cfg, cfg.encoder_layers, block_kind="encoder") if cfg.is_encdec else None


def _stack_params(cfg, a, plan: list[StackGroup], kind: str) -> dict:
    """One entry per layer group: a scan group's leaves are drawn stacked
    (as the reference draws them) and split into one entry per layer (a
    layer's logical axes are the stacked leaf's without ``layers``)."""
    layers: dict = {}
    for grp in plan:
        if grp.kind == "scan":
            stacked = block_params(cfg, StackedInit(a, grp.count), kind=kind, moe_layer=grp.moe)
            layers[grp.name] = [
                tree_map((lambda t: t[1:]) if a.mode == "axes" else (lambda t, i=i: t[i]), stacked)
                for i in range(grp.count)
            ]
        else:
            layers[grp.name] = block_params(cfg, a, kind=kind, moe_layer=grp.moe)
    return layers


def param_tree(cfg, a) -> dict:
    """The parameter tree, with the reference's names and shapes, drawn in
    the reference's order."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    p: dict = {"embed": a.param((V, d), "embed", scale=d**-0.5, axes=("vocab", "embed"))}
    p["layers"] = _stack_params(cfg, a, stack_plan(cfg),
                                "xdecoder" if cfg.is_encdec else "decoder")
    p["final_norm"] = _norm_params(cfg, a)
    if not cfg.tie_embeddings:
        p["lm_head"] = a.param((d, V), axes=("embed", "vocab"))
    if cfg.is_encdec:
        p["enc_layers"] = _stack_params(cfg, a, encoder_plan(cfg), "encoder")
        p["enc_norm"] = _norm_params(cfg, a)
    if cfg.family == "vlm":
        p["vision_proj"] = a.param((cfg.vision_dim, d), axes=(None, "embed"))
    return p


def sinusoidal_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    """f32 sinusoidal position embeddings ``(..., d)``: sines then cosines
    of ``positions`` (any shape) over ``d / 2`` geometric frequencies."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    """A decoder LM (dense, MoE, SSM, hybrid or VLM) or the encoder-decoder,
    over a parameter tree (``ParamTree``). A VLM's batch carries
    ``"patches"`` (B, num_image_tokens, vision_dim) beside ``"tokens"``, an
    encoder-decoder's ``"frames"`` (B, encoder_seq, d_model).

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
        self.enc_plan = encoder_plan(cfg)

    def init(self, seed: int = 0) -> ParamTree:
        """Random parameters from ``seed`` (the reference's init laws)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return init_params(self.cfg, g, self.device, self.dtype)

    def abstract_params(self) -> dict:
        """The parameter tree as meta tensors (shapes and dtypes, nothing
        drawn), in the layout of ``init``'s ``ParamTree.tree()``."""
        return param_tree(self.cfg, Abstract(self.dtype))

    def logical_axes(self) -> dict:
        """Each parameter's logical-axes tuple (``embed``, ``heads``, ...),
        in the layout of :meth:`abstract_params`: a layer group's entries
        carry the reference's stacked axes without its ``layers``."""
        return param_tree(self.cfg, Axes())

    # -- helpers ------------------------------------------------------------------

    def _as_index(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.long)
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def _as_input(self, a) -> torch.Tensor:
        """A float input (frames, patches) on the model's device and dtype."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(self.device, self.dtype)

    def _embed_tokens(self, p, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
        """Token embeddings. Under a mesh (``ctx``) ``tokens`` are this
        rank's rows, whole along the sequence, and the result is this rank's
        block of the residual stream: with the vocabulary split over the
        model axis each rank looks up its own rows and the partial sums are
        reduce-scattered over the sequence (all-reduced where it is whole);
        otherwise the table is gathered whole."""
        w = p["embed"]
        if ctx is not None and ctx.n_model > 1 and ctx.model_dim(w) == 0:
            Vl = w.shape[0]
            t = tokens - ctx.model_rank * Vl
            mine = ((t >= 0) & (t < Vl)).to(w.dtype)
            x = ctx.seq_reduce(F.embedding(t.clamp(0, Vl - 1), w) * mine[..., None])
            x = x.to(self.dtype)
        elif ctx is not None:
            x = ctx.constrain_activations(F.embedding(tokens, ctx.gather(w))).to(self.dtype)
        else:
            # F.embedding: its backward sums rows without atomics on the card
            x = F.embedding(tokens, w).to(self.dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype)
        return x

    def _head(self, p, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, p["embed"])
        return torch.einsum("bsd,dv->bsv", x, p["lm_head"])

    def _input_states(self, p, batch: dict) -> Tuple[torch.Tensor, Optional[int]]:
        """The token embeddings, after a VLM's projected patches, with
        sinusoidal positions where the config has no RoPE. Returns (x,
        prefix_len): the VLM's prefix-LM span, else None."""
        cfg = self.cfg
        x = self._embed_tokens(p, self._as_index(batch["tokens"]))
        prefix_len = None
        if cfg.family == "vlm" and "patches" in batch:
            pv = torch.einsum("bnv,vd->bnd", self._as_input(batch["patches"]), p["vision_proj"])
            x = torch.cat([pv, x], dim=1)
            prefix_len = cfg.num_image_tokens
        if not cfg.use_rope:
            S = x.shape[1]
            x = x + sinusoidal_emb(torch.arange(S, device=self.device),
                                   cfg.d_model).to(self.dtype)[None]
        return x, prefix_len

    def _encode(self, p, frames) -> torch.Tensor:
        """The encoder: frames plus sinusoidal positions through the
        bidirectional encoder layers, then its final norm."""
        x = self._as_input(frames)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x = x + sinusoidal_emb(positions, self.cfg.d_model).to(self.dtype)[None]
        x, _ = self._layers(p, x, positions, forward=True, encoder=True)
        return _norm(self.cfg, p["enc_norm"], x)

    def _layers(self, p, x, positions, *, caches=None, cache_index=None, forward=False,
                encoder=False, prefix_len=None, enc_out=None, ctx=None):
        """The layer loop. Prefill (no ``caches``) returns the new caches,
        stacked per scan group; decode hands each layer views of its slice
        of ``caches``, writes into them in place and returns None. The
        training ``forward`` builds no cache, returns the sum of the layers'
        MoE aux losses in place of the caches and, when ``cfg.remat`` is not
        "none" and grad is on, runs each layer under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward, as the reference's ``jax.checkpoint``). ``encoder`` runs
        the encoder's layers (bidirectional, forward only); ``prefix_len``
        and ``enc_out`` reach every decoder layer. ``ctx`` (a mesh) reaches
        every layer, with ``x`` this rank's block of the residual stream."""
        plan, layers = (self.enc_plan, p["enc_layers"]) if encoder else (self.plan, p["layers"])
        kw = dict(bidirectional=encoder, prefix_len=prefix_len, enc_out=enc_out)
        if ctx is not None:
            kw["ctx"] = ctx
        if forward:
            remat = self.cfg.remat != "none" and torch.is_grad_enabled()
            total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for grp in plan:
                window = None if grp.is_global else self.cfg.window
                gp = layers[grp.name]
                for lp in gp if grp.kind == "scan" else [gp]:
                    run = lambda xx, lp=lp, w=window: block_apply(  # noqa: E731
                        self.cfg, lp, xx, positions, window=w, **kw
                    )[::2]
                    x, aux = checkpoint(run, x, use_reentrant=False) if remat else run(x)
                    if aux is not None:
                        total_aux = total_aux + aux
            return x, total_aux
        prefill = caches is None
        caches_out: dict = {}
        for grp in plan:
            window = None if grp.is_global else self.cfg.window
            gp = layers[grp.name]
            layer_params = gp if grp.kind == "scan" else [gp]
            new = []
            for i, lp in enumerate(layer_params):
                cache = None
                if not prefill:
                    cache = caches[grp.name]
                    if grp.kind == "scan":
                        cache = tree_map(lambda c, i=i: c[i], cache)
                x, nc, _aux = block_apply(
                    self.cfg, lp, x, positions, cache=cache, cache_index=cache_index,
                    return_cache=prefill, window=window, **kw,
                )
                new.append(nc)
            if prefill:
                caches_out[grp.name] = (
                    tree_map(lambda *cs: torch.stack(cs), *new) if grp.kind == "scan" else new[0]
                )
        return x, (caches_out if prefill else None)

    # -- train -------------------------------------------------------------------

    def loss(self, p, batch: dict, ctx=None) -> Tuple[torch.Tensor, dict]:
        """Token-mean cross-entropy of ``batch["targets"]`` (optionally
        weighted by ``batch["loss_mask"]``) given ``batch["tokens"]``, both
        (B, S), plus the MoE layers' load-balancing aux loss, with autograd:
        ``loss.backward()`` or ``torch.autograd.grad`` gives every
        parameter's gradient. Returns (loss, {"ce", "aux", "tokens"}); the
        families other than MoE have no auxiliary loss, so their ``aux`` is
        0. A VLM's loss is taken over its text only, after the patches; an
        encoder-decoder's decoder attends to ``batch["frames"]`` encoded.

        Under a mesh (``ctx``) ``batch`` is the global batch and ``p`` this
        rank's shards: :meth:`_loss_sharded`."""
        if ctx is not None:
            return self._loss_sharded(p, batch, ctx)
        cfg = self.cfg
        enc_out = self._encode(p, batch["frames"]) if cfg.is_encdec else None
        x, prefix_len = self._input_states(p, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, aux = self._layers(p, x, positions, forward=True, prefix_len=prefix_len,
                              enc_out=enc_out)
        x = _norm(cfg, p["final_norm"], x)
        if prefix_len:  # loss only over the text suffix
            x = x[:, prefix_len:]
        targets = self._as_index(batch["targets"])
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        if cfg.loss_chunk and S > cfg.loss_chunk:
            ce, n = self._chunked_ce(p, x, targets, mask, cfg.loss_chunk)
        else:
            ce, n = cross_entropy(self._head(p, x), targets, mask)
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

    def _head_weight(self, p, ctx):
        """The head's weight and its vocabulary dim, and whether this rank
        holds a block of the vocabulary (else the weight is gathered whole)."""
        w, vdim = (p["embed"], 0) if self.cfg.tie_embeddings else (p["lm_head"], 1)
        if ctx.n_model > 1 and ctx.model_dim(w) == vdim:
            return w, True
        return ctx.gather(w), False

    def _logits(self, x, w):
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, w)
        return torch.einsum("bsd,dv->bsv", x, w)

    def _loss_sharded(self, p, batch: dict, ctx) -> Tuple[torch.Tensor, dict]:
        """This rank's share of the loss, with autograd: the shares of every
        rank sum to the loss, so differentiating each rank's share and
        summing each gradient over the mesh axes its parameter's spec does
        not shard gives the gradient of the loss (``parallel.steps``). The
        metrics are the global values. This rank takes its rows of the batch
        and its block of the sequence; the head runs over a vocabulary split
        over the model axis where its spec splits it (the log-sum-exp and
        the target's logit reduced over the group) and over the rank's own
        positions otherwise. With ``loss_chunk`` the CE runs in chunks of
        positions, recomputed in the backward, and the positions past the
        last whole chunk are left out, as in the single-device loss."""
        from .blocks import check_parallel_supported

        cfg = self.cfg
        check_parallel_supported(cfg)
        tokens = self._as_index(batch["tokens"])
        B, S = tokens.shape
        ctx = ctx.at(B, S)
        tokens = ctx.local_batch(tokens)
        positions = torch.arange(S, device=self.device)
        x = self._embed_tokens(p, tokens, ctx)
        x, aux = self._layers(p, x, positions, forward=True, ctx=ctx)
        x = _norm(cfg, p["final_norm"], x, ctx)
        targets = ctx.local_batch(self._as_index(batch["targets"]))
        mask = batch.get("loss_mask")
        m = (torch.ones(targets.shape, dtype=torch.float32, device=self.device) if mask is None
             else ctx.local_batch(torch.as_tensor(mask, device=self.device)).float())
        chunked = bool(cfg.loss_chunk) and S > cfg.loss_chunk
        if chunked:  # positions past the last whole chunk are dropped
            m = m * (positions < S // cfg.loss_chunk * cfg.loss_chunk)
        w, vocab_split = self._head_weight(p, ctx)
        if vocab_split:
            x = ctx.seq_gather(x)
        elif ctx.seq_sharded:
            targets, m = ctx.chunk(targets, 1), ctx.chunk(m, 1)
        copies = ctx.copies(x.shape[1] != S)
        n = torch.clamp(ctx.world_sum(m.sum().detach()) / copies, min=1.0)

        def one(xx, tt, mm):
            lf = self._logits(xx, w).float()
            if not vocab_split:
                lse = torch.logsumexp(lf, dim=-1)
                ll = torch.gather(lf, -1, tt[..., None].long())[..., 0]
                return ((lse - ll) * mm).sum()
            Vl = lf.shape[-1]
            mx = ctx.model_max(lf.amax(dim=-1))
            lse = torch.log(ctx.model_sum(torch.exp(lf - mx[..., None]).sum(dim=-1))) + mx
            t = tt.long() - ctx.model_rank * Vl
            mine = (t >= 0) & (t < Vl)
            ll = torch.gather(lf, -1, t.clamp(0, Vl - 1)[..., None])[..., 0] * mine
            return ((lse - ctx.model_sum(ll)) * mm).sum()

        step = cfg.loss_chunk if chunked else x.shape[1]
        parts = []
        for c in range(0, x.shape[1], step):
            sl = slice(c, c + step)
            args = (x[:, sl], targets[:, sl], m[:, sl])
            parts.append(checkpoint(one, *args, use_reentrant=False)
                         if chunked and torch.is_grad_enabled() else one(*args))
        ce_share = torch.stack(parts).sum() / n / copies
        share = ce_share + aux / ctx.world
        ce = ctx.world_sum(ce_share.detach())
        return share, {"ce": ce, "aux": aux.detach(), "tokens": n}

    # -- serving ------------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, p, batch: dict, ctx=None, *, last_pos=None) -> Tuple[torch.Tensor, dict]:
        """Fill the KV cache for a prompt; logits for the next-token position.

        ``last_pos`` (optional) selects which position's logits to return;
        default is the final one. The engine uses it for right-padded prompt
        buckets: pad tokens fill cache slots beyond ``last_pos`` but are
        causally invisible to it, and decode masks them via the valid length
        before they are ever attended. It is an int, or a one-element index
        tensor on the model's device, read on the device (``index_select``):
        a CUDA graph of one bucket's prefill then serves every prompt length
        in the bucket. Both forms give the same logits. A VLM's prompt is
        its patches then its tokens, an encoder-decoder's caches carry each
        decoder layer's ``cross`` keys and values over the encoded frames.

        Under a mesh (``ctx``) ``batch`` is the global batch and ``p`` this
        rank's shards; the logits are this rank's rows, and its block of the
        vocabulary where the head's spec splits it, and the caches its shards
        in ``parallel.steps.cache_specs``'s layout.
        """
        if ctx is not None:
            return self._prefill_sharded(p, batch, ctx, last_pos)
        enc_out = self._encode(p, batch["frames"]) if self.cfg.is_encdec else None
        x, prefix_len = self._input_states(p, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        x, caches = self._layers(p, x, positions, prefix_len=prefix_len, enc_out=enc_out)
        x = _norm(self.cfg, p["final_norm"], x)
        if isinstance(last_pos, torch.Tensor):
            last = x.index_select(1, last_pos.reshape(1))
        else:
            t = S - 1 if last_pos is None else int(last_pos)
            last = x[:, t : t + 1]
        return self._head(p, last), caches

    def _prefill_sharded(self, p, batch: dict, ctx, last_pos):
        from .blocks import check_parallel_supported

        check_parallel_supported(self.cfg)
        tokens = self._as_index(batch["tokens"])
        B, S = tokens.shape
        ctx = ctx.at(B, S)
        positions = torch.arange(S, device=self.device)
        x = self._embed_tokens(p, ctx.local_batch(tokens), ctx)
        x, caches = self._layers(p, x, positions, ctx=ctx)
        x = ctx.seq_gather(_norm(self.cfg, p["final_norm"], x, ctx))
        if isinstance(last_pos, torch.Tensor):
            last = x.index_select(1, last_pos.reshape(1))
        else:
            t = S - 1 if last_pos is None else int(last_pos)
            last = x[:, t : t + 1]
        return self._logits(last, self._head_weight(p, ctx)[0]), caches

    @torch.inference_mode()
    def decode_step(self, p, tokens, caches: dict, index, ctx=None) -> Tuple[torch.Tensor, dict]:
        """One new token per lane. tokens: (B, 1); index: (B,) — each lane's
        position, which is also its cache write offset and valid length
        minus one. ``caches`` is updated in place and returned. Without
        RoPE, each lane adds the sinusoidal embedding of its own position.
        Under a mesh (``ctx``) ``tokens`` and ``index`` are global, ``p``
        and ``caches`` this rank's shards, and the logits as ``prefill``'s."""
        tokens = self._as_index(tokens)
        index = self._as_index(index).reshape(-1)
        if ctx is not None:
            from .blocks import check_parallel_supported

            check_parallel_supported(self.cfg)
            ctx = ctx.at(tokens.shape[0], 1)
            tokens, index = ctx.local_batch(tokens), ctx.local_batch(index)
            x = self._embed_tokens(p, tokens, ctx)
            x, _ = self._layers(p, x, index[:, None], caches=caches, cache_index=index, ctx=ctx)
            x = _norm(self.cfg, p["final_norm"], x, ctx)
            return self._logits(x, self._head_weight(p, ctx)[0]), caches
        x = self._embed_tokens(p, tokens)
        if not self.cfg.use_rope:
            x = x + sinusoidal_emb(index, self.cfg.d_model).to(self.dtype)[:, None, :]
        x, _ = self._layers(p, x, index[:, None], caches=caches, cache_index=index)
        x = _norm(self.cfg, p["final_norm"], x)
        return self._head(p, x), caches

    def cache_shapes(self, batch: int, seq: int) -> dict:
        """Meta tensors with the shape and dtype of every cache leaf."""
        out = {}
        enc_seq = self.cfg.encoder_seq if self.cfg.is_encdec else None
        for grp in self.plan:
            one = block_cache_shape(self.cfg, batch, seq, self.dtype, is_global=grp.is_global,
                                    xdec_enc_seq=enc_seq)
            if grp.kind == "scan":
                one = tree_map(
                    lambda m, n=grp.count: torch.empty((n, *m.shape), dtype=m.dtype, device="meta"),
                    one,
                )
            out[grp.name] = one
        return out


    def input_specs(self, shape_name: str, spec: dict) -> dict:
        """Meta-tensor stand-ins for every model input of a shape cell
        (``spec``: ``seq_len``, ``global_batch`` and ``kind``, one of train,
        prefill and decode), as the reference's ``input_specs``; decode's
        ``index`` is per lane, ``(B,)``, as :meth:`decode_step` takes it."""
        cfg = self.cfg
        S, B, kind = spec["seq_len"], spec["global_batch"], spec["kind"]

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        out: dict = {}
        S_text = S - (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        if kind in ("train", "prefill"):
            out["tokens"] = meta((B, S_text))
            if kind == "train":
                out["targets"] = meta((B, S_text))
            if cfg.family == "vlm":
                out["patches"] = meta((B, cfg.num_image_tokens, cfg.vision_dim), self.dtype)
            if cfg.is_encdec:
                out["frames"] = meta((B, cfg.encoder_seq, cfg.d_model), self.dtype)
        elif kind == "decode":
            out["tokens"] = meta((B, 1))
            out["caches"] = self.cache_shapes(B, S)
            out["index"] = meta((B,))
        else:
            raise ValueError(kind)
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
