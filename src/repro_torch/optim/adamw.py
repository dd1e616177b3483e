"""AdamW from scratch, ported from the reference's ``repro/optim/adamw.py``.

State layout (a tree mirroring the params, nested dicts with a list per
layer group):
  m, v        first/second moments, dtype = moments_dtype
  master      f32 master copy of the params (kept with ``keep_master``;
              updates apply to the master, the params are re-cast from it)
  count       step counter, an int32 0-d tensor on the params' device

The update runs on the device under ``torch.no_grad`` with no host sync
(no ``.item()``): the clip scale and the bias corrections stay 0-d device
tensors. Where the reference returns new trees, :func:`adamw_update`
writes the new values into the params and the state tensors in place and
returns them.

Weight decay is masked off 1-D params (norms, biases), counting dims as the
reference sees them: its layer groups are stacked along a leading layer
axis, so a leaf inside a layer group's list counts one dim more
(:func:`decay_mask`; ROADMAP F7).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..tree import tree_leaves, tree_map

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"  # "bfloat16" for very large models
    keep_master: bool = True  # f32 master copy of the params


def decay_mask(params: Any) -> Any:
    """True where weight decay applies: every leaf with ndim >= 2, a leaf
    inside a layer group's list counting the reference's stacking dim."""

    def mark(node, stacked):
        if isinstance(node, dict):
            return {k: mark(v, stacked) for k, v in node.items()}
        if isinstance(node, list):
            return [mark(v, 1) for v in node]
        return node.ndim + stacked >= 2

    return mark(params, 0)


def adamw_init(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments and, with ``keep_master``, an f32 copy of the params,
    on the params' devices."""
    mdt = _MOMENT_DTYPES[cfg.moments_dtype]
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    with torch.no_grad():
        state = {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
        if cfg.keep_master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params
            )
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    leaves = tree_leaves(tree)
    with torch.no_grad():
        sq = [torch.sum(torch.square(x.float())) for x in leaves]
        return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


def adamw_update(
    cfg: AdamWConfig,
    lr,
    params: Any,
    grads: Any,
    state: dict,
) -> Tuple[Any, dict, dict]:
    """One AdamW step, in place. ``lr`` is a float or a 0-d tensor. Returns
    (params, state, metrics) with ``metrics = {"grad_norm", "lr"}``."""
    b1, b2 = cfg.b1, cfg.b2
    with torch.no_grad():
        state["count"].add_(1)
        count = state["count"].float()
        gnorm = global_norm(grads)
        if cfg.grad_clip:
            scale = torch.where(
                gnorm > cfg.grad_clip, cfg.grad_clip / torch.clamp(gnorm, min=1e-12), 1.0
            )
        else:
            scale = torch.ones((), device=gnorm.device)
        c1 = 1.0 - torch.pow(b1, count)
        c2 = 1.0 - torch.pow(b2, count)
        masters = state.get("master", params)
        flat = zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(masters), tree_leaves(decay_mask(params)),
        )
        for p, g, m, v, mst, dk in flat:
            gf = g.float() * scale
            m1 = b1 * m.float() + (1 - b1) * gf
            v1 = b2 * v.float() + (1 - b2) * gf * gf
            step = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
            base = mst.float()
            if dk and cfg.weight_decay:
                step = step + cfg.weight_decay * base
            new_master = base - lr * step
            m.copy_(m1)
            v.copy_(v1)
            if mst is not p:
                mst.copy_(new_master)
            p.copy_(new_master)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(
    base_lr: float, warmup: int, total: int, min_frac: float = 0.1
) -> Callable[[Any], torch.Tensor]:
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac`` of it
    at ``total``; the step's lr as an f32 0-d CPU tensor (the reference
    computes it in f32)."""

    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)

    return lr


__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "decay_mask",
    "global_norm",
]
