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

Under a mesh (``ctx``) the params are this rank's shards, each carrying its
spec (``mesh_spec``) and its ZeRO spec (``zero_spec``, the spec with the
data axes added on one more dim: ``parallel.sharding.zero_spec``). The
moments and the f32 masters are kept in the ZeRO layout: this rank's block
of its param shard along that dim. The update sums each gradient over the
mesh axes its param is replicated on (a reduce-scatter onto the ZeRO block
over the data axes), takes the clip's global norm over the whole sharded
tree (each element counted once), updates the ZeRO blocks and all-gathers
the new params back over the data axes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..parallel.sharding import mesh_shape
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


def _zero_dim(p: torch.Tensor) -> Optional[int]:
    """The dim a sharded param's ZeRO spec adds the data axes on, or None."""
    spec = tuple(p.mesh_spec) + (None,) * p.ndim
    for i, z in enumerate(p.zero_spec):
        if z is not None and spec[i] is None:
            return i
    return None


def _zero_block(t: torch.Tensor, p: torch.Tensor, ctx) -> torch.Tensor:
    """This rank's ZeRO block of ``t`` (shaped like the param shard ``p``):
    ``t`` itself on one device or where ``p`` has no ZeRO dim."""
    dim = None if ctx is None else _zero_dim(p)
    if dim is None or ctx.n_batch == 1:
        return t
    size = t.shape[dim] // ctx.n_batch
    return t.narrow(dim, ctx.batch_rank * size, size)


def _zero_gather(block: torch.Tensor, p: torch.Tensor, ctx) -> torch.Tensor:
    """The param shard ``p`` whole again from every rank's ZeRO ``block``
    (an all-gather over the data axes where ``p`` has a ZeRO dim)."""
    dim = None if ctx is None else _zero_dim(p)
    if dim is None or ctx.n_batch == 1:
        return block
    return ctx.batch_gather(block.to(p.dtype), dim)


def adamw_init(cfg: AdamWConfig, params: Any, *, ctx=None) -> dict:
    """Zero moments and, with ``keep_master``, an f32 copy of the params,
    on the params' devices; under a mesh, this rank's ZeRO blocks."""
    mdt = _MOMENT_DTYPES[cfg.moments_dtype]
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    block = lambda p: _zero_block(p, p, ctx)  # noqa: E731
    with torch.no_grad():
        state = {
            "m": tree_map(lambda p: torch.zeros(block(p).shape, dtype=mdt, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(block(p).shape, dtype=mdt, device=p.device),
                          params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
        if cfg.keep_master:
            state["master"] = tree_map(
                lambda p: block(p).detach().to(torch.float32, copy=True), params
            )
    return state


def adamw_abstract_state(cfg: AdamWConfig, abstract_params: Any) -> dict:
    """The state's shapes and dtypes as meta tensors, for abstract params."""
    mdt = _MOMENT_DTYPES[cfg.moments_dtype]

    def meta(p, dtype):
        return torch.empty(p.shape, dtype=dtype, device="meta")

    state = {
        "m": tree_map(lambda p: meta(p, mdt), abstract_params),
        "v": tree_map(lambda p: meta(p, mdt), abstract_params),
        "count": torch.empty((), dtype=torch.int32, device="meta"),
    }
    if cfg.keep_master:
        state["master"] = tree_map(lambda p: meta(p, torch.float32), abstract_params)
    return state


def _sharded_grads(params: list, grads: list, ctx) -> Tuple[list, torch.Tensor]:
    """Each gradient summed over the mesh axes its param is replicated on,
    as this rank's ZeRO block, and the global norm of the whole tree."""
    shape = mesh_shape(ctx.mesh)
    out, sq = [], []
    for p, g in zip(params, grads):
        if ctx.model_dim(p) is None:
            g = ctx.model_sum(g)
        dim = _zero_dim(p)
        # a spec that puts a batch axis on a dim (deepseek-v2's expert hidden
        # dim on data) leaves no ZeRO dim: the all-gather's adjoint in the
        # layer already summed the gradient over that axis
        sharded = _spec_axes(p.mesh_spec)
        g = ctx.batch_sum_except(g, sharded) if dim is None else ctx.batch_scatter(g, dim)
        # ranks that hold each element of this block: the norm counts it once
        copies = 1 if dim is not None else math.prod(
            shape[a] for a in ctx.batch_axes if a not in sharded)
        copies *= ctx.n_model if ctx.model_dim(p) is None else 1
        out.append(g)
        sq.append(torch.sum(torch.square(g.float())) / copies if copies > 1
                  else torch.sum(torch.square(g.float())))
    total = torch.stack(sq).sum() if sq else torch.zeros(())
    return out, torch.sqrt(ctx.world_sum(total))


def _spec_axes(spec: tuple) -> set:
    """The mesh axes a spec shards some dim over."""
    out: set = set()
    for entry in spec:
        if entry is not None:
            out.update(entry if isinstance(entry, tuple) else (entry,))
    return out


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
    *,
    ctx=None,
) -> Tuple[Any, dict, dict]:
    """One AdamW step, in place. ``lr`` is a float or a 0-d tensor. Returns
    (params, state, metrics) with ``metrics = {"grad_norm", "lr"}``. Under
    a mesh (``ctx``) ``grads`` are this rank's contributions (the gradient
    of its share of the loss) and the state its ZeRO blocks."""
    b1, b2 = cfg.b1, cfg.b2
    with torch.no_grad():
        state["count"].add_(1)
        count = state["count"].float()
        if ctx is None:
            gnorm = global_norm(grads)
            g_leaves = tree_leaves(grads)
        else:
            g_leaves, gnorm = _sharded_grads(tree_leaves(params), tree_leaves(grads), ctx)
        if cfg.grad_clip:
            scale = torch.where(
                gnorm > cfg.grad_clip, cfg.grad_clip / torch.clamp(gnorm, min=1e-12), 1.0
            )
        else:
            scale = torch.ones((), device=gnorm.device)
        c1 = 1.0 - torch.pow(b1, count)
        c2 = 1.0 - torch.pow(b2, count)
        masters = state.get("master")
        flat = zip(
            tree_leaves(params), g_leaves, tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(masters) if masters is not None else [None] * len(g_leaves),
            tree_leaves(decay_mask(params)),
        )
        for p, g, m, v, mst, dk in flat:
            _update_leaf(cfg, lr, p, g, m, v, mst, dk, scale, c1, c2, ctx)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# On one device a leaf's update runs on flat pieces of at most this many
# elements: the update is elementwise, so the pieces give the whole leaf's
# result bit for bit, and its f32 temporaries stay at a few pieces' size
# (whole, those of one of deepseek-v2's 1.26e9-element expert leaves would
# take some 30 GB beside its bf16 moments)
UPDATE_PIECE = 1 << 26


def _update_leaf(cfg, lr, p, g, m, v, master, decay, scale, c1, c2, ctx) -> None:
    """One param's update, in place: on its ZeRO block under a mesh (the
    whole param on one device, in pieces of :data:`UPDATE_PIECE`), the new
    block then all-gathered over the data axes into the param shard.
    ``master`` is None without masters."""
    state = (p, m, v) if master is None else (p, m, v, master)
    if ctx is None and p.numel() > UPDATE_PIECE and all(t.is_contiguous() for t in state):
        flat = [t.view(-1) for t in state] + [None] * (4 - len(state))
        pf, mf, vf, mstf = flat
        gf = g.reshape(-1)
        for i in range(0, pf.numel(), UPDATE_PIECE):
            piece = slice(i, i + UPDATE_PIECE)
            _update_block(cfg, lr, pf[piece], gf[piece], mf[piece], vf[piece],
                          None if mstf is None else mstf[piece], decay, scale, c1, c2, None)
        return
    _update_block(cfg, lr, p, g, m, v, master, decay, scale, c1, c2, ctx)


def _update_block(cfg, lr, p, g, m, v, master, decay, scale, c1, c2, ctx) -> None:
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float() * scale
    m1 = b1 * m.float() + (1 - b1) * gf
    v1 = b2 * v.float() + (1 - b2) * gf * gf
    step = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
    base = (_zero_block(p, p, ctx) if master is None else master).float()
    if decay and cfg.weight_decay:
        step = step + cfg.weight_decay * base
    new_master = base - lr * step
    m.copy_(m1)
    v.copy_(v1)
    if master is not None:
        master.copy_(new_master)
    p.copy_(_zero_gather(new_master, p, ctx))


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
    "adamw_abstract_state",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "decay_mask",
    "global_norm",
]
