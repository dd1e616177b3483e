"""Mixture-of-Experts layer: the top-k router and the dense single-device
path, ported from the reference's ``repro/models/moe.py``.

``moe_dense`` runs every expert on every token and sums the outputs with
the router's gates, as the reference's single-device path does: exact, and
``num_experts / experts_per_token`` times the routed work (4× for
granite-moe, ≈ 27× for deepseek-v2 counting its shared experts).

``moe_ep`` is expert parallelism under a mesh: each rank routes its own
tokens, fills per-expert capacity buffers by scatter (``_dispatch_local``,
no dispatch-einsum FLOPs), sends them expert-major over the model group
with an all-to-all, runs its local experts and sends the outputs back
(``_combine_local``). Capacity overflow drops (GShard semantics), so it
equals ``moe_dense`` only at a ``capacity_factor`` where nothing drops. In
decode the tokens are whole on every model rank: each runs its local
experts and the outputs are summed over the group.

The expert products are plain PyTorch, as the reference leaves them to
XLA outside any kernel. They are batched matrix products over the expert
axis with the tokens broadcast to it (a stride-0 batch, no copy), so no
product copies the (E, d, ff) weights into another layout, as an
``einsum`` would that folds the expert axis into the output columns.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .common import act_fn


def moe_params(cfg, a) -> dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": a.param((d, E), dtype=torch.float32, axes=("embed", "experts")),
        "w_gate": a.param((E, d, ff), axes=("experts", "embed", "expert_mlp")),
        "w_up": a.param((E, d, ff), axes=("experts", "embed", "expert_mlp")),
        "w_down": a.param((E, ff, d), axes=("experts", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * ff
        p["shared"] = {
            "w_gate": a.param((d, sff), axes=("embed", "mlp")),
            "w_up": a.param((d, sff), axes=("embed", "mlp")),
            "w_down": a.param((sff, d), axes=("mlp", "embed")),
        }
    return p


def _act(cfg):
    return act_fn(cfg.act if cfg.act in ("silu", "gelu") else "silu")


def route(cfg, p, x: torch.Tensor, ctx=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (weights (B,S,K) f32, ids (B,S,K), aux f32).
    Under a mesh ``x`` is this rank's tokens and the aux loss's two means
    are taken over every rank's (each token counted as often as it is
    held, which the means cancel)."""
    router = p["router"] if ctx is None else ctx.gather(p["router"])
    logits = torch.einsum("bsd,de->bse", x.float(), router)
    probs = F.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)  # renormalize
    # Switch-style load-balancing auxiliary loss
    E = cfg.num_experts
    if ctx is None:
        density = _one_hot(ids, E, torch.float32).mean(dim=(0, 1, 2))
        mean_prob = probs.mean(dim=(0, 1))
    else:
        tokens = ctx.world_sum(torch.full((), float(ids.shape[0] * ids.shape[1]),
                                          device=x.device))
        density = ctx.world_sum(_one_hot(ids, E, torch.float32).sum(dim=(0, 1, 2)))
        density = density / (tokens * ids.shape[2])
        mean_prob = ctx.world_sum(probs.sum(dim=(0, 1))) / tokens
    aux = cfg.router_aux_loss * E * torch.sum(density * mean_prob)
    return weights, ids, aux


def _one_hot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(ids, n)``, by comparison: no host sync, so it
    captures into a CUDA graph."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _expert_ffn(cfg, w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU: xs (E, C, d) with per-expert weights (E, d, ff)."""
    h = _act(cfg)(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)  # (E, C, ff)
    return torch.bmm(h, w_down)


def moe_dense(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, d = x.shape
    weights, ids, aux = route(cfg, p, x)
    E = cfg.num_experts
    # every token to every expert: (E, B*S, d) as a stride-0 view, no copy
    xs = x.reshape(B * S, d).expand(E, B * S, d)
    y_all = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], xs)  # (E, B*S, d)
    onehot = _one_hot(ids, E, x.dtype)  # (B,S,K,E)
    combine = torch.einsum("bske,bsk->ebs", onehot, weights.to(x.dtype))
    y = torch.einsum("et,etd->td", combine.reshape(-1, B * S), y_all).reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + _shared_experts(cfg, p["shared"], x)
    return y, aux


def _shared_experts(cfg, sp, x: torch.Tensor) -> torch.Tensor:
    act = _act(cfg)
    return torch.einsum(
        "bsf,fd->bsd",
        act(torch.einsum("bsd,df->bsf", x, sp["w_gate"])) * torch.einsum("bsd,df->bsf", x, sp["w_up"]),
        sp["w_down"],
    )


def _dispatch_local(cfg, x2d: torch.Tensor, ids: torch.Tensor, capacity: int):
    """Per-shard gather/scatter dispatch. x2d: (T, d); ids: (T, K). Returns
    (buffer (E, C, d), slot (T*K,), keep (T, K)): each token's k-th copy
    lands at its expert's next free row, or, past ``capacity``, in a scratch
    row that is dropped."""
    T, d = x2d.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    flat_ids = ids.reshape(-1)  # (T*K,) expert of each copy
    onehot = _one_hot(flat_ids, E, torch.int32)  # (T*K, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)  # position within expert
    keep = pos < capacity
    slot = torch.where(keep, flat_ids * capacity + pos, E * capacity)  # overflow -> scratch row
    token_of_copy = torch.arange(T, device=x2d.device).repeat_interleave(K)
    buf = x2d.new_zeros((E * capacity + 1, d)).index_add(0, slot, x2d[token_of_copy])
    return buf[:-1].reshape(E, capacity, d), slot, keep.reshape(T, K)


def _combine_local(y_buf: torch.Tensor, weights: torch.Tensor, slot: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """Inverse of dispatch: gather each copy's expert output, gate, sum.
    y_buf: (E, C, d); weights/keep: (T, K); slot: (T*K,) into E*C (+scratch)."""
    E, C, d = y_buf.shape
    T, K = keep.shape
    flat = torch.cat([y_buf.reshape(E * C, d), y_buf.new_zeros((1, d))])
    y_copies = flat[slot].reshape(T, K, d)
    w = (weights * keep).to(y_buf.dtype)
    return torch.einsum("tkd,tk->td", y_copies, w)


def capacity_for(cfg, tokens_per_shard: int) -> int:
    c = math.ceil(tokens_per_shard * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for layout friendliness


def moe_ep(cfg, p, x: torch.Tensor, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank's tokens ``x`` (B_l, S_l, d): its
    block of the sequence in train and prefill, the whole (one-token)
    sequence in decode. The expert weights are this rank's experts."""
    B, S, d = x.shape
    E, K, n = cfg.num_experts, cfg.experts_per_token, ctx.n_model
    if E % n:
        raise ValueError(f"{E} experts do not divide over model={n}")
    weights, ids, aux = route(cfg, p, x, ctx)
    T = B * S
    if ctx.seq_sharded:
        C = capacity_for(cfg, T)
    else:
        # decode: capacity must cover the worst case (all local tokens on one
        # expert): dropping a decode token corrupts its stream
        C = max(8, -(-T // 8) * 8)
    w_gate, w_up, w_down = (ctx.take(p[k], 0) for k in ("w_gate", "w_up", "w_down"))
    buf, slot, keep = _dispatch_local(cfg, x.reshape(T, d), ids.reshape(T, K), C)
    if ctx.seq_sharded:
        # expert-major exchange: (E, C, d) -> (E/n, n*C, d) per model rank
        buf = ctx.model_all_to_all(buf, 0, 1)
        y_buf = _expert_ffn(cfg, w_gate, w_up, w_down, buf)
        y_buf = ctx.model_all_to_all(y_buf, 1, 0)
    else:
        # decode: each rank runs its local experts, the outputs are summed
        e_loc = E // n
        lo = ctx.model_rank * e_loc
        y_l = _expert_ffn(cfg, w_gate, w_up, w_down, buf[lo : lo + e_loc])
        y_buf = ctx.model_sum(torch.cat([y_l.new_zeros((lo, C, d)), y_l,
                                         y_l.new_zeros((E - lo - e_loc, C, d))]))
    y = _combine_local(y_buf, weights.reshape(T, K), slot, keep).reshape(B, S, d)
    if cfg.num_shared_experts:
        sp = p["shared"]
        y = y + _shared_experts(cfg, {k: ctx.gather(sp[k]) for k in ("w_gate", "w_up", "w_down")},
                                x)
    return y, aux


def moe_apply(cfg, p, x: torch.Tensor, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if ctx is not None and ctx.expert_parallel:
        return moe_ep(cfg, p, x, ctx)
    if ctx is not None:
        raise NotImplementedError("under a mesh the MoE layer runs expert parallel")
    return moe_dense(cfg, p, x)
