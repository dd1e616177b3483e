"""Mixture-of-Experts layer: the top-k router and the dense single-device
path, ported from the reference's ``repro/models/moe.py``.

``moe_dense`` runs every expert on every token and sums the outputs with
the router's gates, as the reference's single-device path does: exact, and
``num_experts / experts_per_token`` times the routed work (4× for
granite-moe, ≈ 27× for deepseek-v2 counting its shared experts). The
expert-parallel path (``moe_ep``, with its gather/scatter dispatch) waits
for the port of the reference's parallelism.

The expert products are plain PyTorch, as the reference leaves them to
XLA outside any kernel. They are batched matrix products over the expert
axis with the tokens broadcast to it (a stride-0 batch, no copy), so no
product copies the (E, d, ff) weights into another layout, as an
``einsum`` would that folds the expert axis into the output columns.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import act_fn


def moe_params(cfg, a) -> dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": a.param((d, E), dtype=torch.float32),
        "w_gate": a.param((E, d, ff)),
        "w_up": a.param((E, d, ff)),
        "w_down": a.param((E, ff, d)),
    }
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * ff
        p["shared"] = {
            "w_gate": a.param((d, sff)),
            "w_up": a.param((d, sff)),
            "w_down": a.param((sff, d)),
        }
    return p


def _act(cfg):
    return act_fn(cfg.act if cfg.act in ("silu", "gelu") else "silu")


def route(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (weights (B,S,K) f32, ids (B,S,K), aux f32)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = F.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)  # renormalize
    # Switch-style load-balancing auxiliary loss
    E = cfg.num_experts
    density = _one_hot(ids, E, torch.float32).mean(dim=(0, 1, 2))
    mean_prob = probs.mean(dim=(0, 1))
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
        sp = p["shared"]
        act = _act(cfg)
        y = y + torch.einsum(
            "bsf,fd->bsd",
            act(torch.einsum("bsd,df->bsf", x, sp["w_gate"]))
            * torch.einsum("bsd,df->bsf", x, sp["w_up"]),
            sp["w_down"],
        )
    return y, aux


def moe_apply(cfg, p, x: torch.Tensor, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if ctx is not None and getattr(ctx, "expert_parallel", False):
        raise NotImplementedError(
            "expert parallelism (the reference's moe_ep) waits for the port of the "
            "parallel modules (ROADMAP queue 1 item 5)"
        )
    return moe_dense(cfg, p, x)
