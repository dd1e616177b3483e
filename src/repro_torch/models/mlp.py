"""Feed-forward blocks: SwiGLU/GeGLU (gated) and plain GELU MLP (whisper).

Ported from the reference's ``repro/models/mlp.py``; the products stay
plain ``torch.einsum`` (the reference leaves them to XLA, outside any
kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import act_fn


def gated_mlp_params(cfg, a, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": a.param((d, ff), axes=("embed", "mlp")),
        "w_up": a.param((d, ff), axes=("embed", "mlp")),
        "w_down": a.param((ff, d), axes=("mlp", "embed")),
    }


def gated_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    act = act_fn(cfg.act if cfg.act in ("silu", "gelu") else "silu")
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", act(g) * u, p["w_down"])


def dense_mlp_params(cfg, a, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": a.param((d, ff), axes=("embed", "mlp")),
        "b1": a.param((ff,), "zeros", axes=("mlp",)),
        "w2": a.param((ff, d), axes=("mlp", "embed")),
        "b2": a.param((d,), "zeros", axes=("embed",)),
    }


def dense_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(torch.einsum("bsd,df->bsf", x, p["w1"]) + p["b1"], approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"]


def mlp_params(cfg, a, d_ff: int | None = None) -> dict:
    if cfg.act == "gelu_mlp":
        return dense_mlp_params(cfg, a, d_ff)
    return gated_mlp_params(cfg, a, d_ff)


def mlp_apply(cfg, p, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """The block's feed-forward. Under a mesh (``ctx``), a gated MLP whose
    hidden dim the spec shards runs tensor parallel: the whole sequence
    (all-gathered where the residual stream is split) through this rank's
    hidden block, the partial sums reduce-scattered back over the sequence
    (all-reduced where it is whole). Any other spec gathers the weights
    whole and runs this rank's tokens."""
    if ctx is not None:
        gated = cfg.act != "gelu_mlp"
        if gated and [ctx.model_dim(p[k]) for k in ("w_gate", "w_up", "w_down")] == [1, 1, 0]:
            return ctx.seq_reduce(gated_mlp(cfg, p, ctx.seq_gather(x)))
        p = {k: ctx.gather(w) for k, w in p.tree().items()}
    if cfg.act == "gelu_mlp":
        return dense_mlp(cfg, p, x)
    return gated_mlp(cfg, p, x)
