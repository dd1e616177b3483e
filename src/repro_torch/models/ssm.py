"""Mamba2 / SSD (state-space duality) block, ported from the reference's
``repro/models/ssm.py`` (arXiv:2405.21060).

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t ⊗ x_t          (per head)
  y_t = C_t · h_t + D * x_t

Layout follows the reference: one fused input projection producing
[z | x | B | C | dt], a depthwise causal conv over [x|B|C], per-head scalar
A (log-parameterised) and D, gated RMSNorm, output projection; n_groups=1.

Prefill runs the chunked scan through ``kernels.ssd.ssd_bshp`` — the
hand-written kernel on a CUDA tensor — and always takes the final state,
which the reference's prefill computes with its oracle. Decode is the
plain recurrent step, as in the reference, and writes the conv window and
the state into the cache tensors in place (the reference returns updated
copies of donated buffers).

Under autograd the full-sequence scan goes through the autograd Function
``kernels.ssd.SSD``: on the card its backward is the hand-written backward
kernel, on the CPU the plain ``ssd_bwd_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_bshp, ssd_decode_step
from .common import rms_norm


def ssm_dims(cfg) -> dict:
    if cfg.family == "hybrid":
        d_inner = cfg.num_heads * cfg.head_dim  # match attention width
    else:
        d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
    return dict(
        d_inner=d_inner,
        nheads=nheads,
        headdim=d_inner // nheads,
        dstate=cfg.ssm_state,
        conv_dim=d_inner + 2 * cfg.ssm_state,
    )


def ssm_params(cfg, a) -> dict:
    dims = ssm_dims(cfg)
    d, di, nh, N = cfg.d_model, dims["d_inner"], dims["nheads"], dims["dstate"]
    conv_dim = dims["conv_dim"]
    f32 = torch.float32
    return {
        "in_proj": a.param((d, 2 * di + 2 * N + nh), axes=("embed", "ssm_inner")),  # [z | x | B | C | dt]
        "conv_w": a.param((cfg.conv_kernel, conv_dim), axes=(None, "ssm_inner")),
        "conv_b": a.param((conv_dim,), "zeros", axes=("ssm_inner",)),
        "a_log": a.param((nh,), "ssm_a", dtype=f32, axes=("ssm_heads",)),
        "d_skip": a.param((nh,), "ones", dtype=f32, axes=("ssm_heads",)),
        "dt_bias": a.param((nh,), "ssm_dt", dtype=f32, axes=("ssm_heads",)),
        "norm": a.param((di,), "zeros", axes=("ssm_inner",)),
        "out_proj": a.param((di, d), axes=("ssm_inner", "embed")),
    }


def ssm_cache_shape(cfg, batch: int, dtype) -> dict:
    """Meta tensors: the conv window in the model dtype, the state in f32."""
    dims = ssm_dims(cfg)
    meta = torch.device("meta")
    return {
        "conv": torch.empty((batch, cfg.conv_kernel - 1, dims["conv_dim"]), dtype=dtype, device=meta),
        "state": torch.empty(
            (batch, dims["nheads"], dims["headdim"], dims["dstate"]), dtype=torch.float32, device=meta
        ),
    }


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over (B, S, C) with kernel (K, C), from a zero
    history. Returns the activation and the last K-1 inputs (the decode
    window)."""
    K = w.shape[0]
    pad = seq.new_zeros((seq.shape[0], K - 1, seq.shape[2]))
    full = torch.cat([pad, seq], dim=1)  # (B, S+K-1, C)
    out = sum(full[:, i : full.shape[1] - (K - 1 - i), :] * w[i] for i in range(K))
    return F.silu(out + b), full[:, full.shape[1] - (K - 1) :, :].clone()


def ssm_apply(
    cfg,
    p,
    u: torch.Tensor,  # (B, S, d_model)
    *,
    cache: Optional[dict] = None,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (cache=None) or recurrent decode (cache given, S == 1).

    Prefill returns ``{"conv", "state"}`` when ``return_cache``; decode
    writes the new window and state into ``cache`` and returns None."""
    dims = ssm_dims(cfg)
    di, nh, Pd, N = dims["d_inner"], dims["nheads"], dims["headdim"], dims["dstate"]
    B, S, _ = u.shape

    zxbcdt = torch.einsum("bsd,de->bse", u, p["in_proj"])
    z, xBC, dt_raw = torch.split(zxbcdt, [di, dims["conv_dim"], nh], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["a_log"])  # (nh,)

    new_cache = None
    if cache is None:
        xBC, tail = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xc, Bc, Cc = torch.split(xBC, [di, N, N], dim=-1)
        x = xc.reshape(B, S, nh, Pd)
        y, final = ssd_bshp(
            x, dt, A, Bc, Cc, chunk=min(cfg.ssm_chunk, S), return_final_state=True
        )
        if return_cache:
            new_cache = {"conv": tail, "state": final}
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per lane, got S={S}")
        window, state = cache["conv"], cache["state"]
        conv_in = torch.cat([window, xBC], dim=1)  # (B, K, conv)
        conv_out = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]) + p["conv_b"])
        xc, Bc, Cc = torch.split(conv_out[:, None], [di, N, N], dim=-1)
        x = xc.reshape(B, nh, Pd)
        y1, new_state = ssd_decode_step(x, dt[:, 0], A, Bc[:, 0], Cc[:, 0], state)
        y = y1[:, None]
        window.copy_(conv_in[:, 1:])
        state.copy_(new_state)

    yd = y.reshape(B, S, di) + (
        x.reshape(B, S, di) * p["d_skip"].repeat_interleave(Pd).to(y.dtype)
    )
    yd = yd * F.silu(z.float()).to(yd.dtype)  # gate
    yd = rms_norm(yd, p["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", yd, p["out_proj"])
    return out, new_cache
