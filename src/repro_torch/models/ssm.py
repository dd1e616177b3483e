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

Under a mesh the heads are split over the model axis (:func:`_ssm_sharded`).
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
    ctx=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (cache=None) or recurrent decode (cache given, S == 1).

    Prefill returns ``{"conv", "state"}`` when ``return_cache``; decode
    writes the new window and state into ``cache`` and returns None. Under a
    mesh (``ctx``) ``u`` is this rank's block of the residual stream and so
    is the result: :func:`_ssm_sharded`."""
    if ctx is not None:
        return _ssm_sharded(cfg, p, u, cache=cache, return_cache=return_cache, ctx=ctx)
    yd, new_cache = _ssm_run(cfg, _Weights(p, ssm_dims(cfg), None, None), u, cache=cache,
                             return_cache=return_cache)
    return torch.einsum("bse,ed->bsd", yd, p["out_proj"]), new_cache


class _Weights:
    """The weights one rank's heads read: ``heads`` = (first, count), or
    None for every head. ``in_proj``'s columns are the fused ``[z | x | B |
    C | dt]``, the conv's channels ``[x | B | C]``: a block of heads takes
    its slice of z, x and dt and all of B and C. Under a mesh (``ctx``) the
    weights are gathered whole first, and the per-head vectors taken as this
    rank's block where their spec already splits them."""

    def __init__(self, p, dims: dict, heads, ctx) -> None:
        di, nh, Pd, N = dims["d_inner"], dims["nheads"], dims["headdim"], dims["dstate"]
        whole = (lambda w: w) if ctx is None else ctx.gather  # noqa: E731
        in_proj, conv_w, conv_b = whole(p["in_proj"]), whole(p["conv_w"]), whole(p["conv_b"])
        if heads is None:
            self.in_proj, self.conv_w, self.conv_b = in_proj, conv_w, conv_b
            self.a_log, self.d_skip, self.dt_bias, self.norm = (
                whole(p[k]) for k in ("a_log", "d_skip", "dt_bias", "norm"))
            self.nh, self.di = nh, di
            return
        h0, hl = heads
        c0, cl = h0 * Pd, hl * Pd  # the heads' channels of d_inner

        def cols(w, dim, x_at):
            """z (before x) where ``x_at`` is di, then x, B and C, then dt."""
            parts = [w.narrow(dim, x_at - di + c0, cl)] if x_at else []
            parts += [w.narrow(dim, x_at + c0, cl), w.narrow(dim, x_at + di, 2 * N)]
            if x_at:
                parts.append(w.narrow(dim, x_at + di + 2 * N + h0, hl))
            return torch.cat(parts, dim=dim)

        self.in_proj = cols(in_proj, 1, di)
        self.conv_w, self.conv_b = cols(conv_w, 1, 0), cols(conv_b, 0, 0)
        self.a_log, self.d_skip, self.dt_bias, self.norm = (
            ctx.take(p[k], 0) for k in ("a_log", "d_skip", "dt_bias", "norm"))
        self.nh, self.di = hl, cl


def _ssm_run(cfg, W: _Weights, u, *, cache, return_cache, norm_sum=None):
    """The block on the heads of ``W``, up to the gated norm (the caller
    applies ``out_proj``). ``norm_sum`` sums the gated norm's squares over
    the other ranks' channels (a mesh)."""
    dims = ssm_dims(cfg)
    Pd, N = dims["headdim"], dims["dstate"]
    nh, di = W.nh, W.di
    B, S, _ = u.shape

    zxbcdt = torch.einsum("bsd,de->bse", u, W.in_proj)
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, nh], dim=-1)
    dt = F.softplus(dt_raw.float() + W.dt_bias)  # (B, S, nh)
    A = -torch.exp(W.a_log)  # (nh,)

    new_cache = None
    if cache is None:
        xBC, tail = _causal_conv(xBC, W.conv_w, W.conv_b)
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
        conv_out = F.silu(torch.einsum("bkc,kc->bc", conv_in, W.conv_w) + W.conv_b)
        xc, Bc, Cc = torch.split(conv_out[:, None], [di, N, N], dim=-1)
        x = xc.reshape(B, nh, Pd)
        y1, new_state = ssd_decode_step(x, dt[:, 0], A, Bc[:, 0], Cc[:, 0], state)
        y = y1[:, None]
        window.copy_(conv_in[:, 1:])
        state.copy_(new_state)

    yd = y.reshape(B, S, di) + (
        x.reshape(B, S, di) * W.d_skip.repeat_interleave(Pd).to(y.dtype)
    )
    yd = yd * F.silu(z.float()).to(yd.dtype)  # gate
    if norm_sum is None:
        yd = rms_norm(yd, W.norm, cfg.norm_eps)
    else:  # the mean of squares over every rank's channels
        yf = yd.float()
        var = norm_sum(torch.sum(yf * yf, dim=-1, keepdim=True)) / dims["d_inner"]
        yd = (yf * torch.rsqrt(var + cfg.norm_eps) * (1.0 + W.norm.float())).to(yd.dtype)
    return yd, new_cache


def _ssm_sharded(cfg, p, u, *, cache, return_cache, ctx):
    """This rank's share of the SSD block under a mesh. Where the heads
    divide the model axis, the rank runs its own heads over the whole
    sequence (the residual stream all-gathered where it is split): its
    columns of ``in_proj``'s z, x and dt parts with B and C whole, the conv
    on those heads' channels and B and C, the scan (the SSD kernel and its
    backward on the card) on the local heads with their ``A``, ``dt_bias``
    and ``D``, the gated RMSNorm with its sum of squares summed over the
    model group, and ``out_proj`` row-parallel, its partial sums
    reduce-scattered back over the sequence (all-reduced in decode). Where
    they do not divide (or the model axis is one rank), the weights are
    gathered whole and the rank runs every head, keeping its block of the
    sequence.

    The caches keep ``cache_specs``'s layout: the conv window's channels
    split over the model axis where it divides them (a decode gathers the
    window whole and writes back its block), the state on the local heads
    (with every head, its ``N`` block where that divides, else whole)."""
    dims = ssm_dims(cfg)
    di, nh, Pd, N = dims["d_inner"], dims["nheads"], dims["headdim"], dims["dstate"]
    n, r = ctx.n_model, ctx.model_rank
    decode = cache is not None
    conv_split = dims["conv_dim"] % n == 0 and n > 1
    heads = n > 1 and nh % n == 0 and nh >= n  # at n = 1, the single-device block
    h = u if decode else ctx.seq_gather(u)
    if heads:
        hl = nh // n
        W = _Weights(p, dims, (r * hl, hl), ctx)
        norm_sum = ctx.model_sum
    else:
        W = _Weights(p, dims, None, ctx)
        norm_sum = None
    c0, cl = (r * hl * Pd, hl * Pd) if heads else (0, di)

    def full_conv(t):  # the conv channels this rank holds -> every channel
        return ctx.model_gather(t, 2) if conv_split else t

    def held_conv(t):  # every channel -> the ones this rank holds
        return ctx.chunk(t, 2) if conv_split else t

    def mine(t):  # every channel -> this rank's heads' x channels, B and C
        return torch.cat([t[..., c0 : c0 + cl], t[..., di:]], dim=-1) if heads else t

    def everyone(t):  # this rank's heads' x channels, B and C -> every channel
        return torch.cat([ctx.model_gather(t[..., :cl], 2), t[..., cl:]], dim=-1) if heads else t

    state_n_split = not heads and N % n == 0 and N >= n and n > 1
    cache_in = None
    if decode:  # the window and state this rank's heads read, written back below
        state = cache["state"]
        cache_in = {"conv": mine(full_conv(cache["conv"])),
                    "state": ctx.model_gather(state, 3) if state_n_split else state}
    yd, new_cache = _ssm_run(cfg, W, h, cache=cache_in, return_cache=return_cache,
                             norm_sum=norm_sum)
    if decode:
        if cache_in["conv"] is not cache["conv"]:
            cache["conv"].copy_(held_conv(everyone(cache_in["conv"])))
        if state_n_split:
            cache["state"].copy_(ctx.chunk(cache_in["state"], 3))
    if new_cache is not None:
        final = new_cache["state"]
        new_cache = {"conv": held_conv(everyone(new_cache["conv"])),
                     "state": ctx.chunk(final, 3) if state_n_split else final}
    out = torch.einsum("bse,ed->bsd", yd, ctx.take(p["out_proj"], 0 if heads else None))
    if heads:  # partial sums over the heads' channels
        return ctx.seq_reduce(out), new_cache
    return (out if decode else ctx.constrain_activations(out)), new_cache
