"""Decoder blocks, ported from the reference's ``repro/models/blocks.py``.

This slice carries the dense-decoder path: pre-norm attention, then a
pre-norm MLP. The other families (MoE, SSM, hybrid, enc-dec, VLM) come with
later slices; their blocks raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import gqa_attention, gqa_cache_shape, gqa_params
from .common import rms_norm
from .mlp import mlp_apply, mlp_params


def check_supported(cfg) -> None:
    """Raise for a config whose blocks this slice does not carry."""
    if cfg.family != "dense" or cfg.attention != "gqa" or cfg.norm != "rms" or not cfg.use_rope:
        raise NotImplementedError(
            f"the port carries the dense GQA RMSNorm RoPE decoder only; {cfg.name} "
            f"(family={cfg.family!r}, attention={cfg.attention!r}, norm={cfg.norm!r}) "
            "waits for a later slice"
        )


def _norm_params(cfg, a) -> dict:
    return {"w": a.param((cfg.d_model,), "zeros")}


def _norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["w"], cfg.norm_eps)


def block_params(cfg, a) -> dict:
    check_supported(cfg)
    return {
        "attn": gqa_params(cfg, a),
        "attn_norm": _norm_params(cfg, a),
        "mlp_norm": _norm_params(cfg, a),
        "mlp": mlp_params(cfg, a),
    }


def block_apply(
    cfg,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    bidirectional: bool = False,
    prefix_len: Optional[int] = None,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,
    return_cache: bool = False,
    window: Optional[int] = None,  # None = full attention (global layers)
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x_out, new_cache). Decode writes the cache in place."""
    h = _norm(cfg, p["attn_norm"], x)
    a_out, a_cache = gqa_attention(
        cfg,
        p["attn"],
        h,
        positions,
        window=window,
        prefix_len=prefix_len,
        bidirectional=bidirectional,
        cache=cache.get("attn") if cache else None,
        cache_index=cache_index,
        return_cache=return_cache,
    )
    x = x + a_out
    h = _norm(cfg, p["mlp_norm"], x)
    x = x + mlp_apply(cfg, p["mlp"], h)
    return x, ({"attn": a_cache} if a_cache is not None else None)


def block_cache_shape(cfg, batch: int, seq: int, dtype, *, is_global: bool = True) -> dict:
    """Cache shapes for ONE layer (meta tensors). seq = the KV length kept."""
    ring = (not is_global) and cfg.window is not None and cfg.window < seq
    kv_len = min(seq, cfg.window) if ring else seq
    return {"attn": gqa_cache_shape(cfg, batch, kv_len, dtype, ring=ring)}
