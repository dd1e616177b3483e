"""Decoder blocks, ported from the reference's ``repro/models/blocks.py``.

Families carried so far:
  dense           pre-norm attention + gated MLP
  moe             pre-norm attention (GQA or MLA) + the routed MoE layer
                  (a dense MLP for deepseek-v2's ``first_dense_layers``)
  ssm             pre-norm Mamba2 SSD block (no separate MLP)
  hybrid (hymba)  parallel attention + SSD heads on separately normed
                  inputs, ``x + 0.5 * (attn + ssm)``, then the MLP
The other families (enc-dec, VLM) come with later slices; their blocks
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (
    gqa_attention,
    gqa_cache_shape,
    gqa_params,
    mla_attention,
    mla_cache_shape,
    mla_params,
)
from .common import rms_norm
from .mlp import mlp_apply, mlp_params
from .moe import moe_apply, moe_params
from .ssm import ssm_apply, ssm_cache_shape, ssm_params


def check_supported(cfg) -> None:
    """Raise for a config whose blocks this slice does not carry."""
    rope_gqa = cfg.attention == "gqa" and cfg.use_rope
    ok = cfg.norm == "rms" and not cfg.is_encdec and (
        (cfg.family in ("dense", "hybrid") and rope_gqa and not cfg.is_moe)
        or (cfg.family == "moe" and cfg.is_moe and (rope_gqa or cfg.attention == "mla"))
        or (cfg.family == "ssm" and cfg.attention == "none" and not cfg.is_moe)
    )
    if not ok:
        raise NotImplementedError(
            "the port carries the dense and hybrid GQA RMSNorm RoPE decoders, the MoE "
            "decoders with GQA or MLA attention and the attention-free SSM decoder; "
            f"{cfg.name} (family={cfg.family!r}, "
            f"attention={cfg.attention!r}, norm={cfg.norm!r}) waits for a later slice"
        )


def _norm_params(cfg, a) -> dict:
    return {"w": a.param((cfg.d_model,), "zeros")}


def _norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, p["w"], cfg.norm_eps)


def block_params(cfg, a, *, moe_layer: bool = True) -> dict:
    """One layer's parameters; an MoE config's layer carries the MoE layer
    unless ``moe_layer`` is False (deepseek-v2's leading dense layers)."""
    check_supported(cfg)
    p: dict = {}
    if cfg.attention == "mla":
        p["attn"] = mla_params(cfg, a)
    elif cfg.attention == "gqa":
        p["attn"] = gqa_params(cfg, a)
    if cfg.attention != "none":
        p["attn_norm"] = _norm_params(cfg, a)
    if cfg.family in ("ssm", "hybrid"):
        p["ssm"] = ssm_params(cfg, a)
        p["ssm_norm"] = _norm_params(cfg, a)
    if cfg.d_ff > 0 or (cfg.is_moe and moe_layer):
        p["mlp_norm"] = _norm_params(cfg, a)
        if cfg.is_moe and moe_layer:
            p["moe"] = moe_params(cfg, a)
        else:
            p["mlp"] = mlp_params(cfg, a)
    return p


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
) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Returns (x_out, new_cache, moe_aux_loss); the aux loss is an f32
    scalar, and None for a layer without the MoE layer (where the reference
    returns a zero: a layer of the other families launches nothing for
    it). Decode writes the cache in place."""
    new_cache: dict = {}
    s_out = None
    if cfg.family in ("ssm", "hybrid"):
        s_out, s_cache = ssm_apply(
            cfg, p["ssm"], _norm(cfg, p["ssm_norm"], x),
            cache=cache.get("ssm") if cache else None, return_cache=return_cache,
        )
        if s_cache is not None:
            new_cache["ssm"] = s_cache
    if "attn" in p:
        attn_fn = mla_attention if cfg.attention == "mla" else gqa_attention
        a_out, a_cache = attn_fn(
            cfg,
            p["attn"],
            _norm(cfg, p["attn_norm"], x),
            positions,
            window=window,
            prefix_len=prefix_len,
            bidirectional=bidirectional,
            cache=cache.get("attn") if cache else None,
            cache_index=cache_index,
            return_cache=return_cache,
        )
        if a_cache is not None:
            new_cache["attn"] = a_cache
        # hybrid: parallel attention + SSD heads (hymba)
        x = x + (a_out if s_out is None else 0.5 * (a_out + s_out))
    else:
        x = x + s_out
    aux = None
    if "moe" in p:
        m_out, aux = moe_apply(cfg, p["moe"], _norm(cfg, p["mlp_norm"], x))
        x = x + m_out
    elif "mlp" in p:
        x = x + mlp_apply(cfg, p["mlp"], _norm(cfg, p["mlp_norm"], x))
    return x, (new_cache or None), aux


def block_cache_shape(cfg, batch: int, seq: int, dtype, *, is_global: bool = True) -> dict:
    """Cache shapes for ONE layer (meta tensors). seq = the KV length kept."""
    c: dict = {}
    if cfg.attention == "mla":
        c["attn"] = mla_cache_shape(cfg, batch, seq, dtype)
    elif cfg.attention == "gqa":
        ring = (not is_global) and cfg.window is not None and cfg.window < seq
        kv_len = min(seq, cfg.window) if ring else seq
        c["attn"] = gqa_cache_shape(cfg, batch, kv_len, dtype, ring=ring)
    if cfg.family in ("ssm", "hybrid"):
        c["ssm"] = ssm_cache_shape(cfg, batch, dtype)
    return c
