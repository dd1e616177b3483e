"""Decoder blocks, ported from the reference's ``repro/models/blocks.py``.

Families carried so far:
  dense           pre-norm attention + gated MLP
  moe             pre-norm attention (GQA or MLA) + the routed MoE layer
                  (a dense MLP for deepseek-v2's ``first_dense_layers``)
  ssm             pre-norm Mamba2 SSD block (no separate MLP)
  hybrid (hymba)  parallel attention + SSD heads on separately normed
                  inputs, ``x + 0.5 * (attn + ssm)``, then the MLP
  vlm             the dense block (paligemma's gemma backbone), whose
                  prefill attends under a prefix-LM mask
  encdec          whisper-style LayerNorm blocks without RoPE: the encoder
                  block attends bidirectionally, the decoder block
                  (``xdecoder``) adds cross-attention over the encoder's
                  output, whose keys and values are the static ``cross``
                  cache in decode
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (
    PrefillMask,
    attend,
    gqa_attention,
    gqa_cache_shape,
    gqa_params,
    mla_attention,
    mla_cache_shape,
    mla_params,
)
from .common import layer_norm, rms_norm
from .mlp import mlp_apply, mlp_params
from .moe import moe_apply, moe_params
from .ssm import ssm_apply, ssm_cache_shape, ssm_params


def check_supported(cfg) -> None:
    """Raise for a config whose blocks the port does not carry."""
    rope_gqa = cfg.attention == "gqa" and cfg.use_rope
    decoder = cfg.norm == "rms" and not cfg.is_encdec and (
        (cfg.family in ("dense", "hybrid", "vlm") and rope_gqa and not cfg.is_moe)
        or (cfg.family == "moe" and cfg.is_moe and (rope_gqa or cfg.attention == "mla"))
        or (cfg.family == "ssm" and cfg.attention == "none" and not cfg.is_moe)
    )
    encdec = (cfg.family == "encdec" and cfg.is_encdec and cfg.norm == "ln"
              and cfg.attention == "gqa" and not cfg.use_rope and not cfg.is_moe)
    if not (decoder or encdec):
        raise NotImplementedError(
            "the port carries the dense, hybrid and VLM GQA RMSNorm RoPE decoders, the MoE "
            "decoders with GQA or MLA attention, the attention-free SSM decoder and the "
            f"LayerNorm encoder-decoder; {cfg.name} (family={cfg.family!r}, "
            f"attention={cfg.attention!r}, norm={cfg.norm!r}) is none of them"
        )


def check_parallel_supported(cfg) -> None:
    """Raise for a config the port does not yet run under a mesh: the
    dense and GQA-MoE decoders run; MLA, SSM, hybrid, enc-dec and VLM, and
    deepseek-v2's expert hidden dim on the data axis, wait for a later
    slice."""
    rules = dict(cfg.sharding_rules or ())
    ok = (cfg.family in ("dense", "moe") and cfg.attention == "gqa" and cfg.use_rope
          and cfg.window is None and not cfg.is_encdec and rules.get("expert_mlp") is None)
    if not ok:
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family!r}, attention={cfg.attention!r}) under a mesh "
            "waits for a later slice of the port (ROADMAP queue 1: MLA, SSM/hybrid, enc-dec "
            "and VLM under a mesh, and the expert hidden dim sharded over data); the dense "
            "and GQA-MoE decoders run sharded"
        )


def _norm_params(cfg, a) -> dict:
    if cfg.norm == "ln":
        return {"w": a.param((cfg.d_model,), "ones", axes=("embed",)),
                "b": a.param((cfg.d_model,), "zeros", axes=("embed",))}
    return {"w": a.param((cfg.d_model,), "zeros", axes=("embed",))}


def _norm(cfg, p, x: torch.Tensor, ctx=None) -> torch.Tensor:
    if ctx is not None:  # the norm's weights whole over the model axis
        p = {k: ctx.gather(w) for k, w in p.tree().items()}
    if cfg.norm == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


def block_params(cfg, a, *, kind: str = "decoder", moe_layer: bool = True) -> dict:
    """One layer's parameters; ``kind`` is decoder, encoder or xdecoder (a
    decoder with cross-attention). An MoE config's layer carries the MoE
    layer unless ``moe_layer`` is False (deepseek-v2's leading dense
    layers)."""
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
    if kind == "xdecoder":
        p["cross"] = gqa_params(cfg, a)
        p["cross_norm"] = _norm_params(cfg, a)
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
    enc_out: Optional[torch.Tensor] = None,  # the encoder's states, for cross-attention
    window: Optional[int] = None,  # None = full attention (global layers)
    ctx=None,
) -> Tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Returns (x_out, new_cache, moe_aux_loss); the aux loss is an f32
    scalar, and None for a layer without the MoE layer (where the reference
    returns a zero: a layer of the other families launches nothing for
    it). Decode writes the cache in place; a decoder layer's ``cross``
    cache is read, never written. Under a mesh (``ctx``, the dense and GQA
    MoE decoders: :func:`check_parallel_supported`) ``x`` is this rank's
    block of the residual stream and the result is too."""
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
            _norm(cfg, p["attn_norm"], x, ctx),
            positions,
            window=window,
            prefix_len=prefix_len,
            bidirectional=bidirectional,
            cache=cache.get("attn") if cache else None,
            cache_index=cache_index,
            return_cache=return_cache,
            **({} if ctx is None else {"ctx": ctx}),
        )
        if a_cache is not None:
            new_cache["attn"] = a_cache
        # hybrid: parallel attention + SSD heads (hymba)
        x = x + (a_out if s_out is None else 0.5 * (a_out + s_out))
    else:
        x = x + s_out
    if "cross" in p:
        c_out, c_cache = _cross_attention(
            cfg, p["cross"], _norm(cfg, p["cross_norm"], x), enc_out,
            cache=cache.get("cross") if cache else None, return_cache=return_cache,
        )
        x = x + c_out
        if c_cache is not None:
            new_cache["cross"] = c_cache
    aux = None
    if "moe" in p:
        m_out, aux = moe_apply(cfg, p["moe"], _norm(cfg, p["mlp_norm"], x, ctx), ctx)
        x = x + m_out
    elif "mlp" in p:
        x = x + mlp_apply(cfg, p["mlp"], _norm(cfg, p["mlp_norm"], x, ctx), ctx)
    return x, (new_cache or None), aux


def _cross_attention(cfg, p, x: torch.Tensor, enc_out: Optional[torch.Tensor], *,
                     cache: Optional[dict] = None, return_cache: bool = False):
    """Cross-attention: queries from the decoder, keys and values from the
    encoder, every frame visible (the flash kernel, non-causal with Sq !=
    Sk, in prefill). Prefill projects the encoder's states and, with
    ``return_cache``, returns them as the static cache that decode reads."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cache is not None:
        k, v = cache["k"], cache["v"]
    else:
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    out = attend(q, k, v, PrefillMask(causal=False))
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, ({"k": k, "v": v} if return_cache else None)


def block_cache_shape(cfg, batch: int, seq: int, dtype, *, is_global: bool = True,
                      xdec_enc_seq: Optional[int] = None) -> dict:
    """Cache shapes for ONE layer (meta tensors). seq = the KV length kept;
    ``xdec_enc_seq``: a decoder layer's cross cache over that many encoder
    frames."""
    c: dict = {}
    if cfg.attention == "mla":
        c["attn"] = mla_cache_shape(cfg, batch, seq, dtype)
    elif cfg.attention == "gqa":
        ring = (not is_global) and cfg.window is not None and cfg.window < seq
        kv_len = min(seq, cfg.window) if ring else seq
        c["attn"] = gqa_cache_shape(cfg, batch, kv_len, dtype, ring=ring)
    if cfg.family in ("ssm", "hybrid"):
        c["ssm"] = ssm_cache_shape(cfg, batch, dtype)
    if xdec_enc_seq is not None:
        c["cross"] = gqa_cache_shape(cfg, batch, xdec_enc_seq, dtype)
    return c
