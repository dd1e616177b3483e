"""Grouped-query attention (RoPE, optional window/bias), ported from the
reference's ``repro/models/attention.py``. MLA waits for a later slice.

Layouts follow the reference at every public function: activations are
``(B, S, H, Dh)``, caches ``{"k": (B, S, KV, Dh), "v": ...}``. The one
difference is the batch of decode lanes: the reference decodes one
sequence per call and the engine ``vmap``s it, so here ``cache_index`` is
a ``(B,)`` tensor and every lane has its own RoPE position, cache write
offset and valid length.

Prefill and the training forward (``Sq > 1``) on a CUDA tensor always run
the hand-written flash kernel (``repro_torch.kernels.flash_attention``),
under autograd through its ``FlashAttention`` function, whose backward is
the hand-written backward kernel; decode (``Sq == 1``) and every CPU call
take the dense einsum path, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .common import NEG_INF, apply_rope, causal_mask_bias

ATTN_CHUNK = 2048  # q-block size for the chunked dense path


@dataclass(frozen=True)
class PrefillMask:
    """The mask of a prefill call, whose queries and keys sit at positions
    0..S-1: causal (top-left aligned), or bidirectional; a sliding window;
    a prefix-LM span. The flash kernel expresses all but the prefix span;
    the dense path builds the bias itself (:meth:`bias`)."""

    causal: bool = True
    window: Optional[int] = None
    prefix_len: Optional[int] = None

    def bias(self, Sq: int, Sk: int, device) -> torch.Tensor:
        """Additive f32 bias ``(1, Sq, Sk)`` for the dense path."""
        if not self.causal:
            return torch.zeros((1, Sq, Sk), dtype=torch.float32, device=device)
        q_pos = torch.arange(Sq, device=device)
        k_pos = torch.arange(Sk, device=device)
        return causal_mask_bias(q_pos, k_pos, window=self.window, prefix_len=self.prefix_len)[None]


def attend(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, KV, Dh)
    v: torch.Tensor,  # (B, Sk, KV, Dv)
    mask: Union[torch.Tensor, PrefillMask],
) -> torch.Tensor:
    """``mask`` is a prefill's :class:`PrefillMask`, or an additive f32 bias
    ``(B or 1, Sq, Sk)`` (decode builds one from each lane's cache)."""
    B, Sq, H, Dh = q.shape
    if q.is_cuda and Sq > 1:
        if not isinstance(mask, PrefillMask) or mask.prefix_len is not None:
            raise NotImplementedError(
                "this attention mask (prefix-LM, or queries not starting at "
                "position 0) has no flash-kernel form yet"
            )
        window = mask.window if mask.causal else None
        return flash_attention(q, k, v, causal=mask.causal, window=window)
    bias = mask.bias(Sq, k.shape[1], q.device) if isinstance(mask, PrefillMask) else mask
    if Sq > ATTN_CHUNK and Sq % ATTN_CHUNK == 0:
        # q-chunked dense path: never materialises the (Sq, Sk) scores for
        # the whole sequence at once
        outs = [
            _attend_dense(q[:, i : i + ATTN_CHUNK], k, v, bias[:, i : i + ATTN_CHUNK])
            for i in range(0, Sq, ATTN_CHUNK)
        ]
        return torch.cat(outs, dim=1)
    return _attend_dense(q, k, v, bias)


def _attend_dense(q, k, v, bias):
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = Dh**-0.5
    qg = q.reshape(B, Sq, KV, G, Dh)
    # f32 scores from the input-dtype operands (bf16 products are exact in
    # f32), as the reference's preferred_element_type=f32
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale + bias[:, None, None, :, :]
    w = F.softmax(scores, dim=-1).to(q.dtype)  # cast back before PV, as the reference
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _pad_param(a, real_shape, padded_shape, pad_axis: int):
    """A param stored at ``padded_shape`` whose pad region is exactly zero."""
    real = a.param(real_shape)
    if real_shape == padded_shape:
        return real
    axis = pad_axis + real.ndim - len(real_shape)  # stacked layers prefix
    shape = list(real.shape)
    shape[axis] = padded_shape[pad_axis] - real_shape[pad_axis]
    return torch.cat([real, real.new_zeros(shape)], dim=axis)


def gqa_params(cfg, a) -> dict:
    d, Dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Hp, KVp = cfg.heads_padded, cfg.kv_heads_padded
    p = {
        "wq": _pad_param(a, (d, H, Dh), (d, Hp, Dh), 1),
        "wk": _pad_param(a, (d, KV, Dh), (d, KVp, Dh), 1),
        "wv": _pad_param(a, (d, KV, Dh), (d, KVp, Dh), 1),
        "wo": _pad_param(a, (H, Dh, d), (Hp, Dh, d), 0),
    }
    if cfg.qkv_bias:
        p["bq"] = a.param((Hp, Dh), "zeros")
        p["bk"] = a.param((KVp, Dh), "zeros")
        p["bv"] = a.param((KVp, Dh), "zeros")
    return p


def gqa_cache_shape(cfg, batch: int, seq: int, dtype, *, ring: bool = False) -> dict:
    """Meta tensors with the cache's shapes. A ring cache keeps one row of
    absolute positions per lane, ``(B, W)``: the reference keeps one row per
    vmapped batch-1 call, which is the same thing with the batch written out."""
    KV, Dh = cfg.kv_heads_padded, cfg.head_dim
    meta = torch.device("meta")
    c = {
        "k": torch.empty((batch, seq, KV, Dh), dtype=dtype, device=meta),
        "v": torch.empty((batch, seq, KV, Dh), dtype=dtype, device=meta),
    }
    if ring:
        c["pos"] = torch.empty((batch, seq), dtype=torch.int32, device=meta)
    return c


def gqa_attention(
    cfg,
    p,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) prefill, or (B, 1) per-lane decode
    *,
    window: Optional[int] = None,
    prefix_len: Optional[int] = None,
    bidirectional: bool = False,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,  # (B,) write offsets
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (prefill) or single-token (decode) attention.

    prefill: ``positions`` is ``arange(S)``; with ``return_cache`` the new
    K/V come back (a ring of the last ``W`` keys when ``window`` is set).

    decode: pass ``cache`` + ``cache_index``; x has S=1. Each lane's key
    and value are written in place at its ``cache_index`` (the reference
    returns an updated copy; it donates the buffer, the port mutates it),
    then attended over the whole masked cache. A cache carrying ``pos`` is
    a sliding-window ring: writes go to slot ``cache_index % W`` and masking
    uses the stored absolute positions.
    """
    B, S, d = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        if S != 1:
            raise ValueError(f"decode takes one token per lane, got S={S}")
        lanes = torch.arange(B, device=x.device)
        k_cache, v_cache = cache["k"], cache["v"]
        Sk = k_cache.shape[1]
        idx = cache_index.long()
        if "pos" in cache:  # ring buffer
            slot = torch.remainder(idx, Sk)
            k_cache[lanes, slot] = k[:, 0].to(k_cache.dtype)
            v_cache[lanes, slot] = v[:, 0].to(v_cache.dtype)
            pos_buf = cache["pos"]
            pos_buf[lanes, slot] = idx.to(pos_buf.dtype)
            q_pos = idx[:, None]
            ok = (pos_buf >= 0) & (pos_buf <= q_pos)
            if window is not None:
                ok = ok & (pos_buf > q_pos - window)
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            bias = torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None, :]
        else:
            k_cache[lanes, idx] = k[:, 0].to(k_cache.dtype)
            v_cache[lanes, idx] = v[:, 0].to(v_cache.dtype)
            bias = causal_mask_bias(
                positions, torch.arange(Sk, device=x.device), window=window,
                prefix_len=prefix_len, valid_len=idx + S,
            )
        out = attend(q, k_cache, v_cache, bias)
    else:
        # prefill positions run from 0, so causality is the kernel's
        # top-left-aligned mask
        if bidirectional:
            mask = PrefillMask(causal=False)
        else:
            mask = PrefillMask(causal=True, window=window, prefix_len=prefix_len)
        out = attend(q, k, v, mask)
        if return_cache:
            if window is not None:  # a ring cache of the last W keys, laid
                # out so position p lives at slot p % W (the decode write
                # invariant): roll the linear tail into ring order
                W = min(window, S)
                shift = (S - W) % W
                pos = torch.roll(positions[S - W :].to(torch.int32), shift)
                new_cache = {
                    "k": torch.roll(k[:, S - W :], shift, dims=1),
                    "v": torch.roll(v[:, S - W :], shift, dims=1),
                    "pos": pos.expand(B, W).contiguous(),
                }
            else:
                new_cache = {"k": k, "v": v}

    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, new_cache
