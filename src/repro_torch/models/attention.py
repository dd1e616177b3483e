"""Attention variants, ported from the reference's
``repro/models/attention.py``: grouped-query attention (RoPE, optional
window/bias) and MLA (DeepSeek-V2 multi-head latent attention with a
compressed KV cache).

Layouts follow the reference at every public function: activations are
``(B, S, H, Dh)``, caches ``{"k": (B, S, KV, Dh), "v": ...}`` (GQA) or
``{"ckv": (B, S, kv_lora), "krope": (B, S, rope)}`` (MLA). The one
difference is the batch of decode lanes: the reference decodes one
sequence per call and the engine ``vmap``s it, so here ``cache_index`` is
a ``(B,)`` tensor and every lane has its own RoPE position, cache write
offset and valid length.

Prefill and the training forward (``Sq > 1``) on a CUDA tensor always run
the hand-written flash kernel (``repro_torch.kernels.flash_attention``),
under autograd through its ``FlashAttention`` function, whose backward is
the hand-written backward kernel; MLA's expanded form runs it with query
and key head dim ``nope + rope`` (192) and value head dim ``v_head_dim``
(128). Every prefill mask takes the kernel: causal, a sliding window, a
prefix-LM span (paligemma's image tokens), bidirectional (whisper's
encoder) and the cross-attention's queries over all encoder frames
(``Sq != Sk``). Decode (``Sq == 1``) and every CPU call take the dense
einsum path, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .common import NEG_INF, apply_rope, causal_mask_bias, rms_norm

ATTN_CHUNK = 2048  # q-block size for the chunked dense path


@dataclass(frozen=True)
class PrefillMask:
    """The mask of a prefill call, whose queries and keys sit at positions
    from 0: causal (top-left aligned), or bidirectional (every key, also
    with ``Sq != Sk``); a sliding window; a prefix-LM span (keys below
    ``prefix_len`` seen by every query). The flash kernel takes each of
    them; the dense path builds the bias itself (:meth:`bias`)."""

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
        if not isinstance(mask, PrefillMask):
            raise NotImplementedError(
                "an additive bias over more than one query (queries not starting "
                "at position 0) has no flash-kernel form"
            )
        if not mask.causal:
            return flash_attention(q, k, v, causal=False)
        return flash_attention(q, k, v, causal=True, window=mask.window,
                               prefix_len=mask.prefix_len)
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
    scale = Dh**-0.5  # the query/key head dim: MLA's (nope + rope)^-1/2
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


def _pad_param(a, real_shape, padded_shape, pad_axis: int, axes):
    """A param stored at ``padded_shape`` whose pad region is exactly zero
    (an allocator that draws nothing declares the padded shape)."""
    if a.mode != "init" or real_shape == padded_shape:
        return a.param(padded_shape, axes=axes)
    real = a.param(real_shape, axes=axes)
    axis = pad_axis + real.ndim - len(real_shape)  # stacked layers prefix
    shape = list(real.shape)
    shape[axis] = padded_shape[pad_axis] - real_shape[pad_axis]
    return torch.cat([real, real.new_zeros(shape)], dim=axis)


def gqa_params(cfg, a) -> dict:
    d, Dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Hp, KVp = cfg.heads_padded, cfg.kv_heads_padded
    p = {
        "wq": _pad_param(a, (d, H, Dh), (d, Hp, Dh), 1, ("embed", "heads", None)),
        "wk": _pad_param(a, (d, KV, Dh), (d, KVp, Dh), 1, ("embed", "kv", None)),
        "wv": _pad_param(a, (d, KV, Dh), (d, KVp, Dh), 1, ("embed", "kv", None)),
        "wo": _pad_param(a, (H, Dh, d), (Hp, Dh, d), 0, ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = a.param((Hp, Dh), "zeros", axes=("heads", None))
        p["bk"] = a.param((KVp, Dh), "zeros", axes=("kv", None))
        p["bv"] = a.param((KVp, Dh), "zeros", axes=("kv", None))
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
    ctx=None,
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

    Under a mesh (``ctx``) this rank's share runs: :func:`_gqa_sharded`.
    """
    if ctx is not None:
        return _gqa_sharded(cfg, p, x, positions, cache=cache, cache_index=cache_index,
                            return_cache=return_cache, ctx=ctx)
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


def _kv_of_local_heads(k: torch.Tensor, first: int, Hl: int, G: int) -> torch.Tensor:
    """The kv heads (dim 2 of ``k``) that query heads ``first .. first+Hl``
    read (head h reads h // G): a contiguous run when every local kv head
    serves the same number of them, else one kv head per query head."""
    lo, hi = first // G, (first + Hl - 1) // G + 1
    if Hl % G == 0 or G % Hl == 0:
        return k[:, :, lo:hi]
    idx = torch.arange(first, first + Hl, device=k.device) // G
    return k.index_select(2, idx)


def kv_cache_split(kv_heads: int, head_dim: int, n_model: int) -> Optional[str]:
    """The dim of a k/v cache split over the model axis (its layout in
    ``parallel.steps.cache_specs``): ``"kv_heads"`` where they divide it,
    else ``"head_dim"`` where that divides it, else None (whole)."""
    if kv_heads % n_model == 0 and kv_heads >= n_model:
        return "kv_heads"
    if head_dim % n_model == 0 and head_dim >= n_model:
        return "head_dim"
    return None


def _gqa_sharded(cfg, p, x, positions, *, cache, cache_index, return_cache, ctx):
    """This rank's share of GQA under a mesh (tensor parallel over heads).

    Where the spec shards the heads over the model axis, the rank projects
    its own query heads from the whole sequence (the residual stream
    all-gathered where it is split), with its own kv heads where the spec
    shards those too, else with the kv heads its query heads read, projected
    whole. The output projection's partial sums over the heads are then
    reduce-scattered back over the sequence (all-reduced in decode). Where
    the heads do not divide, every weight is gathered whole and the rank
    runs every head, keeping its block of the sequence. The flash kernel
    runs on the local heads. The k/v caches keep ``cache_specs``'s layout:
    the local kv heads, or with kv heads that do not divide the head dim's
    block (the decode gathers it back whole, layer by layer), or whole.
    """
    Hp, KVp, Dh = cfg.heads_padded, cfg.kv_heads_padded, cfg.head_dim
    n = ctx.n_model
    heads = ctx.model_dim(p["wq"]) == 1
    kv_local = heads and ctx.model_dim(p["wk"]) == 1
    hd, kd = (1 if heads else None), (1 if kv_local else None)
    h = ctx.seq_gather(x) if cache is None else x  # every position of the sequence
    q = torch.einsum("bsd,dhk->bshk", h, ctx.take(p["wq"], hd))
    k = torch.einsum("bsd,dhk->bshk", h, ctx.take(p["wk"], kd))
    v = torch.einsum("bsd,dhk->bshk", h, ctx.take(p["wv"], kd))
    if cfg.qkv_bias:
        q = q + ctx.take(p["bq"], None if hd is None else 0)
        k = k + ctx.take(p["bk"], None if kd is None else 0)
        v = v + ctx.take(p["bv"], None if kd is None else 0)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    dh_split = not kv_local and kv_cache_split(KVp, Dh, n) == "head_dim"
    if cache is None:
        k_all, v_all = k, v
        if return_cache:
            new_cache = ({"k": ctx.chunk(k, 3), "v": ctx.chunk(v, 3)} if dh_split
                         else {"k": k, "v": v})
        else:
            new_cache = None
    else:
        B = x.shape[0]
        lanes = torch.arange(B, device=x.device)
        idx = cache_index.long()
        k_cache, v_cache = cache["k"], cache["v"]
        kw, vw = (ctx.chunk(k, 3), ctx.chunk(v, 3)) if dh_split else (k, v)
        k_cache[lanes, idx] = kw[:, 0].to(k_cache.dtype)
        v_cache[lanes, idx] = vw[:, 0].to(v_cache.dtype)
        if dh_split:
            k_cache, v_cache = ctx.model_gather(k_cache, 3), ctx.model_gather(v_cache, 3)
        k_all, v_all = k_cache, v_cache
        new_cache = None
    if heads and not kv_local:
        Hl = Hp // n
        G = Hp // KVp
        k_all = _kv_of_local_heads(k_all, ctx.model_rank * Hl, Hl, G)
        v_all = _kv_of_local_heads(v_all, ctx.model_rank * Hl, Hl, G)
    if cache is None:
        out = attend(q, k_all, v_all, PrefillMask(causal=True))
    else:
        Sk = k_all.shape[1]
        bias = causal_mask_bias(positions, torch.arange(Sk, device=x.device),
                                valid_len=cache_index.long() + 1)
        out = attend(q, k_all, v_all, bias)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), ctx.take(p["wo"], 0 if heads else None))
    if heads:  # partial sums over the heads
        y = ctx.seq_reduce(y) if cache is None else ctx.model_sum(y)
    elif cache is None:
        y = ctx.constrain_activations(y)
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed latent KV cache
# ---------------------------------------------------------------------------


def mla_params(cfg, a) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, v_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lq, lkv = cfg.q_lora_rank, cfg.kv_lora_rank
    p = {}
    if lq:
        p["wq_a"] = a.param((d, lq), axes=("embed", "lora"))
        p["q_norm"] = a.param((lq,), "zeros", axes=("lora",))
        p["wq_b"] = a.param((lq, H, nope + rope_d), axes=("lora", "heads", None))
    else:
        p["wq"] = a.param((d, H, nope + rope_d), axes=("embed", "heads", None))
    p["wkv_a"] = a.param((d, lkv + rope_d), axes=("embed", "lora"))
    p["kv_norm"] = a.param((lkv,), "zeros", axes=("lora",))
    p["wk_b"] = a.param((lkv, H, nope), axes=("lora", "heads", None))
    p["wv_b"] = a.param((lkv, H, v_d), axes=("lora", "heads", None))
    p["wo"] = a.param((H, v_d, d), axes=("heads", None, "embed"))
    return p


def mla_cache_shape(cfg, batch: int, seq: int, dtype) -> dict:
    """Meta tensors with the shapes of the compressed cache: the latent
    ``ckv`` and the rotated key part ``krope`` shared by the heads."""
    meta = torch.device("meta")
    return {
        "ckv": torch.empty((batch, seq, cfg.kv_lora_rank), dtype=dtype, device=meta),
        "krope": torch.empty((batch, seq, cfg.qk_rope_head_dim), dtype=dtype, device=meta),
    }


def _mla_qkv(cfg, p, x, positions):
    nope = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        cq = rms_norm(torch.einsum("bsd,dl->bsl", x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = torch.einsum("bsl,lhk->bshk", cq, p["wq_b"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dl->bsl", x, p["wkv_a"])
    ckv = rms_norm(kv_a[..., : cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., cfg.kv_lora_rank :]  # (B, S, rope_d) shared across heads
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_attention(
    cfg,
    p,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) prefill, or (B, 1) per-lane decode
    *,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,  # (B,) write offsets
    return_cache: bool = False,
    **_unused,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill and training take the expanded form: keys and values
    projected out of the latent per head, then :func:`attend`. Decode takes
    the absorbed form: scores and values straight against the compressed
    cache, into which each lane's latent and rotated key are written in
    place at its ``cache_index``."""
    B, S, d = x.shape
    H = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = (nope + rope_d) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, positions)

    new_cache = None
    if cache is not None:
        # decode: absorbed form; per-token cache traffic is kv_lora + rope
        # (576) values instead of 2 * H * Dh
        if S != 1:
            raise ValueError(f"decode takes one token per lane, got S={S}")
        lanes = torch.arange(B, device=x.device)
        idx = cache_index.long()
        ckv_c, krope_c = cache["ckv"], cache["krope"]
        ckv_c[lanes, idx] = ckv[:, 0].to(ckv_c.dtype)
        krope_c[lanes, idx] = k_rope[:, 0].to(krope_c.dtype)
        Sk = ckv_c.shape[1]
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, p["wk_b"])  # absorb W_UK
        # f32 scores from the input-dtype operands, as the reference's
        # preferred_element_type=f32
        scores = (
            torch.einsum("bqhl,bsl->bhqs", q_eff.float(), ckv_c.float())
            + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), krope_c.float())
        ) * scale
        bias = causal_mask_bias(positions, torch.arange(Sk, device=x.device), valid_len=idx + S)
        scores = scores + bias[:, None, :, :]
        w = F.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqs,bsl->bqhl", w, ckv_c)
        out = torch.einsum("bqhl,lhv->bqhv", ctx, p["wv_b"])  # absorb W_UV
    else:
        # prefill/train: expanded form (better matmul shapes at long Sq)
        k_nope = torch.einsum("bsl,lhn->bshn", ckv, p["wk_b"])
        v = torch.einsum("bsl,lhv->bshv", ckv, p["wv_b"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attend(q, k, v, PrefillMask(causal=True))
        if return_cache:
            new_cache = {"ckv": ckv, "krope": k_rope}

    y = torch.einsum("bshv,hvd->bsd", out.to(x.dtype), p["wo"])
    return y, new_cache
