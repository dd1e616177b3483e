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

from ..kernels import build
from ..kernels.flash_attention import flash_attention
from ..parallel.ctx import reduce_scatter
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
    ``(B or 1, Sq, Sk)`` (decode builds one from each lane's cache). On the
    card a prefill goes to the flash kernel; so it does on the CPU while the
    dry run stands in for the kernels (``kernels.build.STAND_IN``)."""
    B, Sq, H, Dh = q.shape
    if (q.is_cuda or build.STAND_IN is not None) and Sq > 1:
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


def prefill_mask(window: Optional[int], prefix_len: Optional[int], bidirectional: bool
                 ) -> PrefillMask:
    """A prefill's mask: every key (bidirectional), else causal with the
    layer's window and the prompt's prefix-LM span."""
    if bidirectional:
        return PrefillMask(causal=False)
    return PrefillMask(causal=True, window=window, prefix_len=prefix_len)


def prefill_cache(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  window: Optional[int]) -> dict:
    """A prefill's k/v cache: every position, or with ``window`` a ring of
    the last ``W`` keys, laid out so position p lives at slot p % W (the
    decode write invariant): the linear tail rolled into ring order, with
    each lane's row of absolute positions."""
    if window is None:
        return {"k": k, "v": v}
    B, S = k.shape[:2]
    W = min(window, S)
    shift = (S - W) % W
    pos = torch.roll(positions[S - W :].to(torch.int32), shift)
    return {
        "k": torch.roll(k[:, S - W :], shift, dims=1),
        "v": torch.roll(v[:, S - W :], shift, dims=1),
        "pos": pos.expand(B, W).contiguous(),
    }


def decode_write(cache: dict, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                 index: torch.Tensor, *, window: Optional[int] = None,
                 prefix_len: Optional[int] = None) -> torch.Tensor:
    """Writes each lane's new key and value (``k``, ``v``: (B, 1, KV, Dh))
    into ``cache`` in place at its ``index`` (slot ``index % W`` of a ring,
    whose ``pos`` row takes the absolute position) and returns the decode
    bias (B, 1, Sk) over the cache."""
    k_cache, v_cache = cache["k"], cache["v"]
    B, Sk = k.shape[0], k_cache.shape[1]
    lanes = torch.arange(B, device=k.device)
    idx = index.long()
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
        zero = torch.zeros((), dtype=torch.float32, device=k.device)
        return torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None, :]
    k_cache[lanes, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[lanes, idx] = v[:, 0].to(v_cache.dtype)
    return causal_mask_bias(positions, torch.arange(Sk, device=k.device), window=window,
                            prefix_len=prefix_len, valid_len=idx + 1)


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
        return _gqa_sharded(cfg, p, x, positions, window=window, prefix_len=prefix_len,
                            bidirectional=bidirectional, cache=cache, cache_index=cache_index,
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
        bias = decode_write(cache, k, v, positions, cache_index, window=window,
                            prefix_len=prefix_len)
        out = attend(q, cache["k"], cache["v"], bias)
    else:
        # prefill positions run from 0, so causality is the kernel's
        # top-left-aligned mask
        out = attend(q, k, v, prefill_mask(window, prefix_len, bidirectional))
        if return_cache:
            new_cache = prefill_cache(k, v, positions, window)

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


@dataclass(frozen=True)
class HeadSplit:
    """How a GQA layer's heads run under a mesh (``of``): ``heads`` when
    the spec shards the query heads over the model axis (this rank runs
    its own), ``kv_local`` when it shards the kv heads too; ``dh_split``
    when the k/v caches keep the head dim's block (kv heads that do not
    divide the model axis, ``cache_specs``)."""

    heads: bool
    kv_local: bool
    dh_split: bool

    @staticmethod
    def of(cfg, p, ctx) -> "HeadSplit":
        heads = ctx.model_dim(p["wq"]) == 1
        kv_local = heads and ctx.model_dim(p["wk"]) == 1
        dh_split = not kv_local and kv_cache_split(
            cfg.kv_heads_padded, cfg.head_dim, ctx.n_model) == "head_dim"
        return HeadSplit(heads, kv_local, dh_split)

    def project(self, p, name: str, h: torch.Tensor, ctx) -> torch.Tensor:
        """``h`` through this rank's columns of ``wq``/``wk``/``wv``."""
        local = self.heads if name == "wq" else self.kv_local
        return torch.einsum("bsd,dhk->bshk", h, ctx.take(p[name], 1 if local else None))

    def to_cache(self, k: torch.Tensor, ctx) -> torch.Tensor:
        """k or v (.., KV, Dh) as the cache keeps it on this rank."""
        return ctx.chunk(k, 3) if self.dh_split else k

    def from_cache(self, k: torch.Tensor, ctx) -> torch.Tensor:
        """A cache's k or v with every head dim (gathered where split)."""
        return ctx.model_gather(k, 3) if self.dh_split else k

    def local_kv(self, cfg, k: torch.Tensor, ctx) -> torch.Tensor:
        """The kv heads this rank's query heads read."""
        if not self.heads or self.kv_local:
            return k
        Hl = cfg.heads_padded // ctx.n_model
        G = cfg.heads_padded // cfg.kv_heads_padded
        return _kv_of_local_heads(k, ctx.model_rank * Hl, Hl, G)

    def out(self, p, o: torch.Tensor, x: torch.Tensor, ctx, decode: bool) -> torch.Tensor:
        """The output projection back to the residual stream's layout: the
        partial sums over the local heads reduce-scattered over the
        sequence (all-reduced in decode); with every head on every rank,
        this rank's block of the sequence."""
        y = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), ctx.take(p["wo"], 0 if self.heads
                                                                 else None))
        if self.heads:
            return ctx.seq_reduce(y)
        return y if decode else ctx.constrain_activations(y)


def _gqa_sharded(cfg, p, x, positions, *, window, prefix_len, bidirectional, cache,
                 cache_index, return_cache, ctx):
    """This rank's share of GQA under a mesh (tensor parallel over heads).

    Where the spec shards the heads over the model axis, the rank projects
    its own query heads from the whole sequence (the residual stream
    all-gathered where it is split), with its own kv heads where the spec
    shards those too, else with the kv heads its query heads read, projected
    whole. The output projection's partial sums over the heads are then
    reduce-scattered back over the sequence (all-reduced in decode). Where
    the heads do not divide, every weight is gathered whole and the rank
    runs every head, keeping its block of the sequence. The flash kernel
    runs on the local heads under every mask the single-device path takes
    (a window, a prefix-LM span, bidirectional). The k/v caches keep
    ``cache_specs``'s layout: the local kv heads, or with kv heads that do
    not divide the head dim's block (the decode gathers it back whole,
    layer by layer), or whole; a sliding window's ring and its ``pos`` row
    (whole on every rank) as on one device.
    """
    split = HeadSplit.of(cfg, p, ctx)
    h = ctx.seq_gather(x) if cache is None else x  # every position of the sequence
    q, k, v = (split.project(p, name, h, ctx) for name in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + ctx.take(p["bq"], 0 if split.heads else None)
        k = k + ctx.take(p["bk"], 0 if split.kv_local else None)
        v = v + ctx.take(p["bv"], 0 if split.kv_local else None)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is None:
        out = attend(q, split.local_kv(cfg, k, ctx), split.local_kv(cfg, v, ctx),
                     prefill_mask(window, prefix_len, bidirectional))
        if return_cache:
            new_cache = prefill_cache(split.to_cache(k, ctx), split.to_cache(v, ctx), positions,
                                      window)
    else:
        bias = decode_write(cache, split.to_cache(k, ctx), split.to_cache(v, ctx), positions,
                            cache_index, window=window, prefix_len=prefix_len)
        k_all, v_all = (split.local_kv(cfg, split.from_cache(cache[n], ctx), ctx)
                        for n in ("k", "v"))
        out = attend(q, k_all, v_all, bias)
    return split.out(p, out, x, ctx, decode=cache is not None), new_cache


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


def _mla_expanded(cfg, q_nope, q_rope, ckv, k_rope, wk_b, wv_b) -> torch.Tensor:
    """Prefill and training: keys and values projected out of the latent on
    the heads of ``wk_b``/``wv_b``, then causal :func:`attend`."""
    B, S = ckv.shape[:2]
    k_nope = torch.einsum("bsl,lhn->bshn", ckv, wk_b)
    v = torch.einsum("bsl,lhv->bshv", ckv, wv_b)
    H = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return attend(q, k, v, PrefillMask(causal=True))


def _mla_scores(cfg, q_eff, q_rope, ckv_c, krope_c, positions, k_pos, index) -> torch.Tensor:
    """The absorbed form's f32 scores (B, H, 1, Sk) of the latent cache at
    positions ``k_pos``, masked past each lane's valid length, from the
    input-dtype operands (the reference's preferred_element_type=f32)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    scores = (
        torch.einsum("bqhl,bsl->bhqs", q_eff.float(), ckv_c.float())
        + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), krope_c.float())
    ) * scale
    return scores + causal_mask_bias(positions, k_pos, valid_len=index + 1)[:, None, :, :]


def mla_attention(
    cfg,
    p,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (S,) prefill, or (B, 1) per-lane decode
    *,
    cache: Optional[dict] = None,
    cache_index: Optional[torch.Tensor] = None,  # (B,) write offsets
    return_cache: bool = False,
    ctx=None,
    **_unused,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill and training take the expanded form: keys and values
    projected out of the latent per head, then :func:`attend`. Decode takes
    the absorbed form: scores and values straight against the compressed
    cache, into which each lane's latent and rotated key are written in
    place at its ``cache_index``. Under a mesh (``ctx``) this rank's share
    runs: :func:`_mla_sharded`."""
    if ctx is not None:
        return _mla_sharded(cfg, p, x, positions, cache=cache, cache_index=cache_index,
                            return_cache=return_cache, ctx=ctx)
    B, S, d = x.shape
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
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, p["wk_b"])  # absorb W_UK
        scores = _mla_scores(cfg, q_eff, q_rope, ckv_c, krope_c, positions,
                             torch.arange(ckv_c.shape[1], device=x.device), idx)
        w = F.softmax(scores, dim=-1).to(x.dtype)
        ctx_l = torch.einsum("bhqs,bsl->bqhl", w, ckv_c)
        out = torch.einsum("bqhl,lhv->bqhv", ctx_l, p["wv_b"])  # absorb W_UV
    else:
        # prefill/train: expanded form (better matmul shapes at long Sq)
        out = _mla_expanded(cfg, q_nope, q_rope, ckv, k_rope, p["wk_b"], p["wv_b"])
        if return_cache:
            new_cache = {"ckv": ckv, "krope": k_rope}

    y = torch.einsum("bshv,hvd->bsd", out.to(x.dtype), p["wo"])
    return y, new_cache


def _mla_sharded(cfg, p, x, positions, *, cache, cache_index, return_cache, ctx):
    """This rank's share of MLA under a mesh. The latent projections
    (``wq_a``, ``wkv_a`` and their norms) run whole on every rank (their
    specs shard the model dim, so they are gathered); the query heads,
    ``wk_b``, ``wv_b`` and ``wo`` run on the rank's own heads where the spec
    shards them (else whole), and ``wo``'s partial sums over the heads are
    reduce-scattered back over the sequence.

    Prefill and training take the expanded form on the local heads over the
    whole sequence (the flash kernel at Dqk=192/Dv=128 on the card) and
    return the latents split over the sequence as ``cache_specs`` lays them
    out. Decode takes the absorbed form against that layout: each rank
    writes the new latent only where it owns the lane's position, scores
    its block of positions for every head (the absorbed queries gathered
    over the heads), and the softmax's max and sum are taken over the model
    group; the weighted latents are reduce-scattered back onto the local
    heads, which absorb ``wv_b`` and ``wo``. Where the caches are whole
    (their length does not divide), each rank attends over all of them on
    its heads."""
    B, S, _ = x.shape
    heads = ctx.model_dim(p["wq_b" if cfg.q_lora_rank else "wq"]) == 1
    hd = 1 if heads else None
    lp = {k: ctx.take(p[k], hd) for k in ("wq_b", "wq", "wk_b", "wv_b") if k in p}
    lp.update({k: ctx.gather(p[k]) for k in ("wq_a", "q_norm", "wkv_a", "kv_norm") if k in p})
    wo = ctx.take(p["wo"], 0 if heads else None)
    decode = cache is not None
    h = x if decode else ctx.seq_gather(x)  # every position of the sequence
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, lp, h, positions)
    new_cache = None
    if not decode:
        out = _mla_expanded(cfg, q_nope, q_rope, ckv, k_rope, lp["wk_b"], lp["wv_b"])
        if return_cache:
            seq = ctx.seq_split_of(S)
            new_cache = {"ckv": ctx.chunk(ckv, 1) if seq else ckv,
                         "krope": ctx.chunk(k_rope, 1) if seq else k_rope}
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per lane, got S={S}")
        if ctx.cache_len is None:
            raise ValueError("MLA's sharded decode needs the caches' global length "
                             "(parallel.steps.build_decode_step gives it)")
        ckv_c, krope_c = cache["ckv"], cache["krope"]
        Sl = ckv_c.shape[1]
        seq = ctx.seq_split_of(ctx.cache_len)
        lo = ctx.model_rank * Sl if seq else 0
        lanes = torch.arange(B, device=x.device)
        idx = cache_index.long()
        # the new latent goes to the rank whose block holds its position
        own = ((idx >= lo) & (idx < lo + Sl))[:, None]
        slot = (idx - lo).clamp(0, Sl - 1)
        ckv_c[lanes, slot] = torch.where(own, ckv[:, 0].to(ckv_c.dtype), ckv_c[lanes, slot])
        krope_c[lanes, slot] = torch.where(own, k_rope[:, 0].to(krope_c.dtype),
                                           krope_c[lanes, slot])
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, lp["wk_b"])  # absorb W_UK
        if seq and heads:  # every head scores this rank's positions
            q_eff, q_rope = ctx.model_gather(q_eff, 2), ctx.model_gather(q_rope, 2)
        scores = _mla_scores(cfg, q_eff, q_rope, ckv_c, krope_c, positions,
                             lo + torch.arange(Sl, device=x.device), idx)
        if seq:  # the softmax over every rank's block of positions
            mx = ctx.model_max(scores.amax(dim=-1, keepdim=True))
            e = torch.exp(scores - mx)
            w = (e / ctx.model_sum(e.sum(dim=-1, keepdim=True))).to(x.dtype)
            part = torch.einsum("bhqs,bsl->bqhl", w, ckv_c)
            lat = reduce_scatter(part, 2, ctx.model_group) if heads else ctx.model_sum(part)
        else:
            w = F.softmax(scores, dim=-1).to(x.dtype)
            lat = torch.einsum("bhqs,bsl->bqhl", w, ckv_c)
        out = torch.einsum("bqhl,lhv->bqhv", lat, lp["wv_b"])  # absorb W_UV
    y = torch.einsum("bshv,hvd->bsd", out.to(x.dtype), wo)
    if heads:
        return ctx.seq_reduce(y), new_cache
    return (y if decode else ctx.constrain_activations(y)), new_cache
