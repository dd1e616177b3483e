"""Flash attention forward: the hand-written sm_90a kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
model-layout wrapper.

Replaces the reference's Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_kernel`` / ``flash_attention_bhsd``) and its layout wrapper
``repro/kernels/ops.py::flash_attention``; ``attention_ref`` ports
``repro/kernels/ref.py``.

The backward (``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd`,
plain version :func:`flash_attention_bwd_ref`) has no Pallas counterpart:
the reference trains through XLA's autodiff of the dense einsum
(``repro/models/attention.py::_attend_dense``). It recomputes the
probabilities from the forward's row statistics ``lse``.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (or raise), CPU tensors take the plain versions. There is no
fallback from one to the other. On the card, bfloat16 (the served and
trained path) runs on the tensor cores and float32 (the parity path) on
FMA tiles, forward (:func:`design`) and backward (:func:`design_bwd`). The
bf16 backward splits P and dS into bf16 hi and lo parts for the products
that take them, so its gradients keep the precision of the f32 formulas to
within one bf16 rounding. At the wide pairs (:data:`WIDE_PAIRS`) its
dK/dV launch may split a kv-head's q-heads over CTAs
(:func:`bwd_head_split`), whose f32 partials the wrapper's scratch holds
until a reduce launch sums them.

Under autograd (grad enabled and an input requiring grad) the wrappers go
through :class:`FlashAttention`, whose backward launches the backward
kernels; the raw forward launch refuses to run there, so no caller gets an
output without a gradient.

The forward takes a query/key head dim ``Dqk`` and a value head dim ``Dv``
from :data:`HEAD_DIM_PAIRS`: Dqk = Dv at 32, 64, 128 and 256 (gemma's, in
paligemma), and Dqk = 192 with Dv = 128, MLA's expanded prefill
(deepseek-v2: 128 nope + 64 rope dims of query and key, 128 of value), each
on an instantiation of its own. The scale is ``Dqk**-0.5``. Besides the
causal, window and valid-length (``k_len``) masks, the forward takes a
prefix-LM span: with ``causal`` and ``prefix_len``, keys at positions below
``prefix_len`` are visible to every query (paligemma's image tokens), as
the reference's ``causal_mask_bias`` builds it. The backward takes the
pairs of :data:`BWD_HEAD_DIM_PAIRS` (Dqk = Dv in :data:`HEAD_DIMS`, 256
included, and MLA's 192/128, deepseek-v2's training) and the same masks,
the prefix span too; on a CUDA tensor any other pair under autograd raises
``NotImplementedError`` before anything is launched.

The first launch of each kernel instantiation (device, dtype, Dqk, Dv,
and forward or backward) in a process is preceded by a check launch on a
small input, held against the plain version by
:class:`~repro_torch.kernels.build.FirstLaunchGuard`; a disagreement raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..analysis import traffic
from . import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims with Dqk = Dv
HEAD_DIMS = (32, 64, 128, 256)
# the forward's (Dqk, Dv) pairs, each an instantiation of its own
HEAD_DIM_PAIRS = ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
# the backward's: Dqk = Dv in HEAD_DIMS, and MLA's 192/128
BWD_HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
# the wide pairs, whose bf16 forward is "wgmma-wide" and backward
# "wgmma-split-2wg": every pair with a head dim of 128 or more
WIDE_PAIRS = ((128, 128), (192, 128), (256, 256))


def fit_head_dims(cfg):
    """``cfg`` with its attention's head dims raised, where the kernels take
    no pair of its own, to the smallest pair of :data:`HEAD_DIM_PAIRS` that
    holds them (MLA's rope part kept): the reduced configs' 16 and 24 and
    MLA's 24/16 become 32/32. A config whose pair the kernels take (every
    full config) comes back as it is. The entry points run their config
    this way on the card; on the CPU the plain versions take any head dim."""
    if cfg.attention == "mla":
        dims = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    elif cfg.attention == "gqa":
        dims = (cfg.head_dim, cfg.head_dim)
    else:
        return cfg
    if dims in HEAD_DIM_PAIRS:
        return cfg
    dqk, dv = min(p for p in HEAD_DIM_PAIRS if p[0] >= dims[0] and p[1] >= dims[1]
                  and (cfg.attention == "mla" or p[0] == p[1]))
    if cfg.attention == "mla":
        return cfg.replace(qk_nope_head_dim=dqk - cfg.qk_rope_head_dim, v_head_dim=dv)
    return cfg.replace(head_dim=dqk)


def design(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The kernel design a launch of this dtype and (query/key, value) head
    dims runs, as ``csrc/flash_attention.cu`` names them: bf16 on ``wgmma``
    at 64/64, on ``mma.sync`` at 32/32, and at the wide pairs 128/128,
    192/128 (MLA: Q·Kᵀ 192 deep, the output 128 wide) and 256/256
    (:data:`WIDE_PAIRS`) "wgmma-wide": a producer warpgroup copying Q and
    64-key K and V tiles by TMA into a ring of 64-column swizzled slabs,
    and two consumer warpgroups, each owning 64 q rows of the CTA's 128,
    with Q·Kᵀ as chains of m64n64k16 and P·V one m64n128k16 a k-step per
    128 columns of V, P from registers; f32 on FMA tiles."""
    v_head_dim = head_dim if v_head_dim is None else v_head_dim
    if (head_dim, v_head_dim) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims {(head_dim, v_head_dim)} not in the kernel's {HEAD_DIM_PAIRS}")
    if dtype == torch.float32:
        return "fma-f32"
    if (head_dim, v_head_dim) in WIDE_PAIRS:
        return "wgmma-wide"
    return "wgmma" if (head_dim, v_head_dim) == (64, 64) else "mma.sync"


def design_bwd(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """The backward's design for this dtype and (query/key, value) head
    dims, as ``csrc/flash_attention_bwd.cu`` names them: bf16 on the tensor
    cores with P and dS split into hi + lo bf16 parts, on ``wgmma`` at head
    dim 64 and ``mma.sync`` at 32; at the wide pairs 128/128, 256/256 and
    MLA's 192/128 (:data:`WIDE_PAIRS`) "wgmma-split-2wg": a dK/dV CTA of
    two warpgroups on ``wgmma``, one computing Sᵀ once, forming Pᵀ and
    accumulating dV, the other taking Pᵀ through shared memory and
    accumulating dK, with a group's q-heads split over
    :func:`bwd_head_split` CTAs (f32 partials, then a reduce launch), and dQ
    on ``wgmma``; f32 on FMA tiles."""
    v_head_dim = head_dim if v_head_dim is None else v_head_dim
    if (head_dim, v_head_dim) not in BWD_HEAD_DIM_PAIRS:
        raise ValueError(f"head_dim {(head_dim, v_head_dim)} not in the backward's "
                         f"{BWD_HEAD_DIM_PAIRS}")
    if dtype == torch.float32:
        return "fma-f32"
    if (head_dim, v_head_dim) in WIDE_PAIRS:
        return "wgmma-split-2wg"
    return ("wgmma" if head_dim == 64 else "mma.sync") + "-split"


def bwd_head_split(B: int, KV: int, k_tiles: int, G: int, sms: int) -> int:
    """The CTAs a kv-head's ``G`` q-heads are split over in the wide pairs'
    dK/dV launch: the largest divisor of G that keeps ``B·KV·k_tiles`` (one
    CTA per batch, kv-head and 64-key tile) times it within the card's
    ``sms`` (one such CTA fits an SM), and 1 where the unsplit grid already
    reaches it. Each split CTA writes f32 partials that a reduce launch sums
    in split order."""
    cells = B * KV * k_tiles
    return max(d for d in range(1, G + 1) if G % d == 0 and (d == 1 or cells * d <= sms))


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


_fn_lock = threading.Lock()
_fns: dict = {}
# keyed by (device index, dtype, Dqk, Dv)
_guard = build.FirstLaunchGuard(
    "flash_attention", lambda got, want: (got.float() - want.float()).abs().max().item()
)


def _scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|): gradients grow with the
    sequence, so their error is read against their size."""
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


# keyed by (device index, dtype, Dqk, Dv); the error of each gradient is scaled
_bwd_guard = build.FirstLaunchGuard("flash_attention_bwd", _scaled_error)


def _kernel_fn(name: str = "flash_attention_fwd"):
    """The C entry ``flash_attention_fwd`` (library ``flash_attention``) or
    ``flash_attention_bwd`` (library ``flash_attention_bwd``), loaded and
    typed once."""
    with _fn_lock:
        fn = _fns.get(name)
        if fn is None:
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            if name == "flash_attention_fwd":
                fn = build.library("flash_attention").flash_attention_fwd
                fn.argtypes = (
                    [ptr] * 4 + [i32] * 9 + [i64] * 12 + [i32] * 4 + [ctypes.c_float, ptr, ptr]
                )
            else:
                fn = build.library("flash_attention_bwd").flash_attention_bwd
                fn.argtypes = ([ptr] * 10 + [i32] * 9 + [ptr] + [i32] * 4
                               + [ctypes.c_float, ptr, i32, ptr])
            fn.restype = i32
            _fns[name] = fn
        return fn


def _mask(Sq: int, Sk: int, causal: bool, window, k_len, device,
          prefix_len: Optional[int] = None) -> torch.Tensor:
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = k_pos < (Sk if k_len is None else k_len)
    if causal:
        seen = k_pos <= q_pos
        if prefix_len:
            seen = seen | (k_pos < prefix_len)
        mask = mask & seen
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, Dqk)
    k: torch.Tensor,  # (B, KV, Sk, Dqk)
    v: torch.Tensor,  # (B, KV, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, to the kernel's semantics: f32
    scores of q pre-scaled by ``Dqk**-0.5``, finite ``-1e30`` for masked
    keys, causal aligned top-left (positions from 0), with ``prefix_len``
    keys below it visible to every query, the denominator floored at 1e-30,
    output (B, H, Sq, Dv) cast to the input dtype."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window, k_len=k_len,
                                   prefix_len=prefix_len)[0]


def flash_attention_lse_ref(q, k, v, *, causal=True, window=None, k_len=None, prefix_len=None):
    """:func:`flash_attention_ref` and the rows' f32 statistics ``lse = m +
    log(max(l, 1e-30))`` (B, H, Sq), natural log, as the kernel writes them
    for the backward."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, Dh).float() * Dh**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    s = torch.where(_mask(Sq, Sk, causal, window, k_len, q.device, prefix_len), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / denom
    lse = (m + torch.log(denom)).reshape(B, H, Sq)
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, H, Sq, Dqk)
    k: torch.Tensor,  # (B, KV, Sk, Dqk)
    v: torch.Tensor,  # (B, KV, Sk, Dv)
    o: torch.Tensor,  # (B, H, Sq, Dv), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) f32, the forward's row statistics
    do: torch.Tensor,  # (B, H, Sq, Dv), the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
):
    """Plain PyTorch version of the backward kernels, by their formulas, in
    f32: ``P = exp(S·scale − lse)`` (0 where masked), ``D = rowsum(dO∘O)``,
    ``dV = Pᵀ dO``, ``dS = P∘(dO Vᵀ − D)``, ``dK = dSᵀ Q·scale``, ``dQ = dS
    K·scale``, GQA gradients summed over each kv-head's q-heads. A row that
    sees no key gets zero gradient. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, Dh**-0.5

    def grouped(t):
        return t.reshape(B, KV, G, Sq, t.shape[-1]).float()

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg * scale, kf)
    lse_g = lse.reshape(B, KV, G, Sq, 1).float()
    mask = _mask(Sq, Sk, causal, window, k_len, q.device, prefix_len)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return dq.reshape(B, H, Sq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, Dqk)
    k: torch.Tensor,  # (B, KV, Sk, Dqk)
    v: torch.Tensor,  # (B, KV, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Dense f32 softmax attention with GQA head grouping (the reference's
    ``kernels/ref.py::attention_ref``), with the kernel's masks."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, Dh).float() * Dh**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    s = torch.where(_mask(Sq, Sk, causal, window, k_len, q.device, prefix_len), s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, Dqk)
    k: torch.Tensor,  # (B, KV, Sk, Dqk)
    v: torch.Tensor,  # (B, KV, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention in layout (batch, heads, seq, head_dim); with
    ``causal``, keys below ``prefix_len`` are visible to every query.

    CUDA tensors launch the kernel: any stride is taken as long as the last
    dim is contiguous (and, in bfloat16, every other stride and the base
    address are 16-byte aligned: :func:`check_inputs`), and the output has
    q's memory order. CPU tensors take :func:`flash_attention_ref`. Under
    autograd the call goes through :class:`FlashAttention`.
    ``flash_attention_bhsd.launches`` counts forward kernel launches through
    this function and :func:`flash_attention` (the first-launch checks' are
    not counted, nor a launch into a CUDA graph being captured:
    :func:`~repro_torch.kernels.build.count_launch`).
    """
    return _attention(q, k, v, causal, window, k_len, prefix_len, bshd=False)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dqk) — model layout
    k: torch.Tensor,  # (B, Sk, KV, Dqk)
    v: torch.Tensor,  # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention_bhsd` in the model's layout: the kernel reads
    (B, S, H, D) through its strides, and the output comes back as (B, Sq,
    H, Dv)."""
    return _attention(q, k, v, causal, window, k_len, prefix_len, bshd=True)


def _to_bhsd(bshd, *tensors):
    return tuple(t.transpose(1, 2) for t in tensors) if bshd else tensors


def _attention(q, k, v, causal, window, k_len, prefix_len, *, bshd):
    if build.needs_grad(q, k, v):
        if q.device.type != "cpu":
            _require_bwd_dims(q, v)  # before the forward runs, not in the backward
        return FlashAttention.apply(q, k, v, causal, window, k_len, bshd, prefix_len)
    return _forward(q, k, v, causal, window, k_len, bshd, lse=False, prefix_len=prefix_len)


def flash_attention_lse(q, k, v, *, causal=True, window=None, k_len=None, bshd=False,
                        prefix_len=None):
    """The forward and its rows' f32 statistics ``lse`` (B, H, Sq), which
    the backward takes. CUDA tensors launch the kernel (counted in
    ``flash_attention_bhsd.launches``), CPU tensors take
    :func:`flash_attention_lse_ref`. No gradient flows through it: under
    autograd it raises (use :func:`flash_attention` or
    :class:`FlashAttention`)."""
    return _forward(q, k, v, causal, window, k_len, bshd, lse=True, prefix_len=prefix_len)


def _forward(q, k, v, causal, window, k_len, bshd, *, lse, prefix_len=None):
    """One counted forward launch, or the plain version on the CPU; ``lse``:
    also the rows' statistics (serving asks for none, and the kernel then
    writes none)."""
    traffic.note_kernel("flash_attention")
    if build.device_type(q, k, v) == "cpu":
        if build.STAND_IN is not None:
            return build.STAND_IN.flash_attention(q, k, v, causal=causal, window=window,
                                                  k_len=k_len, bshd=bshd, lse=lse,
                                                  prefix_len=prefix_len)
        qt, kt, vt = _to_bhsd(bshd, q, k, v)
        o, stats = flash_attention_lse_ref(qt, kt, vt, causal=causal, window=window, k_len=k_len,
                                           prefix_len=prefix_len)
        o = o.transpose(1, 2) if bshd else o
        return (o, stats) if lse else o
    k_len = check_inputs(q, k, v, k_len, bshd=bshd, prefix_len=prefix_len)
    _check_first_launch(q.device, q.dtype, q.shape[-1], v.shape[-1])
    out = _launch(q, k, v, causal=causal, window=window, k_len=k_len, bshd=bshd, lse=lse,
                  prefix_len=prefix_len)
    build.count_launch(flash_attention_bhsd, "flash_attention")
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, k_len=None,
                        bshd=False, prefix_len=None):
    """The gradients (dq, dk, dv) of the attention output ``o`` for its
    gradient ``do``, from the forward's ``lse``; layouts as the forward's
    (``bshd``: the model's (B, S, heads, Dh)), each gradient in its input's
    dtype and shape; with ``causal``, keys below ``prefix_len`` are visible
    to every query. CUDA tensors launch the backward kernels
    (``flash_attention_bwd.launches`` counts each set: preprocess, dK/dV,
    dQ, and the head split's reduce where it runs), CPU tensors take
    :func:`flash_attention_bwd_ref`."""
    traffic.note_kernel("flash_attention_bwd")
    if build.device_type(q, k, v, o, lse, do) == "cpu":
        if build.STAND_IN is not None:
            return build.STAND_IN.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                      window=window, k_len=k_len, bshd=bshd,
                                                      prefix_len=prefix_len)
        qt, kt, vt, ot, dot = _to_bhsd(bshd, q, k, v, o, do)
        grads = flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, causal=causal, window=window,
                                        k_len=k_len, prefix_len=prefix_len)
        return _to_bhsd(bshd, *grads)
    k_len = check_inputs(q, k, v, k_len, bshd=bshd, prefix_len=prefix_len)
    _require_bwd_dims(q, v)
    out_shape = (*q.shape[:3], v.shape[3])  # q's, Dv wide
    if o.shape != out_shape or do.shape != out_shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must be {out_shape} {q.dtype}")
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not build.rows_16_byte_aligned(do)):
        do = do.contiguous()  # the bf16 kernels copy dO's rows in 16-byte pieces
    _check_first_bwd_launch(q.device, q.dtype, q.shape[-1], v.shape[-1])
    grads = _launch_bwd(q, k, v, o, lse, do, causal=causal, window=window, k_len=k_len,
                        bshd=bshd, prefix_len=prefix_len)
    build.count_launch(flash_attention_bwd, "flash_attention_bwd")
    return grads


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel writes the rows'
    ``lse`` beside the output, and the backward launches the backward
    kernels from q, k, v, o and lse (the plain versions on the CPU).
    ``apply(q, k, v, causal, window, k_len, bshd, prefix_len=None)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_len, bshd, prefix_len=None):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, k_len=k_len,
                                     bshd=bshd, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, k_len=k_len, bshd=bshd,
                        prefix_len=prefix_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def check_inputs(q, k, v, k_len=None, *, bshd=False, prefix_len=None) -> int:
    """What the kernel takes, checked on any device (the meta device
    included) before anything is launched: (B, H, Sq, Dqk) q, (B, KV, Sk,
    Dqk) k and (B, KV, Sk, Dv) v (or (B, S, heads, D) with ``bshd``) with H
    a multiple of KV, (Dqk, Dv) one of :data:`HEAD_DIM_PAIRS`, one dtype of
    float32 or bfloat16, a contiguous last dim and, for bfloat16, 16-byte
    aligned base addresses and strides, and ``prefix_len`` None or >= 0.
    Returns ``k_len`` (Sk if None); raises ``ValueError`` on anything
    else."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Dh = q.shape[0], q.shape[hd], q.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if (Dh, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (Dqk, Dv) = {(Dh, v.shape[3])} not in the kernel's "
                         f"{HEAD_DIM_PAIRS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of float32, bfloat16")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head_dim axis must be contiguous")
    if q.dtype == torch.bfloat16:
        build.require_16_byte_rows("flash_attention", q=q, k=k, v=v)
    k_len = Sk if k_len is None else int(k_len)
    if k_len < 0:
        raise ValueError(f"k_len must be >= 0, got {k_len}")
    if prefix_len is not None and int(prefix_len) < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    return k_len


def _require_bwd_dims(q, v) -> None:
    """The backward kernels take the (Dqk, Dv) pairs of
    :data:`BWD_HEAD_DIM_PAIRS`, with any of the forward's masks."""
    dims = (q.shape[-1], v.shape[-1])
    if dims not in BWD_HEAD_DIM_PAIRS:
        raise NotImplementedError(
            f"flash attention's backward kernel takes (Dqk, Dv) in {BWD_HEAD_DIM_PAIRS}; "
            f"(Dqk, Dv) = {dims} has no backward instantiation"
        )


def _launch(q, k, v, *, causal, window, k_len, bshd=False, lse=False, prefix_len=None):
    """One forward launch; with ``lse`` also returns the rows' statistics.
    Raises under autograd: its output carries no gradient."""
    if build.needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention's raw launch gives no gradient; under autograd call "
            "flash_attention / FlashAttention.apply"
        )
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Sq, Dh = q.shape[0], q.shape[hd], q.shape[sd], q.shape[3]
    KV, Sk, Dv = k.shape[hd], k.shape[sd], v.shape[3]
    # q's memory order where the head dims agree; else contiguous in q's
    # (B, H, Sq) or (B, S, heads) order
    o = torch.empty_like(q) if Dv == Dh else q.new_empty((*q.shape[:3], Dv))
    stats = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if lse else None
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODES[q.dtype],
        q.device.index, B, H, KV, Sq, Sk, Dh, Dv, *_bhs_strides(hd, sd, q, k, v, o),
        int(causal), 0 if window is None else int(window), k_len,
        0 if prefix_len is None else int(prefix_len), Dh**-0.5,
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed to launch: cudaError_t {err}")
    return (o, stats) if lse else o


def _bhs_strides(hd, sd, *tensors) -> list:
    """Each tensor's (batch, head, seq) strides, in elements."""
    out = []
    for t in tensors:
        st = t.stride()
        out += (st[0], st[hd], st[sd])
    return out


def _launch_bwd(q, k, v, o, lse, do, *, causal, window, k_len, bshd=False, prefix_len=None):
    """One set of the backward launches: preprocess, dK/dV, dQ, and in bf16
    at the wide pairs with a head split (:func:`bwd_head_split`) a reduce
    of the dK/dV partials, which go to a scratch allocated here."""
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Sq, Dh, Dv = q.shape[0], q.shape[hd], q.shape[sd], q.shape[3], v.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    lse = lse.float().contiguous()
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse of shape {tuple(lse.shape)}, want {(B, H, Sq)}")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_longlong * 24)(*_bhs_strides(hd, sd, q, k, v, o, do, dq, dk, dv))
    n_split, part = 1, None
    if q.dtype == torch.bfloat16 and (Dh, Dv) in WIDE_PAIRS:
        n_split = bwd_head_split(B, KV, -(-Sk // 64), H // KV, _sm_count(q.device))
        if n_split > 1:
            part = torch.empty(n_split * B * KV * Sk * (Dh + Dv), dtype=torch.float32,
                               device=q.device)
    err = _kernel_fn("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODES[q.dtype], q.device.index, B, H, KV, Sq, Sk, Dh, Dv, strides,
        int(causal), 0 if window is None else int(window), k_len,
        0 if prefix_len is None else int(prefix_len), Dh**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream, n_split,
        None if part is None else part.data_ptr(),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd failed to launch: cudaError_t {err}")
    return dq, dk, dv


def _guard_inputs(device, dtype, Dh, Dv=None):
    """The first-launch checks' small input: causal GQA, two key tiles, the
    second ragged."""
    g = torch.Generator(device=device).manual_seed(0)
    shapes = [(1, 2, 100, Dh), (1, 1, 100, Dh), (1, 1, 100, Dh if Dv is None else Dv)]
    return [torch.randn(s, generator=g, device=device).to(dtype) for s in shapes]


def _check_first_launch(device: torch.device, dtype: torch.dtype, Dh: int,
                        Dv: Optional[int] = None) -> None:
    """Before the first launch of an instantiation (Dqk = ``Dh``, Dv, Dh if
    None) in this process, launch it on a small causal GQA input and hold
    the result (max abs error) against the plain version; raise if they
    disagree."""
    Dv = Dh if Dv is None else Dv

    def case():
        q, k, v = _guard_inputs(device, dtype, Dh, Dv)

        def launch():
            with torch.no_grad():
                return _launch(q, k, v, causal=True, window=None, k_len=q.shape[2])

        return launch, flash_attention_ref(q, k, v, causal=True)

    _guard.check((device.index, dtype, Dh, Dv), case)


def _check_first_bwd_launch(device: torch.device, dtype: torch.dtype, Dh: int,
                            Dv: Optional[int] = None) -> None:
    """The same for the backward: the forward kernel's o and lse and a random
    dO go through the backward kernels and its plain version; each
    gradient's error is scaled by its largest value."""
    Dv = Dh if Dv is None else Dv

    def case():
        q, k, v = _guard_inputs(device, dtype, Dh, Dv)
        with torch.no_grad():
            o, lse = _launch(q, k, v, causal=True, window=None, k_len=q.shape[2], lse=True)
        do = torch.randn(o.shape, generator=torch.Generator(device=device).manual_seed(1),
                         device=device).to(dtype)
        args = (q, k, v, o, lse, do)

        def launch():
            return _launch_bwd(*args, causal=True, window=None, k_len=q.shape[2])

        return launch, flash_attention_bwd_ref(*args, causal=True)

    _bwd_guard.check((device.index, dtype, Dh, Dv), case)


flash_attention_bhsd.launches = 0
flash_attention_bwd.launches = 0
