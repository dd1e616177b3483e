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
fallback from one to the other. On the card, the forward in bfloat16 (the
served path) runs on the tensor cores and in float32 (the parity path) on
FMA tiles (:func:`design`); the backward runs on FMA tiles in both.

Under autograd (grad enabled and an input requiring grad) the wrappers go
through :class:`FlashAttention`, whose backward launches the backward
kernels; the raw forward launch refuses to run there, so no caller gets an
output without a gradient.

The first launch of each kernel instantiation (device, dtype, head_dim,
and forward or backward) in a process is preceded by a check launch on a
small input, held against the plain version by
:class:`~repro_torch.kernels.build.FirstLaunchGuard`; a disagreement raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def design(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel design a launch of this dtype and head dim runs, as
    ``csrc/flash_attention.cu`` names them."""
    if dtype == torch.float32:
        return "fma-f32"
    return "wgmma" if head_dim == 64 else "mma.sync"


_fn_lock = threading.Lock()
_count_lock = threading.Lock()
_fns: dict = {}
# keyed by (device index, dtype, head_dim)
_guard = build.FirstLaunchGuard(
    "flash_attention", lambda got, want: (got.float() - want.float()).abs().max().item()
)


def _scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|): gradients grow with the
    sequence, so their error is read against their size."""
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


# keyed by (device index, dtype, head_dim); the error of each gradient is scaled
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
                    [ptr] * 4 + [i32] * 8 + [i64] * 12 + [i32] * 3 + [ctypes.c_float, ptr, ptr]
                )
            else:
                fn = build.library("flash_attention_bwd").flash_attention_bwd
                fn.argtypes = [ptr] * 10 + [i32] * 8 + [ptr] + [i32] * 3 + [ctypes.c_float, ptr]
            fn.restype = i32
            _fns[name] = fn
        return fn


def _mask(Sq: int, Sk: int, causal: bool, window, k_len, device) -> torch.Tensor:
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = k_pos < (Sk if k_len is None else k_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, Dh)
    k: torch.Tensor,  # (B, KV, Sk, Dh)
    v: torch.Tensor,  # (B, KV, Sk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, to the kernel's semantics: f32
    scores of the pre-scaled q, finite ``-1e30`` for masked keys, causal
    aligned top-left (positions from 0), the denominator floored at 1e-30,
    output cast to the input dtype."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window, k_len=k_len)[0]


def flash_attention_lse_ref(q, k, v, *, causal=True, window=None, k_len=None):
    """:func:`flash_attention_ref` and the rows' f32 statistics ``lse = m +
    log(max(l, 1e-30))`` (B, H, Sq), natural log, as the kernel writes them
    for the backward."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, Dh).float() * Dh**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    s = torch.where(_mask(Sq, Sk, causal, window, k_len, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / denom
    lse = (m + torch.log(denom)).reshape(B, H, Sq)
    return o.reshape(B, H, Sq, Dh).to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, H, Sq, Dh)
    k: torch.Tensor,  # (B, KV, Sk, Dh)
    v: torch.Tensor,  # (B, KV, Sk, Dh)
    o: torch.Tensor,  # (B, H, Sq, Dh), the forward's output
    lse: torch.Tensor,  # (B, H, Sq) f32, the forward's row statistics
    do: torch.Tensor,  # (B, H, Sq, Dh), the output's gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
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
        return t.reshape(B, KV, G, Sq, Dh).float()

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg * scale, kf)
    lse_g = lse.reshape(B, KV, G, Sq, 1).float()
    mask = _mask(Sq, Sk, causal, window, k_len, q.device)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    return dq.reshape(B, H, Sq, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, Dh)
    k: torch.Tensor,  # (B, KV, Sk, Dh)
    v: torch.Tensor,  # (B, KV, Sk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
) -> torch.Tensor:
    """Dense f32 softmax attention with GQA head grouping (the reference's
    ``kernels/ref.py::attention_ref``)."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, Dh).float() * Dh**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    s = torch.where(_mask(Sq, Sk, causal, window, k_len, q.device), s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, Sq, Dh).to(q.dtype)


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, Dh)
    k: torch.Tensor,  # (B, KV, Sk, Dh)
    v: torch.Tensor,  # (B, KV, Sk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention in layout (batch, heads, seq, head_dim).

    CUDA tensors launch the kernel: any stride is taken as long as the last
    dim is contiguous (and, in bfloat16, every other stride and the base
    address are 16-byte aligned: :func:`check_inputs`), and the output has
    q's memory order. CPU tensors take :func:`flash_attention_ref`. Under
    autograd the call goes through :class:`FlashAttention`.
    ``flash_attention_bhsd.launches`` counts forward kernel launches through
    this function and :func:`flash_attention` (the first-launch checks' are
    not counted).
    """
    return _attention(q, k, v, causal, window, k_len, bshd=False)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, Dh) — model layout
    k: torch.Tensor,  # (B, Sk, KV, Dh)
    v: torch.Tensor,  # (B, Sk, KV, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_len: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention_bhsd` in the model's layout: the kernel reads
    (B, S, H, Dh) through its strides, and the output comes back as (B, Sq,
    H, Dh)."""
    return _attention(q, k, v, causal, window, k_len, bshd=True)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _devices(*tensors) -> str:
    """"cpu" or "cuda" for tensors that share one device; raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return "cpu"
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs must share one CUDA device (or all be on the CPU): {devices}")
    return "cuda"


def _to_bhsd(bshd, *tensors):
    return tuple(t.transpose(1, 2) for t in tensors) if bshd else tensors


def _attention(q, k, v, causal, window, k_len, *, bshd):
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, k_len, bshd)
    return _forward(q, k, v, causal, window, k_len, bshd, lse=False)


def flash_attention_lse(q, k, v, *, causal=True, window=None, k_len=None, bshd=False):
    """The forward and its rows' f32 statistics ``lse`` (B, H, Sq), which
    the backward takes. CUDA tensors launch the kernel (counted in
    ``flash_attention_bhsd.launches``), CPU tensors take
    :func:`flash_attention_lse_ref`. No gradient flows through it: under
    autograd it raises (use :func:`flash_attention` or
    :class:`FlashAttention`)."""
    return _forward(q, k, v, causal, window, k_len, bshd, lse=True)


def _forward(q, k, v, causal, window, k_len, bshd, *, lse):
    """One counted forward launch, or the plain version on the CPU; ``lse``:
    also the rows' statistics (serving asks for none, and the kernel then
    writes none)."""
    if _devices(q, k, v) == "cpu":
        qt, kt, vt = _to_bhsd(bshd, q, k, v)
        o, stats = flash_attention_lse_ref(qt, kt, vt, causal=causal, window=window, k_len=k_len)
        o = o.transpose(1, 2) if bshd else o
        return (o, stats) if lse else o
    k_len = check_inputs(q, k, v, k_len, bshd=bshd)
    _check_first_launch(q.device, q.dtype, q.shape[-1])
    out = _launch(q, k, v, causal=causal, window=window, k_len=k_len, bshd=bshd, lse=lse)
    with _count_lock:
        flash_attention_bhsd.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None, k_len=None,
                        bshd=False):
    """The gradients (dq, dk, dv) of the attention output ``o`` for its
    gradient ``do``, from the forward's ``lse``; layouts as the forward's
    (``bshd``: the model's (B, S, heads, Dh)), each gradient in its input's
    dtype and shape. CUDA tensors launch the three backward kernels
    (``flash_attention_bwd.launches`` counts each set of three), CPU tensors
    take :func:`flash_attention_bwd_ref`."""
    if _devices(q, k, v, o, lse, do) == "cpu":
        qt, kt, vt, ot, dot = _to_bhsd(bshd, q, k, v, o, do)
        grads = flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, causal=causal, window=window,
                                        k_len=k_len)
        return _to_bhsd(bshd, *grads)
    k_len = check_inputs(q, k, v, k_len, bshd=bshd)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    do = do if do.stride(-1) == 1 else do.contiguous()
    _check_first_bwd_launch(q.device, q.dtype, q.shape[-1])
    grads = _launch_bwd(q, k, v, o, lse, do, causal=causal, window=window, k_len=k_len,
                        bshd=bshd)
    with _count_lock:
        flash_attention_bwd.launches += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel writes the rows'
    ``lse`` beside the output, and the backward launches the backward
    kernels from q, k, v, o and lse (the plain versions on the CPU).
    ``apply(q, k, v, causal, window, k_len, bshd)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_len, bshd):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window, k_len=k_len,
                                     bshd=bshd)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, k_len=k_len, bshd=bshd)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def check_inputs(q, k, v, k_len=None, *, bshd=False) -> int:
    """What the kernel takes, checked on any device (the meta device
    included) before anything is launched: (B, H, Sq, Dh) q and (B, KV, Sk,
    Dh) k and v (or (B, S, heads, Dh) with ``bshd``) with H a multiple of
    KV, Dh one of :data:`HEAD_DIMS`, one dtype of float32 or bfloat16, a
    contiguous last dim and, for bfloat16, 16-byte aligned base addresses
    and strides. Returns ``k_len`` (Sk if None); raises ``ValueError`` on
    anything else."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Dh = q.shape[0], q.shape[hd], q.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    if k.shape[0] != B or k.shape[3] != Dh or KV < 1 or H % KV:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in the kernel's {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of float32, bfloat16")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head_dim axis must be contiguous")
    if q.dtype == torch.bfloat16:
        build.require_16_byte_rows("flash_attention", q=q, k=k, v=v)
    k_len = Sk if k_len is None else int(k_len)
    if k_len < 0:
        raise ValueError(f"k_len must be >= 0, got {k_len}")
    return k_len


def _launch(q, k, v, *, causal, window, k_len, bshd=False, lse=False):
    """One forward launch; with ``lse`` also returns the rows' statistics.
    Raises under autograd: its output carries no gradient."""
    if _needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention's raw launch gives no gradient; under autograd call "
            "flash_attention / FlashAttention.apply"
        )
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Sq, Dh = q.shape[0], q.shape[hd], q.shape[sd], q.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    o = torch.empty_like(q)
    stats = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if lse else None
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODES[q.dtype],
        q.device.index, B, H, KV, Sq, Sk, Dh, *_bhs_strides(hd, sd, q, k, v, o),
        int(causal), 0 if window is None else int(window), k_len, Dh**-0.5,
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


def _launch_bwd(q, k, v, o, lse, do, *, causal, window, k_len, bshd=False):
    """One set of the three backward launches (preprocess, dK/dV, dQ)."""
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Sq, Dh = q.shape[0], q.shape[hd], q.shape[sd], q.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    lse = lse.float().contiguous()
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse of shape {tuple(lse.shape)}, want {(B, H, Sq)}")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_longlong * 24)(*_bhs_strides(hd, sd, q, k, v, o, do, dq, dk, dv))
    err = _kernel_fn("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODES[q.dtype], q.device.index, B, H, KV, Sq, Sk, Dh, strides,
        int(causal), 0 if window is None else int(window), k_len, Dh**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd failed to launch: cudaError_t {err}")
    return dq, dk, dv


def _guard_inputs(device, dtype, Dh):
    """The first-launch checks' small input: causal GQA, two key tiles, the
    second ragged."""
    g = torch.Generator(device=device).manual_seed(0)
    shapes = [(1, 2, 100, Dh), (1, 1, 100, Dh), (1, 1, 100, Dh)]
    return [torch.randn(s, generator=g, device=device).to(dtype) for s in shapes]


def _check_first_launch(device: torch.device, dtype: torch.dtype, Dh: int) -> None:
    """Before the first launch of an instantiation in this process, launch it
    on a small causal GQA input and hold the result (max abs error) against
    the plain version; raise if they disagree."""

    def case():
        q, k, v = _guard_inputs(device, dtype, Dh)

        def launch():
            with torch.no_grad():
                return _launch(q, k, v, causal=True, window=None, k_len=q.shape[2])

        return launch, flash_attention_ref(q, k, v, causal=True)

    _guard.check((device.index, dtype, Dh), case)


def _check_first_bwd_launch(device: torch.device, dtype: torch.dtype, Dh: int) -> None:
    """The same for the backward: the forward kernel's o and lse and a random
    dO go through the backward kernels and its plain version; each
    gradient's error is scaled by its largest value."""

    def case():
        q, k, v = _guard_inputs(device, dtype, Dh)
        with torch.no_grad():
            o, lse = _launch(q, k, v, causal=True, window=None, k_len=q.shape[2], lse=True)
        do = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(1),
                         device=device).to(dtype)
        args = (q, k, v, o, lse, do)

        def launch():
            return _launch_bwd(*args, causal=True, window=None, k_len=q.shape[2])

        return launch, flash_attention_bwd_ref(*args, causal=True)

    _bwd_guard.check((device.index, dtype, Dh), case)


flash_attention_bhsd.launches = 0
flash_attention_bwd.launches = 0
