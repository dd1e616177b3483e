"""Flash attention forward: the hand-written sm_90a kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
model-layout wrapper.

Replaces the reference's Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_kernel`` / ``flash_attention_bhsd``) and its layout wrapper
``repro/kernels/ops.py::flash_attention``; ``attention_ref`` ports
``repro/kernels/ref.py``.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain version. There is no
fallback from one to the other. On the card, bfloat16 (the served path)
runs on the tensor cores and float32 (the parity path) on FMA tiles:
:func:`design`.

The first launch of each kernel instantiation (device, dtype, head_dim) in
a process is preceded by a check launch on a small input, held against the
plain version by :class:`~repro_torch.kernels.build.FirstLaunchGuard`; a
disagreement raises.
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
_fn = None
# keyed by (device index, dtype, head_dim)
_guard = build.FirstLaunchGuard(
    "flash_attention", lambda got, want: (got.float() - want.float()).abs().max().item()
)


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = build.library("flash_attention").flash_attention_fwd
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = (
                [ptr] * 4 + [i32] * 8 + [i64] * 12 + [i32] * 3 + [ctypes.c_float, ptr]
            )
            fn.restype = i32
            _fn = fn
        return _fn


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
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, Dh).float() * Dh**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    s = torch.where(_mask(Sq, Sk, causal, window, k_len, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / denom
    return o.reshape(B, H, Sq, Dh).to(q.dtype)


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
    q's memory order. CPU tensors take :func:`flash_attention_ref`.
    ``flash_attention_bhsd.launches`` counts kernel launches through this
    function and :func:`flash_attention` (the first-launch check's are not
    counted).
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


def _attention(q, k, v, causal, window, k_len, *, bshd):
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        if bshd:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        o = flash_attention_ref(q, k, v, causal=causal, window=window, k_len=k_len)
        return o.transpose(1, 2) if bshd else o
    if devices != {"cuda"} or len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"q, k, v must share one CUDA device (or all be on the CPU): {devices}")
    k_len = check_inputs(q, k, v, k_len, bshd=bshd)
    _check_first_launch(q.device, q.dtype, q.shape[-1])
    o = _launch(q, k, v, causal=causal, window=window, k_len=k_len, bshd=bshd)
    with _count_lock:
        flash_attention_bhsd.launches += 1
    return o


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


def _launch(q, k, v, *, causal, window, k_len, bshd=False) -> torch.Tensor:
    hd, sd = (2, 1) if bshd else (1, 2)
    B, H, Sq, Dh = q.shape[0], q.shape[hd], q.shape[sd], q.shape[3]
    KV, Sk = k.shape[hd], k.shape[sd]
    o = torch.empty_like(q)
    strides = []
    for t in (q, k, v, o):  # (batch, head, seq) strides
        st = t.stride()
        strides += (st[0], st[hd], st[sd])
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODES[q.dtype],
        q.device.index, B, H, KV, Sq, Sk, Dh, *strides,
        int(causal), 0 if window is None else int(window), k_len, Dh**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd failed to launch: cudaError_t {err}")
    return o


def _check_first_launch(device: torch.device, dtype: torch.dtype, Dh: int) -> None:
    """Before the first launch of an instantiation in this process, launch it
    on a small causal GQA input (two key tiles, the second ragged) and hold
    the result (max abs error) against the plain version; raise if they
    disagree."""

    def case():
        g = torch.Generator(device=device).manual_seed(0)
        shapes = [(1, 2, 100, Dh), (1, 1, 100, Dh), (1, 1, 100, Dh)]
        q, k, v = (torch.randn(s, generator=g, device=device).to(dtype) for s in shapes)

        def launch():
            return _launch(q, k, v, causal=True, window=None, k_len=q.shape[2])

        return launch, flash_attention_ref(q, k, v, causal=True)

    _guard.check((device.index, dtype, Dh), case)


flash_attention_bhsd.launches = 0
