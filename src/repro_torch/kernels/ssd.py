"""Mamba2 SSD chunked scan: the hand-written sm_90a kernel
(``csrc/ssd.cu``), its plain PyTorch version, and the recurrent decode step.

Replaces the reference's Pallas TPU kernel ``repro/kernels/ssd.py``
(``_kernel`` / ``ssd_bshp``); ``ssd_ref`` ports the oracle
``repro/models/ssm.py::ssd_reference`` and ``ssd_decode_step`` its
single-token step.

The kernel computes what the oracle computes with ``return_final_state``:
y and the f32 state after the last real position. The TPU kernel keeps its
state in scratch and never writes it out, so the reference's prefill takes
the oracle; the port's prefill takes this kernel.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain version. There is no
fallback from one to the other. On the card, bfloat16 (the served path)
runs three chunk-parallel launches on the tensor cores, with f32 scratch
from ``torch.empty``, and float32 (the parity path) one FMA launch that
walks the chunks: :data:`DESIGNS`. As for flash attention, the first launch of
each instantiation (device, dtype) in a process is preceded by a check
launch on a small ragged input, held against the plain version; a
disagreement raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128  # the kernel keeps N <= 128 state columns per thread row
MAX_CHUNK = 1024  # the chunk's decay prefix sum lives in shared memory
# the kernel's design for each dtype, as csrc/ssd.cu names it
DESIGNS = {torch.bfloat16: "mma.sync", torch.float32: "fma-f32"}

_fn_lock = threading.Lock()
_count_lock = threading.Lock()
_fn = None


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = build.library("ssd").ssd_fwd
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [ptr] * 8 + [i32] * 8 + [i64] * 13 + [ptr]
            fn.restype = i32
            _fn = fn
        return _fn


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]."""
    cl = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32, post-softplus
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    return_final_state: bool = False,
):
    """Chunked SSD scan in plain PyTorch (the reference's ``ssd_reference``).

    A ragged last chunk is padded with dt = 0 steps: exp(0) = 1 keeps the
    state and 0 * x adds nothing. The scan over chunks is a Python loop.
    """
    Bb, S, H, Pd = x.shape
    N = Bm.shape[-1]
    cl = min(chunk, S)
    S_orig = S
    if S % cl:
        pad = cl - S % cl
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // cl

    xf = x.float()
    dt = dt.float()
    dA = dt * A.float()  # (B, S, H)
    xr = xf.reshape(Bb, nc, cl, H, Pd)
    dtr = dt.reshape(Bb, nc, cl, H)
    dAr = dA.reshape(Bb, nc, cl, H).transpose(2, 3)  # (B, nc, H, cl)
    Br = Bm.float().reshape(Bb, nc, cl, N)
    Cr = Cm.float().reshape(Bb, nc, cl, N)

    # intra-chunk quadratic term
    L = torch.exp(_segsum(dAr))  # (B, nc, H, cl, cl)
    scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    M = scores[:, :, None] * L
    xdt = xr * dtr[..., None]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

    # chunk-final states: sum_j exp(sum_{j<k<=end} dA) B_j (dt_j x_j)
    dA_cum = torch.cumsum(dAr, dim=-1)  # (B, nc, H, cl)
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)
    states = torch.einsum("bchj,bcjn,bcjhp->bchpn", decay_to_end, Br, xdt)

    # inter-chunk recurrence, in order over the chunks
    chunk_decay = torch.exp(dA_cum[..., -1])  # (B, nc, H)
    state = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    )
    prev = []
    for c in range(nc):
        prev.append(state)  # the state entering chunk c
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: C_i . (decay into the chunk) state_prev
    in_decay = torch.exp(dA_cum)
    y_inter = torch.einsum("bcin,bchpn,bchi->bcihp", Cr, prev_states, in_decay)

    y = (y_intra + y_inter).reshape(Bb, S, H, Pd)[:, :S_orig].to(x.dtype)
    if return_final_state:
        return y, state
    return y


def ssd_decode_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H) f32
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    state: torch.Tensor,  # (B, H, P, N) f32
):
    """Single-token recurrent update (O(1) in sequence length). Returns
    ``(y, new_state)``; the state passed in is not modified."""
    dA = torch.exp(dt * A)  # (B, H)
    xdt = x.float() * dt[..., None]
    new_state = state * dA[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", Bm.float(), xdt
    )
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def ssd_bshp(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    return_final_state: bool = False,
):
    """The SSD scan in layout (batch, seq, heads, head_dim), from a zero state.

    CUDA tensors launch the kernel: x, B and C in float32 or bfloat16 with
    a contiguous last dim (any other strides; in bfloat16, 16-byte aligned
    ones: :func:`check_inputs`), y comes back contiguous in
    x's dtype and the final state ``(B, H, P, N)`` in float32. Any S is
    taken: a ragged last chunk is masked, not padded. CPU tensors take
    :func:`ssd_ref`. ``ssd_bshp.launches`` counts kernel launches (the
    first-launch check's are not counted).
    """
    tensors = (x, dt, A, Bm, Cm)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=return_final_state)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"x, dt, A, B, C must share one CUDA device (or all be on the CPU): {devices}")
    cl = check_inputs(x, dt, A, Bm, Cm, chunk)
    _check_first_launch(x.device, x.dtype)
    y, final = _launch(x, dt, A, Bm, Cm, chunk=cl)
    with _count_lock:
        ssd_bshp.launches += 1
    return (y, final) if return_final_state else y


def check_inputs(x, dt, A, Bm, Cm, chunk) -> int:
    """What the kernel takes, checked on any device (the meta device
    included) before anything is launched: x (B, S, H, P), dt (B, S, H), A
    (H,), B and C (B, S, N) with 1 <= N <= :data:`MAX_STATE`, x, B and C in
    one dtype of float32 or bfloat16 with a contiguous last dim and, for
    bfloat16, P and N multiples of 8 and 16-byte aligned base addresses and
    strides. Returns the chunk length ``min(chunk, S)``; raises
    ``ValueError`` on anything else."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3 or Bm.shape != Cm.shape:
        raise ValueError(
            f"bad shapes x={tuple(x.shape)} dt={tuple(dt.shape)} A={tuple(A.shape)} "
            f"B={tuple(Bm.shape)} C={tuple(Cm.shape)}"
        )
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"bad shapes x={tuple(x.shape)} dt={tuple(dt.shape)} B={tuple(Bm.shape)}")
    if min(B, S, H, P, N) < 1 or N > MAX_STATE:
        raise ValueError(f"state size N={N} must be in [1, {MAX_STATE}] and every dim >= 1")
    cl = min(int(chunk), S)
    if not 1 <= cl <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: need one of float32, bfloat16")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the last dims of x, B and C must be contiguous")
    if x.dtype == torch.bfloat16:
        if P % 8 or N % 8:
            raise ValueError(f"bfloat16 takes P and N in multiples of 8, got P={P} N={N}")
        build.require_16_byte_rows("ssd", x=x, B=Bm, C=Cm)
    return cl


def _launch(x, dt, A, Bm, Cm, *, chunk):
    """``chunk`` is the chunk length as :func:`check_inputs` returns it.
    Raises under autograd: the kernel has no backward yet, and its output
    would carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise RuntimeError(
            "ssd's kernel has no backward yet: its output would carry no gradient"
        )
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    cl = chunk
    dt = dt.float()
    A = A.float().contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scratch = None
    if x.dtype == torch.bfloat16:  # each chunk's (P, N) state and its sum of dA
        nc = -(-S // cl)
        scratch = torch.empty(B * nc * H * (P * N + 1), dtype=torch.float32, device=x.device)
    err = _kernel_fn()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), final.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODES[x.dtype], x.device.index, B, S, H, P, N, cl,
        *x.stride()[:3], *dt.stride(), Bm.stride(0), Bm.stride(1),
        Cm.stride(0), Cm.stride(1), *y.stride()[:3],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_fwd failed to launch: cudaError_t {err}")
    return y, final


def scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|): the scan's outputs grow with
    N and the chunk length, so an absolute tolerance would not carry from
    one shape to the next; one bf16 rounding of y stays below 2^-8 here."""
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    return (got.float() - want).abs().max().item() / scale


_guard = build.FirstLaunchGuard("ssd", scaled_error)  # keyed by (device index, dtype)


def _check_first_launch(device: torch.device, dtype: torch.dtype) -> None:
    """Before the first launch of an instantiation in this process, launch it
    on a small input with a ragged last chunk and hold y and the final state
    (scaled error) against the plain version; raise if they disagree."""

    def case():
        g = torch.Generator(device=device).manual_seed(0)
        B, S, H, P, N, chunk = 1, 100, 3, 16, 16, 64

        def randn(*shape):
            return torch.randn(shape, generator=g, device=device)

        x, Bm, Cm = (randn(*s).to(dtype) for s in [(B, S, H, P), (B, S, N), (B, S, N)])
        dt = F.softplus(randn(B, S, H))
        A = -torch.exp(torch.rand((H,), generator=g, device=device))

        def launch():
            return _launch(x, dt, A, Bm, Cm, chunk=chunk)

        return launch, ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)

    _guard.check((device.index, dtype), case)


ssd_bshp.launches = 0
