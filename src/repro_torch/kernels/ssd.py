"""Mamba2 SSD chunked scan: the hand-written sm_90a kernels (forward
``csrc/ssd.cu``, backward ``csrc/ssd_bwd.cu``), their plain PyTorch
versions, the autograd Function and the recurrent decode step.

Replaces the reference's Pallas TPU kernel ``repro/kernels/ssd.py``
(``_kernel`` / ``ssd_bshp``); ``ssd_ref`` ports the oracle
``repro/models/ssm.py::ssd_reference`` and ``ssd_decode_step`` its
single-token step.

The kernel computes what the oracle computes with ``return_final_state``:
y and the f32 state after the last real position. The TPU kernel keeps its
state in scratch and never writes it out, so the reference's prefill takes
the oracle; the port's prefill takes this kernel.

The backward (:func:`ssd_bwd`, plain version :func:`ssd_bwd_ref`) has no
Pallas counterpart: the reference trains through XLA's autodiff of the
oracle. It gives dx, ddt, dA, dB and dC from the inputs, the output's
gradient and (optionally) the final state's, recomputing the chunk states.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernels (or raise), CPU tensors take the plain versions. There is no
fallback from one to the other. On the card, bfloat16 (the served and
trained path) runs three chunk-parallel forward launches on the tensor
cores, with f32 scratch from ``torch.empty``, and float32 (the parity path)
one FMA launch that walks the chunks: :data:`DESIGNS`. The backward's
bfloat16 form runs its products on the tensor cores, each f32 operand split
into bf16 hi + lo parts, with C·Bᵀ formed once per chunk and the scores
summed over the heads before their N-wide products; its float32 form runs
FMA tiles (:data:`DESIGN_BWD`). Under autograd
(grad enabled and an input requiring grad) :func:`ssd_bshp` goes through
:class:`SSD`, whose backward launches the backward kernels; the raw
forward launch refuses to run there. As for flash attention, the first
launch of each instantiation (device, dtype, forward or backward) in a
process is preceded by a check launch on a small ragged input, held
against the plain version; a disagreement raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..analysis import traffic
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128  # the kernel keeps N <= 128 state columns per thread row
MAX_CHUNK = 1024  # the chunk's decay prefix sum lives in shared memory
MAX_HEAD_BWD = 64  # the backward keeps a head's P columns in one 64-wide tile
# the kernel's design for each dtype, as csrc/ssd.cu names it
DESIGNS = {torch.bfloat16: "mma.sync", torch.float32: "fma-f32"}
# the backward's, as csrc/ssd_bwd.cu names it: bf16 on mma.sync with the f32
# operands split into bf16 hi + lo parts, f32 on FMA tiles
DESIGN_BWD = {torch.bfloat16: "mma.sync-split", torch.float32: "fma-f32"}

_fn_lock = threading.Lock()
_fns: dict = {}


def _kernel_fn(name: str = "ssd_fwd"):
    """The C entry ``ssd_fwd`` (library ``ssd``), or ``ssd_bwd`` or
    ``ssd_bwd_scratch_floats`` (library ``ssd_bwd``), loaded and typed once."""
    with _fn_lock:
        fn = _fns.get(name)
        if fn is None:
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            if name == "ssd_fwd":
                fn = build.library("ssd").ssd_fwd
                fn.argtypes = [ptr] * 8 + [i32] * 8 + [i64] * 13 + [ptr]
                fn.restype = i32
            elif name == "ssd_bwd":
                fn = build.library("ssd_bwd").ssd_bwd
                fn.argtypes = [ptr] * 13 + [i32] * 8 + [i64] * 13 + [ptr]
                fn.restype = i32
            else:
                fn = build.library("ssd_bwd").ssd_bwd_scratch_floats
                fn.argtypes = [i32] * 7
                fn.restype = i64
            _fns[name] = fn
        return fn


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


def ssd_bwd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    dy: torch.Tensor,  # (B, S, H, P), the output's gradient
    dfinal: Optional[torch.Tensor] = None,  # (B, H, P, N), the final state's
    *,
    chunk: int = 64,
):
    """Plain PyTorch version of the backward kernels, by their formulas, in
    f32, from a zero initial state: the gradients (dx, ddt, dA, dB, dC) of
    :func:`ssd_ref`'s y and final state for ``dy`` and ``dfinal`` (None:
    zero), each in its input's dtype.

    Per chunk, with a_t = dt_t A, Λ the inclusive prefix sum of a in the
    chunk (L its last row), u_j = dt_j x_j, h the state entering the chunk
    and g the gradient of the state leaving it:

    * the states h entering each chunk, by the forward's pass in order, and
      g by the reverse pass g_{c-1} = e^{Λ_L} g_c + Σ_i e^{Λ_i} dy_i C_iᵀ;
    * du_j = Σ_{i≥j} (C_i·B_j) e^{Λ_i-Λ_j} dy_i + e^{Λ_L-Λ_j} g B_j,
      dx = dt du, and ddt gets x·du;
    * per head, dC_i = Σ_{j≤i} e^{Λ_i-Λ_j} (dy_i·u_j) B_j + e^{Λ_i} hᵀ dy_i
      and dB_j = Σ_{i≥j} e^{Λ_i-Λ_j} (dy_i·u_j) C_i + e^{Λ_L-Λ_j} gᵀ u_j,
      summed over the heads (B and C are shared by them);
    * the gradient of Λ_t is C_t·dC_t (that head's part) - u_t·du_t, plus
      ⟨g, state leaving the chunk⟩ at t = L; a's is its reverse prefix sum
      in the chunk, which adds A da to ddt and gives dA = Σ dt da.

    A ragged last chunk is padded with dt = 0 steps, as in :func:`ssd_ref`.
    """
    Bb, S, H, Pd = x.shape
    N = Bm.shape[-1]
    cl = min(chunk, S)
    S_orig = S
    pad = (-S) % cl
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        S = S + pad
    nc = S // cl

    Af = A.float()
    xr = x.float().reshape(Bb, nc, cl, H, Pd)
    dyr = dy.float().reshape(Bb, nc, cl, H, Pd)
    dtr = dt.float().reshape(Bb, nc, cl, H)
    Br = Bm.float().reshape(Bb, nc, cl, N)
    Cr = Cm.float().reshape(Bb, nc, cl, N)
    a = (dtr * Af).transpose(2, 3)  # (B, nc, H, cl)
    cum = torch.cumsum(a, dim=-1)  # Λ
    decay = torch.exp(_segsum(a))  # (B, nc, H, i, j): e^{Λ_i - Λ_j} for j <= i, else 0
    to_end = torch.exp(cum[..., -1:] - cum)  # e^{Λ_L - Λ_j}
    from_start = torch.exp(cum)  # e^{Λ_i}
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, H)
    u = xr * dtr[..., None]  # (B, nc, cl, H, P)

    # the states entering and leaving each chunk, in order over the chunks
    local = torch.einsum("bchj,bcjn,bcjhp->bchpn", to_end, Br, u)
    state = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + local[:, c]
    h_in = torch.stack(entering, dim=1)  # (B, nc, H, P, N)
    h_out = torch.cat([h_in[:, 1:], state[:, None]], dim=1)

    # the reverse pass: g[c], the gradient of the state leaving chunk c
    g_local = torch.einsum("bchi,bcihp,bcin->bchpn", from_start, dyr, Cr)
    grad = (
        dfinal.float()
        if dfinal is not None
        else torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    )
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = grad
        grad = grad * chunk_decay[:, c, :, None, None] + g_local[:, c]
    g = torch.stack(leaving, dim=1)  # (B, nc, H, P, N)

    # chunk-local products
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)[:, :, None] * decay  # (B, nc, H, i, j)
    du_y = torch.einsum("bcihp,bcjhp->bchij", dyr, u) * decay
    du = torch.einsum("bchij,bcihp->bcjhp", cb, dyr) + torch.einsum(
        "bchj,bchpn,bcjn->bcjhp", to_end, g, Br
    )
    dC_h = torch.einsum("bchij,bcjn->bcihn", du_y, Br) + torch.einsum(
        "bchi,bcihp,bchpn->bcihn", from_start, dyr, h_in
    )
    dB_h = torch.einsum("bchij,bcin->bcjhn", du_y, Cr) + torch.einsum(
        "bchj,bchpn,bcjhp->bcjhn", to_end, g, u
    )
    xdu = (xr * du).sum(-1)  # (B, nc, cl, H)
    dlam = (Cr[:, :, :, None] * dC_h).sum(-1) - dtr * xdu
    last = torch.zeros_like(dlam)
    last[:, :, -1] = (g * h_out).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dlam + last, [2]), dim=2), [2])
    ddt = xdu + Af * da
    dA = (dtr * da).sum((0, 1, 2))
    dx = du * dtr[..., None]

    def seq(t, *tail):
        return t.reshape(Bb, S, *tail)[:, :S_orig]

    return (
        seq(dx, H, Pd).to(x.dtype),
        seq(ddt, H).to(dt.dtype),
        dA.to(A.dtype),
        seq(dB_h.sum(3), N).to(Bm.dtype),
        seq(dC_h.sum(3), N).to(Cm.dtype),
    )


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
    :func:`ssd_ref`. Under autograd the call goes through :class:`SSD`.
    ``ssd_bshp.launches`` counts forward kernel launches (the first-launch
    check's are not counted, nor a launch into a CUDA graph being captured:
    :func:`~repro_torch.kernels.build.count_launch`).
    """
    if build.needs_grad(x, dt, A, Bm, Cm):
        y, final = SSD.apply(x, dt, A, Bm, Cm, chunk)
    else:
        y, final = _forward(x, dt, A, Bm, Cm, chunk)
    return (y, final) if return_final_state else y


def _forward(x, dt, A, Bm, Cm, chunk):
    """(y, final state): one counted launch, or the plain version on the CPU."""
    traffic.note_kernel("ssd")
    if build.device_type(x, dt, A, Bm, Cm) == "cpu":
        if build.STAND_IN is not None:
            return build.STAND_IN.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        return ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)
    cl = check_inputs(x, dt, A, Bm, Cm, chunk)
    _check_first_launch(x.device, x.dtype)
    out = _launch(x, dt, A, Bm, Cm, chunk=cl)
    build.count_launch(ssd_bshp, "ssd")
    return out


def ssd_bwd(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk=64):
    """The gradients (dx, ddt, dA, dB, dC) of the scan's y for its gradient
    ``dy`` and of its final state for ``dfinal`` (None: zero), each in its
    input's dtype and shape. CUDA tensors launch the backward kernels
    (``ssd_bwd.launches`` counts each set), which take what the forward
    takes (:func:`check_inputs`) with P up to :data:`MAX_HEAD_BWD`; CPU
    tensors take :func:`ssd_bwd_ref`."""
    traffic.note_kernel("ssd_bwd")
    tensors = (x, dt, A, Bm, Cm, dy) + (() if dfinal is None else (dfinal,))
    if build.device_type(*tensors) == "cpu":
        if build.STAND_IN is not None:
            return build.STAND_IN.ssd_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)
        return ssd_bwd_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)
    cl = check_inputs(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    if P > MAX_HEAD_BWD:
        raise ValueError(f"the SSD backward takes P up to {MAX_HEAD_BWD}, got P={P}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x {tuple(x.shape)} {x.dtype}")
    if dfinal is not None and tuple(dfinal.shape) != (B, H, P, Bm.shape[-1]):
        raise ValueError(f"dfinal of shape {tuple(dfinal.shape)}, want {(B, H, P, Bm.shape[-1])}")
    if dy.stride(-1) != 1 or (dy.dtype == torch.bfloat16 and not build.rows_16_byte_aligned(dy)):
        dy = dy.clone(memory_format=torch.contiguous_format)  # rows along P, 16-byte copies
    _check_first_bwd_launch(x.device, x.dtype)
    grads = _launch_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk=cl)
    build.count_launch(ssd_bwd, "ssd_bwd")
    return grads


class SSD(torch.autograd.Function):
    """The SSD scan with a gradient: the forward launches the scan kernel
    (the plain version on the CPU) and keeps its inputs; the backward
    launches the backward kernels, which recompute the chunk states (the
    plain version on the CPU). ``apply(x, dt, A, B, C, chunk)`` returns (y,
    final state); a final state left out of the loss has no gradient, taken
    as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        y, final = _forward(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk=ctx.chunk)
        return (*grads, None)


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
    Raises under autograd: this launch has no backward, and its output
    would carry no gradient."""
    if build.needs_grad(x, dt, A, Bm, Cm):
        raise RuntimeError(
            "ssd's raw launch has no backward: its output would carry no gradient; under "
            "autograd call ssd_bshp or SSD.apply"
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


def _launch_bwd(x, dt, A, Bm, Cm, dy, dfinal, *, chunk):
    """One set of the six backward launches (``csrc/ssd_bwd.cu``). bfloat16:
    the chunk states, the state passes, the scores (C·Bᵀ and the scores
    summed over the heads), dx, dB and dC, and ddt and dA; float32: the
    chunk states, the state passes, dx and dB per head, dC per head, ddt and
    dA, and the sums of dB and dC over the heads. The f32 scratch, of the
    size the library gives for the form, comes from ``torch.empty``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    dt32 = dt.float()
    A32 = A.float().contiguous()
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((B, S, N), dtype=Bm.dtype, device=dev)
    dC = torch.empty((B, S, N), dtype=Cm.dtype, device=dev)
    code = _DTYPE_CODES[x.dtype]
    scratch = torch.empty(_kernel_fn("ssd_bwd_scratch_floats")(code, B, S, H, P, N, chunk),
                          dtype=f32, device=dev)
    err = _kernel_fn("ssd_bwd")(
        x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        scratch.data_ptr(),
        code, dev.index, B, S, H, P, N, chunk,
        *x.stride()[:3], *dt32.stride(), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        *dy.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_bwd failed to launch: cudaError_t {err}")
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC


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


_bwd_guard = build.FirstLaunchGuard("ssd_bwd", scaled_error)  # keyed by (device index, dtype)


def _check_first_bwd_launch(device: torch.device, dtype: torch.dtype) -> None:
    """The same for the backward: two chunks, the second ragged, a random dy
    and final-state gradient; each gradient's error is scaled by its
    largest value."""

    def case():
        g = torch.Generator(device=device).manual_seed(1)
        B, S, H, P, N, chunk = 1, 100, 3, 16, 16, 64

        def randn(*shape):
            return torch.randn(shape, generator=g, device=device)

        x, Bm, Cm, dy = (randn(*s).to(dtype) for s in [(B, S, H, P), (B, S, N), (B, S, N),
                                                       (B, S, H, P)])
        dt = F.softplus(randn(B, S, H))
        A = -torch.exp(torch.rand((H,), generator=g, device=device))
        dfinal = randn(B, H, P, N)
        args = (x, dt, A, Bm, Cm, dy, dfinal)

        def launch():
            return _launch_bwd(*args, chunk=chunk)

        return launch, ssd_bwd_ref(*args, chunk=chunk)

    _bwd_guard.check((device.index, dtype), case)


ssd_bshp.launches = 0
ssd_bwd.launches = 0
