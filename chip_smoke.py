#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every hand-written kernel from ``src/repro_torch/csrc`` with nvcc
(flash attention, its backward and the SSD scan, one nvcc each, started
together), holds each against its plain PyTorch version on the card in bf16
(the tensor-core design; the backward's FMA tiles) and f32 (the FMA
design), flash attention's backward also at the training shapes, and times the bf16 kernel, its plain version and, where there is
one, the PyTorch call computing the same function: by CUDA events over
back-to-back eager calls, and as device time by CUDA-graph replay (for
SDPA's autograd backward, by a profiler trace). It then trains full-width
tinyllama-1.1b for a few bf16 steps through ``repro_torch.runtime.Trainer``
serves three full-width models (random weights from seed 0) through
``repro_torch.ServeEngine``, one after another: tinyllama-1.1b (flash
attention prefill), mamba2-1.3b (SSD prefill) and hymba-1.5b (both). Each
is served once in float32 against the port's own sequential batch-1 decode
and once in bfloat16 as its measured main path, with every kernel's launch
counter set to 0 just before that run and read just after, followed by host
times and profiler traces of one S=300 prefill and one 4-lane decode step.
It then trains full-width tinyllama-1.1b for a few bf16 steps through
``repro_torch.runtime.Trainer`` (checking the launch counts of flash
attention forward and backward, the losses, the AdamW state and the final
checkpoint, saved into ``build/`` and deleted), and holds the full-width
f32 gradients through the kernels against those through the plain
versions. Each phase prints one JSON line;
any failure exits non-zero. The last three lines are the kernels line, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
...}``.

It imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of every kernel
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the served paths, in order: (arch, engine settings, kernels every prefill
# launches once per layer). hymba's max_len stays above its window of 1024:
# at window >= max_len the engine cannot store the prefill's ring cache
# (ROADMAP F6, in the reference engine too)
PATHS = (
    ("tinyllama-1.1b", dict(max_slots=4, max_len=1024, page_size=64), ("flash_attention",)),
    ("mamba2-1.3b", dict(max_slots=4, max_len=1024, page_size=64), ("ssd",)),
    ("hymba-1.5b", dict(max_slots=4, max_len=2048, page_size=64), ("flash_attention", "ssd")),
)
N_REQUESTS, NEW_TOKENS, PROMPT_RANGE = 8, 32, (64, 512)
TIE_GAP = 1e-3  # a token mismatch at a top-2 logit gap below this is a near-tie


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- device ---------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    check(torch.cuda.device_count() == 1,
          f"{torch.cuda.device_count()} devices visible: the smoke drives one card; "
          "make one visible with CUDA_VISIBLE_DEVICES")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit("device", **info)
    return info


# -- build ----------------------------------------------------------------------

KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "ssd")


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:  # one nvcc per source, together
        list(ex.map(build.library, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        log = build.build_log[name]
        emit("build", source=f"src/repro_torch/csrc/{name}.cu", nvcc_s=log["seconds"],
             cached=log["cached"], ptxas=log["ptxas"])
    version = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[-1]
    cudart = _mapped_cudart()
    emit("build", total_s=time.perf_counter() - t0, nvcc=version, cudart=cudart)
    check(len(cudart) == 1,
          f"the kernel libraries and PyTorch must share one CUDA runtime; mapped: {cudart}")


def _mapped_cudart() -> list:
    """The CUDA runtime libraries mapped into this process."""
    with open("/proc/self/maps") as f:
        paths = {ln.split()[-1] for ln in f if "libcudart" in ln}
    return sorted(os.path.realpath(p) for p in paths)


# -- kernels --------------------------------------------------------------------


def _qkv(B, H, KV, Sq, Sk, Dh, dtype, seed, model_layout):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda", 0)
    if model_layout:  # (B, S, H, Dh), as the model's prefill hands them over
        shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh)]
    else:
        shapes = [(B, H, Sq, Dh), (B, KV, Sk, Dh), (B, KV, Sk, Dh)]
    return [torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(dtype) for s in shapes]


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's enqueue
    time (the wrapper's Python, the launches) drops out of the reading."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def _times(kernel, plain, library, iters: int) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` by CUDA events over back-to-back
    eager calls (the host's enqueue time included where it is the longer),
    and the kernel's and the library call's device time from CUDA-graph
    replay (``device_ms``, ``library_device_ms``). The plain version is not
    captured: its matmuls would leave a cuBLAS workspace for the capture
    stream allocated, which the serve phases' peak memory would count."""
    out = {"ms": _time_ms(kernel, iters), "plain_ms": _time_ms(plain, iters),
           "library_ms": None if library is None else _time_ms(library, iters)}
    out["device_ms"] = _graph_ms(kernel)
    out["library_device_ms"] = None if library is None else _graph_ms(library)
    return out


def _attention_bound(B, H, KV, Sq, Sk, Dh, elem_bytes, causal, peak_flops):
    """Least time for the work: each input read once, the output written
    once; FLOPs over the (q, k) pairs the mask leaves visible."""
    if causal:
        pairs = sum(min(q + 1, Sk) for q in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4 * B * H * Dh * pairs
    nbytes = elem_bytes * (2 * B * H * Sq * Dh + 2 * B * KV * Sk * Dh)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _flash_cases() -> list:
    """K1's sweep, each case in bf16 and f32: (label, B, H, KV, Sq, Sk, Dh,
    causal, window, k_len, model_layout, dtype)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for S in (64, 300, 512, 1024):
        for dt in (bf16, f32):
            cases.append(
                (f"tinyllama causal S={S}", 1, 32, 4, S, S, 64, True, None, None, True, dt)
            )
    for dt in (bf16, f32):
        cases += [
            ("window=100", 1, 32, 4, 512, 512, 64, True, 100, None, True, dt),
            ("k_len=100 Sk=128", 1, 8, 4, 128, 128, 64, True, None, 100, False, dt),
            ("non-causal Sq=64 Sk=192", 2, 8, 4, 64, 192, 64, False, None, None, False, dt),
            ("MQA KV=1", 1, 8, 1, 256, 256, 64, True, None, None, False, dt),
            ("Dh=32", 2, 4, 2, 200, 200, 32, True, None, None, False, dt),
            ("Dh=128", 1, 8, 2, 300, 300, 128, True, None, None, True, dt),
            # hymba's prefill: H=25 KV=5 (a group of 5), global and window layers
            ("hymba global S=300", 1, 25, 5, 300, 300, 64, True, None, None, True, dt),
            ("hymba window=1024 S=300", 1, 25, 5, 300, 300, 64, True, 1024, None, True, dt),
            ("hymba window=1024 S=1100", 1, 25, 5, 1100, 1100, 64, True, 1024, None, True, dt),
        ]
    return cases


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bhsd
    from repro_torch.kernels.flash_attention import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 1e-4}
    worst = 0.0
    for i, case in enumerate(_flash_cases()):
        label, B, H, KV, Sq, Sk, Dh, causal, window, k_len, model_layout, dt = case
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, dt, seed=i, model_layout=model_layout)
        kw = dict(causal=causal, window=window, k_len=k_len)
        if model_layout:
            got = flash_attention(q, k, v, **kw).transpose(1, 2)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            want = flash_attention_ref(qt, kt, vt, **kw)
        else:
            got = flash_attention_bhsd(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol[dt]
        where = {}
        if not ok:  # locate the disagreement, and say which side is off
            bad = (~(diff <= tol[dt])).nonzero()
            args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) if model_layout \
                else (q, k, v)
            cpu = flash_attention_ref(*(t.double().cpu() for t in args), **kw)
            where = {"n_bad": len(bad), "lo": bad.min(0).values.tolist(),
                     "hi": bad.max(0).values.tolist(), "first": bad[:8].tolist(),
                     "kernel_vs_cpu_f64": (got.cpu().double() - cpu).abs().max().item(),
                     "plain_vs_cpu_f64": (want.cpu().double() - cpu).abs().max().item()}
        emit("kernels", kernel="flash_attention", case=label, dtype=str(dt).split(".")[-1],
             shape=[B, H, KV, Sq, Sk, Dh], max_abs_err=err, tol=tol[dt], ok=ok, **where)
        check(ok, f"flash_attention {label} {dt}: max_abs_err {err} > {tol[dt]}")
        worst = max(worst, err)

    timings = {}
    for label, H, KV, S in (("tinyllama S=512", 32, 4, 512), ("tinyllama S=1024", 32, 4, 1024),
                            ("hymba S=512", 25, 5, 512)):
        B, Dh = 1, 64
        q, k, v = _qkv(B, H, KV, S, S, Dh, bf16, seed=100 + S + H, model_layout=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))
        timings[label] = _times(
            lambda: flash_attention(q, k, v, causal=True),
            lambda: flash_attention_ref(qt, kt, vt, causal=True),
            lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True),
            iters=50,
        )
        bound_ms, bound_by = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS)
        timings[label].update(bound_ms=bound_ms, bound_by=bound_by)
        emit("kernels", kernel="flash_attention",
             timing=f"{label} bf16 causal B={B} H={H} KV={KV} Dh={Dh}", **timings[label])
    return {"flash_attention": {"max_abs_err": worst, "timings": timings}}


# K1's backward against its plain version. Both compute in f32 from the same
# inputs, so in f32 they differ by the sum order only: the largest-scaled
# error (max |kernel - plain| / max(1, max |plain|)) stays under 1e-4. In
# bf16 the outputs are rounded, and a sum-order difference can flip one
# rounding: up to one ulp of the largest gradient, 2^-7 of it when scaled.
# The scaled error alone cannot tell a small entry that is wrong by many of
# its own ulps, so bf16 is also held in ulps: each entry's error over the
# ulp of max(|plain|, 2^-8 max |plain|) is at most BWD_ULP_TOL. A control
# that rounds P and dS to bf16 before their products (the precision of a
# tensor-core backward) reads tens of ulps there (``_bwd_bf16_control``).
BWD_TOL = {"bfloat16": 2.0**-7, "float32": 1e-4}
BWD_ULP_TOL = 2.0
# the forward's lse against its plain version, scaled the same way
LSE_TOL = {"bfloat16": 1e-4, "float32": 1e-4}
# the forward's output, as in phase_kernels: max abs error
FWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# tinyllama's training attention: (B, H, KV, S, Dh), causal, bf16
TRAIN_ATTN = (4, 32, 4, 2048, 64)


def _scaled(got, want) -> float:
    w = want.float()
    return (got.float() - w).abs().max().item() / max(1.0, w.abs().max().item())


def _ulps(got, want) -> float:
    """Largest error in bf16 ulps of each plain entry, entries under 2^-8 of
    the largest counted at that floor's ulp."""
    import torch

    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() * 2.0**-8)
    _, e = torch.frexp(mag)  # mag in [2^(e-1), 2^e): its bf16 ulp is 2^(e-8)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return ((got.float() - w).abs() / ulp).max().item()


def _bwd_bf16_control(q, k, v, o, lse, do, *, causal, window, k_len):
    """A lower-precision backward, for reading what the bf16 tolerance
    rejects: the plain formulas with S, P and dS rounded to bf16 before
    their products, f32 accumulation. (B, H, S, Dh) layout."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale, bf16 = H // KV, Dh**-0.5, torch.bfloat16

    def grouped(t):
        return t.reshape(B, KV, G, Sq, Dh).to(bf16)

    qg, og, dog, kb, vb = grouped(q), grouped(o), grouped(do), k.to(bf16), v.to(bf16)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kb).float() * scale
    mask = fa._mask(Sq, Sk, causal, window, k_len, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq, 1).float()), 0.0).to(bf16)
    delta = (dog.float() * og.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    ds = (p.float() * (torch.einsum("bkgqd,bksd->bkgqs", dog, vb).float() - delta)).to(bf16)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kb).float() * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg).float() * scale
    return dq.reshape(B, H, Sq, Dh).to(bf16), dk.to(bf16), dv.to(bf16)


def _bwd_case(q, k, v, do, kw, model_layout) -> tuple:
    """One check of K1's forward (output and lse) and backward against the
    plain versions on the same inputs; the bf16 control read beside it.
    Returns the kernel's (o, lse) and the readings."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    name = str(q.dtype).split(".")[-1]
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, bshd=model_layout, **kw)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=model_layout, **kw)
    args = [t.transpose(1, 2) if model_layout else t for t in (q, k, v, o, do)]
    o_want, lse_want = fa.flash_attention_lse_ref(*args[:3], **kw)
    want = fa.flash_attention_bwd_ref(args[0], args[1], args[2], args[3], lse, args[4], **kw)
    if model_layout:
        want = [w.transpose(1, 2) for w in want]
    torch.cuda.synchronize()
    r = {
        "scaled_err": {n: _scaled(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)},
        "max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
        "lse_scaled_err": _scaled(lse, lse_want),
        "o_max_abs_err": (args[3].float() - o_want.float()).abs().max().item(),
        "finite": all(bool(torch.isfinite(t.float()).all()) for t in got),
        "tol": BWD_TOL[name], "lse_tol": LSE_TOL[name], "o_tol": FWD_TOL[name],
    }
    ok = r["finite"] and max(r["scaled_err"].values()) <= BWD_TOL[name] \
        and r["lse_scaled_err"] <= LSE_TOL[name] and r["o_max_abs_err"] <= FWD_TOL[name]
    if q.dtype == torch.bfloat16:
        r["ulp_err"] = {n: _ulps(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        ctl = _bwd_bf16_control(*args[:4], lse, args[4], **kw)
        if model_layout:
            ctl = [c.transpose(1, 2) for c in ctl]
        r["control_scaled_err"] = {n: _scaled(a, b) for n, a, b in zip(("dq", "dk", "dv"), ctl, want)}
        r["control_ulp_err"] = {n: _ulps(a, b) for n, a, b in zip(("dq", "dk", "dv"), ctl, want)}
        r["ulp_tol"] = BWD_ULP_TOL
        ok = ok and max(r["ulp_err"].values()) <= BWD_ULP_TOL
        del ctl
    r["ok"] = ok
    del got, want
    return o, lse, r


def _profiled_ms(fn, calls: int = 10) -> float:
    """Device time of one call as the sum of its kernels' durations in a
    profiler trace of ``calls`` calls (for calls that autograd runs, which
    a CUDA graph capture does not take as they are)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls


def _attention_bwd_bound(B, H, KV, S, Dh, elem_bytes, peak_flops):
    """Least time for the causal backward: q, k, v, o, dO and the f32 lse
    read once, dq, dk, dv written once; FLOPs of its five products (S and dP
    recomputed, dV, dK, dQ), 2.5x the forward's, over the visible pairs."""
    pairs = S * (S + 1) // 2
    flops = 10 * B * H * Dh * pairs
    nbytes = elem_bytes * (3 * B * H * S * Dh + 2 * B * KV * S * Dh) + 4 * B * H * S \
        + elem_bytes * (B * H * S * Dh + 2 * B * KV * S * Dh)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_flash_bwd() -> dict:
    """K1's backward against its plain version over the forward's sweep, in
    both dtypes, with the forward's output and lse checked too, then the
    same at tinyllama's training shapes in bf16 (the train path's own
    inputs), where it is timed beside the plain version and the autograd
    backward of PyTorch's SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = worst_abs = worst_ulp = 0.0
    for i, case in enumerate(_flash_cases()):
        label, B, H, KV, Sq, Sk, Dh, causal, window, k_len, model_layout, dt = case
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, dt, seed=500 + i, model_layout=model_layout)
        g = torch.Generator(device="cuda").manual_seed(900 + i)
        do = torch.randn(q.shape, generator=g, device=q.device).to(dt)
        kw = dict(causal=causal, window=window, k_len=k_len)
        _, _, r = _bwd_case(q, k, v, do, kw, model_layout)
        name = str(dt).split(".")[-1]
        emit("kernels", kernel="flash_attention_bwd", case=label, dtype=name,
             shape=[B, H, KV, Sq, Sk, Dh], **r)
        check(r["ok"], f"flash_attention_bwd {label} {name}: {r}")
        worst = max(worst, *r["scaled_err"].values())
        worst_abs = max(worst_abs, r["max_abs_err"])
        worst_ulp = max(worst_ulp, *r.get("ulp_err", {"": 0.0}).values())

    B, H, KV, S, Dh = TRAIN_ATTN
    bf16 = torch.bfloat16
    q, k, v = _qkv(B, H, KV, S, S, Dh, bf16, seed=1000, model_layout=True)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1001),
                     device=q.device).to(bf16)
    o, lse, r = _bwd_case(q, k, v, do, dict(causal=True, window=None, k_len=None), True)
    label = f"train bf16 causal B={B} H={H} KV={KV} Dh={Dh} S={S}"
    emit("kernels", kernel="flash_attention_bwd", case=label, dtype="bfloat16",
         shape=[B, H, KV, S, S, Dh], **r)
    check(r["ok"], f"flash_attention_bwd {label}: {r}")
    # the ulp gate rejects a lower-precision backward at the path's shapes
    check(max(r["control_ulp_err"].values()) > BWD_ULP_TOL,
          f"the bf16 control passes the ulp tolerance at {label}: {r['control_ulp_err']}")
    worst = max(worst, *r["scaled_err"].values())
    worst_abs = max(worst_abs, r["max_abs_err"])
    worst_ulp = max(worst_ulp, *r["ulp_err"].values())
    torch.cuda.empty_cache()

    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    # the library's backward: SDPA's autograd backward alone, its forward run once
    qs, ks, vs = (t.contiguous().requires_grad_() for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    do_c = dot.contiguous()

    def library():
        torch.autograd.grad(out, (qs, ks, vs), do_c, retain_graph=True)

    def kernel():
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, bshd=True)

    t = {"ms": _time_ms(kernel, 10), "plain_ms": _time_ms(
        lambda: fa.flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, causal=True), 3, 1),
        "library_ms": _time_ms(library, 10)}
    t["device_ms"] = _graph_ms(kernel, calls=5, replays=3)
    t["library_device_ms"] = _profiled_ms(library)
    t["kernel_profiled_ms"] = _profiled_ms(kernel, calls=3)
    t["bound_ms"], t["bound_by"] = _attention_bwd_bound(B, H, KV, S, Dh, 2, PEAK_BF16_FLOPS)
    fwd_bound, _ = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS)
    t["forward"] = {"ms": _time_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True,
                                                                   bshd=True), 10),
                    "device_ms": _graph_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                           calls=5, replays=3),
                    "bound_ms": fwd_bound}
    emit("kernels", kernel="flash_attention_bwd", timing=label, **t)
    del out, qs, ks, vs
    return {"flash_attention_bwd": {"max_scaled_err": worst, "max_abs_err": worst_abs,
                                    "max_ulp_err": worst_ulp, "timing": t}}


def _ssd_inputs(B, S, H, P, N, dtype, seed, laws="wide"):
    """x, B and C as the model hands them over: split views of one (B, S,
    H*P + 2N) activation. laws "wide": dt = softplus(N(0, 1)), A = -exp(U[0,
    1)), so the state decays within a few rows; "model": the model's init
    laws, log-uniform dt in [1e-3, 0.1) and A in [-16, -1), so the state
    carries across whole chunks."""
    import math

    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda", 0)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=dev).to(dtype)
    x = xbc[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    if laws == "model":
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand((B, S, H), generator=g, device=dev))
        A = -(1.0 + 15.0 * torch.rand((H,), generator=g, device=dev))
    else:
        dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev))
        A = -torch.exp(torch.rand((H,), generator=g, device=dev))
    return x, dt, A, Bm, Cm


def _ssd_bound(B, S, H, P, N, cl, elem_bytes, peak_flops):
    """Least time for the scan: x, B and C (elem_bytes), dt and A (f32) read
    once, y written once and the f32 final state written once. FLOPs: C B^T
    over each chunk's causal pairs (shared by the heads), and per head M x
    over the same pairs, the inter-chunk term C state for every chunk but
    the first (which enters with a zero state), and the state update of
    every chunk."""
    full, rest = divmod(S, cl)
    chunks = [cl] * full + ([rest] if rest else [])
    pairs = sum(n * (n + 1) // 2 for n in chunks)
    entering = S - chunks[0]
    flops = B * (2 * N * pairs + H * (2 * P * pairs + 2 * N * P * entering + 2 * N * P * S))
    nbytes = (elem_bytes * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
              + 4 * B * H * P * N)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_ssd_kernels() -> dict:
    import torch

    from repro_torch.kernels.ssd import scaled_error, ssd_bshp, ssd_ref

    bf16, f32 = torch.bfloat16, torch.float32
    # scaled error: max |kernel - plain| / max(1, max |plain|); both compute in
    # f32 from the same inputs, so bf16 differs by about one rounding of y
    tol = {bf16: 1e-2, f32: 1e-4}
    # (label, B, S, H, P, N, chunk, dt/A laws)
    shapes = [(f"mamba2 S={S}", 1, S, 64, 64, 128, 256, "wide") for S in (300, 512, 1024)]
    shapes += [
        ("mamba2 S=512 model's dt/A", 1, 512, 64, 64, 128, 256, "model"),
        ("hymba S=300", 1, 300, 25, 64, 16, 64, "wide"),
        ("B=2 H=25 N=128 chunk 64 S=100", 2, 100, 25, 64, 128, 64, "wide"),
        ("S=50 < chunk 256", 1, 50, 4, 64, 128, 256, "wide"),
        ("P=40 N=24 chunk 32 S=70", 2, 70, 3, 40, 24, 32, "wide"),
        ("B=2 H=5 P=32 N=16 chunk 64 S=130", 2, 130, 5, 32, 16, 64, "wide"),
    ]
    worst, worst_scaled = 0.0, 0.0
    for i, (label, B, S, H, P, N, chunk, laws) in enumerate(shapes):
        for dt_ in (bf16, f32):
            x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dt_, 200 + i, laws)
            kw = dict(chunk=chunk, return_final_state=True)
            got = ssd_bshp(x, dt, A, Bm, Cm, **kw)
            want = ssd_ref(x, dt, A, Bm, Cm, **kw)
            torch.cuda.synchronize()
            errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            scaled = [scaled_error(g, w) for g, w in zip(got, want)]
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            ok = finite and max(scaled) <= tol[dt_]
            where = {}
            if not ok:  # say which side is off, against a CPU float64 run
                cpu = ssd_ref(*(t.double().cpu() for t in (x, dt, A, Bm, Cm)), **kw)
                where = {"kernel_vs_cpu_f64": [(g.cpu().double() - c).abs().max().item()
                                               for g, c in zip(got, cpu)],
                         "plain_vs_cpu_f64": [(w.cpu().double() - c).abs().max().item()
                                              for w, c in zip(want, cpu)]}
            emit("kernels", kernel="ssd", case=label, dtype=str(dt_).split(".")[-1],
                 shape=[B, S, H, P, N, chunk], laws=laws, max_abs_err=errs, scaled_err=scaled,
                 tol=tol[dt_], finite=finite, ok=ok, **where)
            check(ok, f"ssd {label} {dt_}: scaled errors (y, state) {scaled} > {tol[dt_]}")
            worst, worst_scaled = max(worst, *errs), max(worst_scaled, *scaled)

    timings = {}
    for label, B, S, H, P, N, chunk in (
        ("mamba2 S=512", 1, 512, 64, 64, 128, 256),
        ("mamba2 S=1024", 1, 1024, 64, 64, 128, 256),
        ("hymba S=512", 1, 512, 25, 64, 16, 64),
    ):
        x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, bf16, 300 + S)
        kw = dict(chunk=chunk, return_final_state=True)
        # no single PyTorch call computes the SSD scan
        timings[label] = _times(lambda: ssd_bshp(x, dt, A, Bm, Cm, **kw),
                                lambda: ssd_ref(x, dt, A, Bm, Cm, **kw), None, iters=20)
        bound_ms, bound_by = _ssd_bound(B, S, H, P, N, chunk, 2, PEAK_BF16_FLOPS)
        timings[label].update(bound_ms=bound_ms, bound_by=bound_by)
        emit("kernels", kernel="ssd", timing=f"{label} bf16 B={B} H={H} P={P} N={N} chunk={chunk}",
             **timings[label])
    return {"ssd": {"max_abs_err": worst, "max_scaled_err": worst_scaled, "timings": timings}}


# -- serve ----------------------------------------------------------------------


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def _sequential(model, params, prompt, budget, width):
    """The port's own batch-1 path: prefill, then decode_step one token at a
    time, provisioned at the engine's width (sliding-window rings re-laid to
    the engine's modulus). Returns tokens and each step's top-2 logit gap."""
    import torch

    from repro_torch.models.lm import extend_caches

    logits, caches = model.prefill(params, {"tokens": prompt[None]})
    caches = extend_caches(caches, width - prompt.size, window=model.cfg.window)
    toks, gaps = [], []
    for i in range(budget):
        top = torch.topk(logits[0, -1].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        toks.append(int(torch.argmax(logits[0, -1])))
        if i + 1 < budget:
            logits, caches = model.decode_step(params, [[toks[-1]]], caches, [prompt.size + i])
    return toks, gaps


def _serve(model, params, prompts, serve_kw):
    import torch

    from repro_torch.serve import ServeEngine

    with ServeEngine(model, params, **serve_kw) as engine:
        t0 = time.perf_counter()
        handles = [engine.submit(p, NEW_TOKENS) for p in prompts]
        outs = [list(map(int, h.result(600))) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = engine.stats()
    # handles keep the engine (and its weights) alive through their cancellers
    marks = [
        {"ttft": h.ttft, "admit": h.prefill_start_t - h.submit_t,
         "prefill": h.prefill_done_t - h.prefill_start_t,
         "slot_wait": h.first_token_t - h.prefill_done_t}
        for h in handles
    ]
    return outs, marks, wall, stats


def _traced(fn, top: int = 3) -> dict:
    """One call of ``fn`` under the profiler: host-clock ms to the end of its
    device work, the device-busy ms (the sum of its kernels' durations on the
    one stream), the idle share, the launch count, the device ms of the
    port's kernels by name (K1 ``flash_fwd_*``, K1's backward ``bwd_*``, K2
    ``ssd_*``), of the ``top`` heaviest kernels, and of the GEMMs (cuBLAS
    kernels, by name) in all and the ``top`` largest."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ports = {}  # device ms of each of the port's kernels, by its short name
    by_name = {}  # device ms and count of every kernel, by its full name
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        ms0, n0 = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms0 + ms, n0 + 1)
        name = re.search(r"(flash_fwd_\w+|ssd_\w+|bwd_(?:dkdv|dq|preprocess))", e.name)
        if name:
            ports[name.group(1)] = ports.get(name.group(1), 0.0) + ms
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    gemms = [kv for kv in heaviest if re.search(r"gemm|nvjet|xmma|cutlass", kv[0])]
    heaviest = heaviest[:top]
    return {
        "traced_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms else None,
        "kernel_launches": len(kernels),
        "k1_device_ms": sum(v for k, v in ports.items() if k.startswith("flash_fwd")),
        "k1_bwd_device_ms": sum(v for k, v in ports.items() if k.startswith("bwd_")),
        "k2_device_ms": sum(v for k, v in ports.items() if k.startswith("ssd_")),
        "port_kernels_device_ms": ports,
        "heaviest_kernels": [{"name": n[:120], "device_ms": ms, "calls": c}
                             for n, (ms, c) in heaviest],
        "gemm_device_ms": sum(ms for _, (ms, _c) in gemms),
        "gemm_launches": sum(c for _, (_ms, c) in gemms),
        "largest_gemms": [{"name": n[:120], "device_ms": ms, "calls": c}
                          for n, (ms, c) in gemms[:top]],
    }


def _layer_times(model, params, serve_kw) -> dict:
    """Host-clock times of one prefill (S=300) and one 4-lane decode step at
    full width, and a profiler trace of each (:func:`_traced`)."""
    import torch

    from repro_torch.tree import tree_map

    cfg = model.cfg
    S, lanes, width = 300, serve_kw["max_slots"], serve_kw["max_len"]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S))
    caches = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=model.device),
                      model.cache_shapes(lanes, width))
    tok = torch.zeros((lanes, 1), dtype=torch.long, device=model.device)
    idx = torch.tensor([100, 300, 500, 700], device=model.device)[:lanes]

    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    def prefill():
        model.prefill(params, {"tokens": tokens})

    def decode():
        model.decode_step(params, tok, caches, idx)

    out = {"arch": cfg.name, "prefill_ms_S300": host_ms(prefill, 5),
           "decode_step_ms_4lanes": host_ms(decode, 10)}
    out.update({f"prefill_{k}": v for k, v in _traced(prefill).items()})
    out.update({f"decode_{k}": v for k, v in _traced(decode).items()})
    return out


def _counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` it adds one to per launch."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ssd import ssd_bshp

    return {"flash_attention": flash_attention_bhsd, "ssd": ssd_bshp}


def _release_device_memory() -> dict:
    """Free what earlier phases left behind, the cuBLAS workspaces of other
    threads and streams included (autograd's backward runs on its own
    thread), so a phase's peak memory counts its own work only. Returns the
    bytes allocated before and after."""
    import torch

    left = torch.cuda.memory_allocated()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return {"allocated_left_bytes": left, "allocated_at_start_bytes": torch.cuda.memory_allocated()}


def phase_serve(arch: str, serve_kw: dict, path_kernels: tuple) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(arch)
    prompts = _prompts(base.vocab_size)
    emit("serve", arch=arch, **_release_device_memory())

    # f32, TF32 off: the engine against sequential batch-1 decode
    model = build_model(base.replace(dtype="float32"))
    params = model.init(seed=0)
    outs, _marks, wall, stats = _serve(model, params, prompts, serve_kw)
    mismatches = []
    for r, (prompt, out) in enumerate(zip(prompts, outs)):
        ref, gaps = _sequential(model, params, prompt, NEW_TOKENS, serve_kw["max_len"])
        if out != ref:
            i = next(j for j, (a, b) in enumerate(zip(out, ref)) if a != b)
            mismatches.append({"request": r, "step": i, "top2_gap": gaps[i]})
    emit("serve", arch=arch, dtype="float32", requests=len(prompts), wall_s=wall,
         ticks=stats["ticks"], preemptions=stats["preemptions"], mismatches=mismatches,
         phase_s=time.perf_counter() - t_start)
    for m in mismatches:
        check(m["top2_gap"] < TIE_GAP,
              f"{arch} float32 engine tokens differ from sequential decode at a gap of "
              f"{m['top2_gap']}")
    del model, params
    # the closed engine sits in a reference cycle holding the f32 weights
    _release_device_memory()

    # bf16: the measured main path, warmed up by one request first; every
    # kernel's count is set to 0 just before the run and read just after
    t_bf16 = time.perf_counter()
    model = build_model(base.replace(dtype="bfloat16"))
    params = model.init(seed=0)
    _serve(model, params, prompts[:1], serve_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    outs, marks, wall, stats = _serve(model, params, prompts, serve_kw)
    launches = {name: fn.launches for name, fn in counters.items()}
    prefills = len(prompts) + stats["preemptions"]
    n_tok = sum(len(o) for o in outs)
    ttft = [m["ttft"] for m in marks]
    res = {
        "arch": arch,
        "dtype": "bfloat16",
        "serve": serve_kw,
        "requests": len(prompts),
        "prompt_lens": [int(p.size) for p in prompts],
        "tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        # TTFT = admission wait + prefill + wait for a slot, per request
        "ttft_parts_s": {k: [m[k] for m in marks] for k in ("admit", "prefill", "slot_wait")},
        "ttft_sum_s": sum(ttft),
        "ttft_share": {k: sum(m[k] for m in marks) / sum(ttft)
                       for k in ("admit", "prefill", "slot_wait")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ticks": stats["ticks"],
        "preemptions": stats["preemptions"],
        "launches": launches,
        "prefills": prefills,
    }
    emit("serve", **res)
    emit("layers", **_layer_times(model, params, serve_kw))
    check(all(len(o) == NEW_TOKENS and all(0 <= t < base.vocab_size for t in o) for o in outs),
          f"{arch} bf16 run: a request came back short or with an out-of-vocabulary token")
    for name in path_kernels:
        check(launches[name] >= base.num_layers * prefills,
              f"{arch}: {name} launched {launches[name]} times for {prefills} prefills of "
              f"{base.num_layers} layers")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve", arch=arch, bf16_phase_s=time.perf_counter() - t_bf16,
         phase_s=time.perf_counter() - t_start)
    return res


# the train cell: tinyllama-1.1b at full width and depth, bf16, remat "full"
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 6
TRAIN_KW = dict(seq_len=2048, global_batch=4, lr=3e-4, warmup=2)
# the parity run: f32, full width and depth, B=1, S=256; each leaf group's
# largest gradient error against the plain attention's, over its largest
# gradient (f32 sums in another order, through 22 layers)
PARITY_B, PARITY_S, PARITY_TOL = 1, 256, 1e-4


def _train_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bhsd, flash_attention_bwd

    return {"flash_attention": flash_attention_bhsd, "flash_attention_bwd": flash_attention_bwd}


def _model_flops(cfg, n_params: int, B: int, S: int) -> tuple:
    """Model FLOPs of one step (no remat recompute): 6 N per token for the
    parameter products, N without the embedding table unless the head is
    tied to it (its forward is a gather, not a product), and causal
    attention's two products, forward (4 Dh per visible pair per head) and
    backward (twice that)."""
    n = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    pairs = S * (S + 1) // 2
    attn = 12 * cfg.num_layers * B * cfg.num_heads * cfg.head_dim * pairs
    formula = ("6*N*B*S + 12*L*B*H*Dh*S*(S+1)/2, N = parameters - the embedding table "
               "(untied)")
    return 6 * n * B * S + attn, formula, n


def phase_train() -> dict:
    """Train full-width tinyllama-1.1b for TRAIN_STEPS bf16 steps through
    ``repro_torch.runtime.Trainer`` (prefetched synthetic batches, the loss
    with remat, autograd through K1 forward and backward, AdamW, the final
    checkpoint saved on the pool into ``build/`` and deleted at the end)."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    allocated = _release_device_memory()
    cfg = get_config(TRAIN_ARCH).replace(dtype="bfloat16")
    check(cfg.remat == "full", f"{TRAIN_ARCH} trains with remat {cfg.remat!r}")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    emit("train", arch=TRAIN_ARCH, **allocated, disk_free_bytes=free)
    tcfg = TrainerConfig(num_steps=TRAIN_STEPS, checkpoint_every=10 * TRAIN_STEPS, log_every=1,
                         **TRAIN_KW)
    tr = Trainer(cfg, tcfg, str(ckpt_dir), device="cuda:0")
    try:
        counters = _train_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        out = tr.run(resume=False)
        launches = {name: fn.launches for name, fn in counters.items()}
        # each logged row's step_s: the step's wall time, the device drained
        # at both ends (log_every=1); the save's record from the manager
        steps_s = [r["step_s"] for r in out["metrics"]]
        check(len(tr.ckpt.saves) == 1, f"saves recorded: {tr.ckpt.saves}")
        save = tr.ckpt.saves[0]
        peak = torch.cuda.max_memory_allocated()
        saved = sorted(p.name for p in ckpt_dir.iterdir())
        check(saved == [f"step_{TRAIN_STEPS:08d}"], f"checkpoints after the run: {saved}")
        on_disk = sum(f.stat().st_size for f in (ckpt_dir / saved[0]).iterdir())

        rows = out["metrics"]
        params, opt = out["params"], out["opt"]
        n_params = sum(p.numel() for p in params.parameters())
        check(len(rows) == TRAIN_STEPS, f"{len(rows)} metric rows for {TRAIN_STEPS} steps")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
              f"a non-finite loss or grad norm: {rows}")
        init = tr.model.init(tcfg.seed)
        unchanged = [k for k, (a, b) in enumerate(zip(tree_leaves(params.tree()),
                                                      tree_leaves(init.tree())))
                     if torch.equal(a, b)]
        check(not unchanged, f"{len(unchanged)} parameter leaves unchanged after training")
        del init
        dtypes = {part: sorted({str(t.dtype) for t in tree_leaves(opt[part])})
                  for part in ("m", "v", "master")}
        dtypes["count"] = str(opt["count"].dtype)
        dtypes["params"] = sorted({str(t.dtype) for t in params.parameters()})
        check(dtypes == {"m": ["torch.float32"], "v": ["torch.float32"],
                         "master": ["torch.float32"], "count": "torch.int32",
                         "params": ["torch.bfloat16"]}, f"state dtypes {dtypes}")
        per_step = {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
        for name, n in per_step.items():
            check(launches[name] == n * TRAIN_STEPS,
                  f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, "
                  f"want {n} a step")

        # one more step, under the profiler
        state = {"params": params, "opt": opt}
        batch = to_device(tr.data.batch(TRAIN_STEPS), tr.device)
        trace = _traced(lambda: tr.train_step(state, batch, TRAIN_STEPS), top=6)
        B, S = TRAIN_KW["global_batch"], TRAIN_KW["seq_len"]
        step_s = float(np.median(steps_s[1:]))
        flops, formula, n_matmul = _model_flops(cfg, n_params, B, S)
        res = {
            "arch": TRAIN_ARCH, "dtype": "bfloat16", "steps": TRAIN_STEPS, "batch": B,
            "seq_len": S, "remat": cfg.remat, "params": n_params,
            "loss": [r["loss"] for r in rows], "grad_norm": [r["grad_norm"] for r in rows],
            "lr": [r["lr"] for r in rows],
            "step_s": steps_s, "step_s_median_after_first": step_s,
            "tokens_per_s": B * S / step_s,
            "peak_mem_bytes": peak,
            "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
            "model_flops_per_step": flops, "model_flops_formula": formula,
            "model_flops_n": n_matmul,
            "model_flop_share_of_989_tflops": flops / step_s / PEAK_BF16_FLOPS,
            "ckpt": {"disk_free_bytes_before": free, "bytes": save["bytes"],
                     "bytes_on_disk": on_disk, "seconds": save["seconds"],
                     "snapshot_s": save["snapshot_s"]},
            "state_dtypes": dtypes,
        }
        res.update({f"step_{k}": v for k, v in trace.items()})
        emit("train", **res)
    finally:
        tr.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(not ckpt_dir.exists(), f"{ckpt_dir} was not removed")
    del tr, out, params, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    emit("train", arch=TRAIN_ARCH, ckpt_removed=True, phase_s=time.perf_counter() - t_start)
    return res


def _plain_attention():
    """The model's attention call, for the parity run only: the plain
    versions forward (``flash_attention_lse_ref``) and backward
    (``flash_attention_bwd_ref``), in the model's layout."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, k_len):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            o, lse = fa.flash_attention_lse_ref(qt, kt, vt, causal=causal, window=window,
                                                k_len=k_len)
            ctx.save_for_backward(qt, kt, vt, o, lse)
            ctx.mask = dict(causal=causal, window=window, k_len=k_len)
            return o.transpose(1, 2)

        @staticmethod
        def backward(ctx, do):
            qt, kt, vt, o, lse = ctx.saved_tensors
            grads = fa.flash_attention_bwd_ref(qt, kt, vt, o, lse, do.transpose(1, 2),
                                               **ctx.mask)
            return (*(g.transpose(1, 2) for g in grads), None, None, None)

    def attention(q, k, v, *, causal=True, window=None, k_len=None):
        return Plain.apply(q, k, v, causal, window, k_len)

    return attention


def phase_train_parity() -> dict:
    """Loss and every gradient of full-width, full-depth tinyllama in f32 on
    the card, through the kernels and then with the model's attention call
    patched (here only) to the plain versions; the largest scaled error per
    leaf group."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import build_model
    from repro_torch.tree import tree_flatten_with_keys

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).replace(dtype="float32")
    model = build_model(cfg, device="cuda:0")
    params = model.init(seed=0)
    batch = SyntheticTokens(cfg.vocab_size, PARITY_S, PARITY_B, seed=0).batch(0)
    keyed = tree_flatten_with_keys(params.tree())

    def loss_and_grads():
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in keyed])
        return loss.item(), grads

    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    loss_k, grads_k = loss_and_grads()
    launches = {name: fn.launches for name, fn in counters.items()}
    kernel_fn = attention_mod.flash_attention
    attention_mod.flash_attention = _plain_attention()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        attention_mod.flash_attention = kernel_fn
    groups = {}  # leaf group (layer index dropped) -> (max abs diff, max abs plain)
    for (key, _), gk, gp in zip(keyed, grads_k, grads_p):
        group = ".".join(part for part in key.split(".") if not part.isdigit())
        d, m = (gk - gp).abs().max().item(), gp.abs().max().item()
        d0, m0 = groups.get(group, (0.0, 0.0))
        groups[group] = (max(d, d0), max(m, m0))
    scaled = {g: d / m if m else d for g, (d, m) in groups.items()}
    worst = max(scaled.values())
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    emit("train_parity", arch=TRAIN_ARCH, dtype="float32", batch=PARITY_B, seq_len=PARITY_S,
         loss_kernels=loss_k, loss_plain=loss_p, launches=launches, scaled_grad_err=scaled,
         worst=worst, tol=PARITY_TOL, finite=finite, phase_s=time.perf_counter() - t_start)
    check(finite and np.isfinite(loss_k), "non-finite loss or gradient through the kernels")
    check(abs(loss_k - loss_p) <= PARITY_TOL * max(1.0, abs(loss_p)),
          f"loss through the kernels {loss_k} against {loss_p}")
    check(worst <= PARITY_TOL, f"gradients through the kernels: worst scaled error {worst}")
    check(launches == {"flash_attention": 2 * cfg.num_layers,
                       "flash_attention_bwd": cfg.num_layers},
          f"parity run launches {launches}")
    del model, params, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return {"worst": worst, "scaled": scaled}


def _kernel_line(kern: dict, serves: list, train: dict) -> dict:
    """The kernels JSON line: launches summed over the measured runs of the
    paths (listed per path: the train run and each served model), the rest
    from the kernels phases; ``design`` names the bf16 kernel's instruction
    path."""
    import torch

    from repro_torch.kernels.flash_attention import design as fa_design
    from repro_torch.kernels.ssd import DESIGNS as SSD_DESIGNS

    def launches(name):
        by_path = {f"train {train['arch']}": train["launches"][name]} if name in \
            train["launches"] else {}
        by_path.update({s["arch"]: s["launches"][name] for s in serves if name in s["launches"]})
        return sum(by_path.values()), by_path

    fa, t_fa = kern["flash_attention"], kern["flash_attention"]["timings"]["tinyllama S=512"]
    ssd, t_ssd = kern["ssd"], kern["ssd"]["timings"]["mamba2 S=512"]
    fa_n, fa_by = launches("flash_attention")
    ssd_n, ssd_by = launches("ssd")
    bwd, t_bwd = kern["flash_attention_bwd"], kern["flash_attention_bwd"]["timing"]
    bwd_n, bwd_by = launches("flash_attention_bwd")
    return {
        "kernels": [
            {
                "name": "flash_attention",
                "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:30",
                "launches": fa_n,
                "launches_by_path": fa_by,
                "max_abs_err": fa["max_abs_err"],
                "ms": t_fa["ms"],
                "plain_ms": t_fa["plain_ms"],
                "bound_ms": t_fa["bound_ms"],
                "bound_by": t_fa["bound_by"],
                "library_ms": t_fa["library_ms"],
                "device_ms": t_fa["device_ms"],
                "library_device_ms": t_fa["library_device_ms"],
                "design": fa_design(torch.bfloat16, 64),
                "at": "B=1 H=32 KV=4 Dh=64 Sq=Sk=512 bf16 causal",
            },
            {
                "name": "ssd",
                "route": "cuda",
                "source": "src/repro_torch/csrc/ssd.cu",
                "replaces": "src/repro/kernels/ssd.py:29",
                "launches": ssd_n,
                "launches_by_path": ssd_by,
                "max_abs_err": ssd["max_abs_err"],
                "max_scaled_err": ssd["max_scaled_err"],
                "ms": t_ssd["ms"],
                "plain_ms": t_ssd["plain_ms"],
                "bound_ms": t_ssd["bound_ms"],
                "bound_by": t_ssd["bound_by"],
                "library_ms": t_ssd["library_ms"],
                "device_ms": t_ssd["device_ms"],
                "library_device_ms": t_ssd["library_device_ms"],
                "design": SSD_DESIGNS[torch.bfloat16],
                "at": "B=1 S=512 H=64 P=64 N=128 chunk 256 bf16, with the final state",
            },
            {
                "name": "flash_attention_bwd",
                "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                # the Pallas kernel has no VJP: the reference differentiates
                # the dense einsum through XLA
                "replaces": "src/repro/models/attention.py:58",
                "launches": bwd_n,
                "launches_by_path": bwd_by,
                "launch_unit": "one set of three kernels (preprocess, dK/dV, dQ)",
                "max_abs_err": bwd["max_abs_err"],
                "max_scaled_err": bwd["max_scaled_err"],
                "max_ulp_err_bf16": bwd["max_ulp_err"],
                "ms": t_bwd["ms"],
                "plain_ms": t_bwd["plain_ms"],
                "bound_ms": t_bwd["bound_ms"],
                "bound_by": t_bwd["bound_by"],
                "library_ms": t_bwd["library_ms"],
                "device_ms": t_bwd["device_ms"],
                "library_device_ms": t_bwd["library_device_ms"],
                "design": "fma",
                "at": "B=4 H=32 KV=4 Dh=64 Sq=Sk=2048 bf16 causal; library: the autograd "
                      "backward of F.scaled_dot_product_attention",
            },
        ]
    }


def main() -> int:
    # one card: the first, unless the caller chose the visible devices
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails first in a directory without the port)

    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    kern.update(phase_flash_bwd())
    kern.update(phase_ssd_kernels())
    emit("timing", kernels_phases_s=time.perf_counter() - t0)
    serves = [phase_serve(arch, serve_kw, path_kernels) for arch, serve_kw, path_kernels in PATHS]
    emit("timing", serve_phases_s=time.perf_counter() - t0)
    train = phase_train()
    phase_train_parity()
    emit("timing", total_s=time.perf_counter() - t0)
    print(json.dumps(_kernel_line(kern, serves, train)))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
