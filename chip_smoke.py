#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every hand-written kernel from ``src/repro_torch/csrc`` with nvcc
(flash attention and the SSD scan, one nvcc each, started together), holds
each against its plain PyTorch version on the card in bf16 (the
tensor-core design) and f32 (the FMA design), and times the bf16 kernel,
its plain version and, where there is one, the PyTorch call computing the
same function: by CUDA events over back-to-back eager calls, and as device
time by CUDA-graph replay. It then serves three full-width models (random
weights from seed 0) through ``repro_torch.ServeEngine``, one after
another: tinyllama-1.1b (flash attention prefill), mamba2-1.3b (SSD
prefill) and hymba-1.5b (both). Each is served once in float32 against the
port's own sequential batch-1 decode and once in bfloat16 as its measured
main path, with every kernel's launch counter set to 0 just before that run
and read just after, followed by host times and profiler traces of one
S=300 prefill and one 4-lane decode step. Each phase prints one JSON line;
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

KERNEL_SOURCES = ("flash_attention", "ssd")


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


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bhsd
    from repro_torch.kernels.flash_attention import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 1e-4}
    # (label, B, H, KV, Sq, Sk, Dh, causal, window, k_len, model_layout)
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
    worst = 0.0
    for i, case in enumerate(cases):
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


def _traced(fn) -> dict:
    """One call of ``fn`` under the profiler: host-clock ms to the end of its
    device work, the device-busy ms (the sum of its kernels' durations on the
    one stream), the idle share, the launch count, and the device ms of the
    port's kernels by name (K1 ``flash_fwd_*``, K2 ``ssd_*``)."""
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
    for e in kernels:
        name = re.search(r"(flash_fwd_\w+|ssd_\w+)", e.name)
        if name:
            ports[name.group(1)] = ports.get(name.group(1), 0.0) + e.time_range.elapsed_us() / 1e3
    return {
        "traced_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms else None,
        "kernel_launches": len(kernels),
        "k1_device_ms": sum(v for k, v in ports.items() if k.startswith("flash_fwd")),
        "k2_device_ms": sum(v for k, v in ports.items() if k.startswith("ssd_")),
        "port_kernels_device_ms": ports,
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


def phase_serve(arch: str, serve_kw: dict, path_kernels: tuple) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(arch)
    prompts = _prompts(base.vocab_size)

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
    gc.collect()  # the closed engine sits in a reference cycle holding the f32 weights
    torch.cuda.empty_cache()

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


def _kernel_line(kern: dict, serves: list) -> dict:
    """The kernels JSON line: launches summed over the served paths' measured
    runs (and listed per path), the rest from the kernels phases; ``design``
    names the bf16 kernel's instruction path."""
    import torch

    from repro_torch.kernels.flash_attention import design as fa_design
    from repro_torch.kernels.ssd import DESIGNS as SSD_DESIGNS

    def launches(name):
        by_path = {s["arch"]: s["launches"][name] for s in serves}
        return sum(by_path.values()), by_path

    fa, t_fa = kern["flash_attention"], kern["flash_attention"]["timings"]["tinyllama S=512"]
    ssd, t_ssd = kern["ssd"], kern["ssd"]["timings"]["mamba2 S=512"]
    fa_n, fa_by = launches("flash_attention")
    ssd_n, ssd_by = launches("ssd")
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
    kern.update(phase_ssd_kernels())
    emit("timing", kernels_phases_s=time.perf_counter() - t0)
    serves = [phase_serve(arch, serve_kw, path_kernels) for arch, serve_kw, path_kernels in PATHS]
    emit("timing", total_s=time.perf_counter() - t0)
    print(json.dumps(_kernel_line(kern, serves)))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
