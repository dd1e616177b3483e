#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every hand-written kernel from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card and times it, then
serves full-width tinyllama-1.1b (random weights from seed 0) through
``repro_torch.ServeEngine``: once in float32 against the port's own
sequential batch-1 decode, once in bfloat16 as the measured main path, with
the kernels' launch counters read around that run. Each phase prints one
JSON line; any failure exits non-zero. The last two lines are the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.

It imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import gc
import json
import os
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

ARCH = "tinyllama-1.1b"
SERVE = dict(max_slots=4, max_len=1024, page_size=64)
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

KERNEL_SOURCES = ("flash_attention",)


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
    for S in (512, 1024):
        B, H, KV, Dh = 1, 32, 4, 64
        q, k, v = _qkv(B, H, KV, S, S, Dh, bf16, seed=100 + S, model_layout=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))
        ms = _time_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = _time_ms(lambda: flash_attention_ref(qt, kt, vt, causal=True))
        library_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
        )
        bound_ms, bound_by = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS)
        timings[S] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        emit("kernels", kernel="flash_attention", timing=f"tinyllama causal bf16 Sq=Sk={S}",
             **timings[S])
    return {"flash_attention": {"max_abs_err": worst, "timings": timings}}


# -- serve ----------------------------------------------------------------------


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def _sequential(model, params, prompt, budget, width):
    """The port's own batch-1 path: prefill, then decode_step one token at a
    time, provisioned at the engine's width. Returns tokens and each step's
    top-2 logit gap."""
    import torch

    from repro_torch.models.lm import extend_caches

    logits, caches = model.prefill(params, {"tokens": prompt[None]})
    caches = extend_caches(caches, width - prompt.size)
    toks, gaps = [], []
    for i in range(budget):
        top = torch.topk(logits[0, -1].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        toks.append(int(torch.argmax(logits[0, -1])))
        if i + 1 < budget:
            logits, caches = model.decode_step(params, [[toks[-1]]], caches, [prompt.size + i])
    return toks, gaps


def _serve(model, params, prompts):
    import torch

    from repro_torch.serve import ServeEngine

    with ServeEngine(model, params, **SERVE) as engine:
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


def _layer_times(model, params) -> dict:
    """Host-clock times of one prefill and one 4-lane decode step at full
    width, and the device-busy share of the decode step from a profiler
    trace (the sum of its kernels' durations on the one stream)."""
    import torch

    cfg = model.cfg
    S, lanes, width = 300, SERVE["max_slots"], SERVE["max_len"]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S))
    caches = model.cache_shapes(lanes, width)
    caches = {g: {"attn": {k: torch.zeros(m.shape, dtype=m.dtype, device=model.device)
                           for k, m in c["attn"].items()}} for g, c in caches.items()}
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

    prefill_ms = host_ms(lambda: model.prefill(params, {"tokens": tokens}), 5)
    decode_ms = host_ms(lambda: model.decode_step(params, tok, caches, idx), 10)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, tok, caches, idx)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {
        "prefill_ms_S300": prefill_ms,
        "decode_step_ms_4lanes": decode_ms,
        "decode_traced_ms": traced_ms,
        "decode_device_busy_ms": busy_ms,
        "decode_device_idle_share": 1.0 - busy_ms / traced_ms if traced_ms else None,
        "decode_kernel_launches": len(kernels),
    }


def phase_serve() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(ARCH)
    prompts = _prompts(base.vocab_size)

    # f32, TF32 off: the engine against sequential batch-1 decode
    model = build_model(base.replace(dtype="float32"))
    params = model.init(seed=0)
    outs, _marks, wall, stats = _serve(model, params, prompts)
    mismatches = []
    for r, (prompt, out) in enumerate(zip(prompts, outs)):
        ref, gaps = _sequential(model, params, prompt, NEW_TOKENS, SERVE["max_len"])
        if out != ref:
            i = next(j for j, (a, b) in enumerate(zip(out, ref)) if a != b)
            mismatches.append({"request": r, "step": i, "top2_gap": gaps[i]})
    emit("serve", dtype="float32", requests=len(prompts), wall_s=wall, ticks=stats["ticks"],
         preemptions=stats["preemptions"], mismatches=mismatches)
    for m in mismatches:
        check(m["top2_gap"] < TIE_GAP,
              f"float32 engine tokens differ from sequential decode at a gap of {m['top2_gap']}")
    del model, params
    gc.collect()  # the closed engine sits in a reference cycle holding the f32 weights
    torch.cuda.empty_cache()

    # bf16: the measured main path, warmed up by one request first
    model = build_model(base.replace(dtype="bfloat16"))
    params = model.init(seed=0)
    _serve(model, params, prompts[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_bhsd.launches = 0
    outs, marks, wall, stats = _serve(model, params, prompts)
    launches = flash_attention_bhsd.launches
    prefills = len(prompts) + stats["preemptions"]
    n_tok = sum(len(o) for o in outs)
    ttft = [m["ttft"] for m in marks]
    res = {
        "dtype": "bfloat16",
        "requests": len(prompts),
        "prompt_lens": [int(p.size) for p in prompts],
        "tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        # TTFT = admission wait + prefill + wait for a slot, per request
        "ttft_parts_s": {k: [m[k] for m in marks] for k in ("admit", "prefill", "slot_wait")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ticks": stats["ticks"],
        "preemptions": stats["preemptions"],
        "flash_attention_launches": launches,
        "prefills": prefills,
    }
    emit("serve", **res)
    emit("layers", **_layer_times(model, params))
    check(all(len(o) == NEW_TOKENS and all(0 <= t < base.vocab_size for t in o) for o in outs),
          "bf16 run: a request came back short or with an out-of-vocabulary token")
    check(launches >= base.num_layers * prefills,
          f"flash kernel launched {launches} times for {prefills} prefills of "
          f"{base.num_layers} layers")
    return res


def main() -> int:
    # one card: the first, unless the caller chose the visible devices
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails first in a directory without the port)

    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    serve = phase_serve()
    fa = kern["flash_attention"]
    t512 = fa["timings"][512]
    line = {
        "kernels": [
            {
                "name": "flash_attention",
                "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:30",
                "launches": serve["flash_attention_launches"],
                "max_abs_err": fa["max_abs_err"],
                "ms": t512["ms"],
                "plain_ms": t512["plain_ms"],
                "bound_ms": t512["bound_ms"],
                "bound_by": t512["bound_by"],
                "library_ms": t512["library_ms"],
                "at": "B=1 H=32 KV=4 Dh=64 Sq=Sk=512 bf16 causal",
            }
        ]
    }
    print(json.dumps(line))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
