#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds every hand-written kernel from ``src/repro_torch/csrc`` with nvcc
(flash attention and its backward, the SSD scan and its backward, one nvcc
each, started together) and holds each against its plain PyTorch version on
the card in bf16 (the served and trained designs) and f32 (the parity
designs): flash attention's backward also at the training shapes of
tinyllama, hymba, whisper (encoder S=1500, cross-attention Sq=448 over
Sk=1500, decoder causal S=448), paligemma (Dqk=Dv=256 under the prefix
span, its own instantiations, the q-heads split over CTAs; the build fails
if they or the 192/128 ones spill) and, in both dtypes with two launches
bit for bit, deepseek-v2 (Dqk=192, Dv=128, its own instantiation, at the
``deepseek_train`` phase's sequence), each with its device ms by launch,
in bf16 also
in ulps, beside a lower-precision control and SDPA's own backward, the SSD
scan's backward over the scan's sweep and at
mamba2's and hymba's training shapes (two launches bit for bit; in bf16 also
in ulps, beside the tensor-core design with its split operands rounded
once). It times
each bf16 kernel, its plain version and, where there is one, the PyTorch
call computing the same function: by CUDA events over back-to-back eager
calls, and as device time by CUDA-graph replay (for SDPA's autograd
backward, by a profiler trace).

K1 is also held and timed at deepseek-v2's expanded MLA prefill (H = KV =
128, Dqk = 192, Dv = 128, its own instantiation), beside SDPA where SDPA
takes Dv != Dqk on the card, and at the enc-dec and VLM prefills' shapes
(B=4): paligemma's (H=8 on one kv-head, Dqk = Dv = 256, its own
instantiation, S=320 under a prefix-LM span over the first 256 positions;
the build fails if K1's instantiations at 192/128 or 256/256 spill),
and at the two wide pairs' training shapes (deepseek-v2 S=2048,
paligemma S=512 under its prefix span; two launches bit for bit, timed
beside the plain version, SDPA and the bound), at 128/128 (the dense
configs' "wgmma-wide" and "wgmma-split-2wg" forms; the build fails if one
of their instantiations spills) at phi4-mini's and qwen1.5's training
shapes (K1 and K1-bwd, S=2048, B=4) and the three head-dim-128 configs'
S=512 prefills, whisper's encoder (H=KV=16,
Dh=64, S=1500, non-causal), decoder self-attention (causal, S=32, one ragged
tile) and cross-attention (Sq=32 over Sk=1500), beside SDPA (with the
boolean causal or prefix-LM mask where the case has one). K1 and K1-bwd
are held and timed in f32 too at the training tutorial's shape (B=8, H=12,
KV=4, Dh=64, S=256, causal; the FMA designs), their bound at the f32 peak
outside the tensor cores (67 TFLOP/s), beside SDPA in f32.

It then serves eight full-width models (random weights from seed 0) through
``repro_torch.ServeEngine``, one after another: tinyllama-1.1b (flash
attention prefill), mamba2-1.3b (SSD prefill), hymba-1.5b (both),
granite-moe-1b-a400m (MoE, KV heads zero-padded to 16), deepseek-v2-236b
(MLA and MoE, its depth cut to 2 layers in f32 and 9 in bf16, printed as
``reduced``), phi4-mini-3.8b and qwen1.5-4b (K1 at 128/128, full depth
in bf16; every f32 gate but deepseek-v2's and deepseek-coder's at 8
layers, printed as ``reduced``) and deepseek-coder-33b (2 layers in f32, in bf16 the depth of the dry
run's serve plan: the deepest whose predicted peak, a B=4 prefill at 512
beside the engine's caches, leaves 10 GB of the card free). The engine
runs every decode tick, and the bucketed prefills of all but mamba2 and
hymba, by replaying CUDA graphs it captured when it was built. Each model is served once in float32 against
the port's own sequential batch-1 decode and once in bfloat16 as its
measured main path, with every kernel's launch counter set to 0 just before
that run and read just after (a graph's replays count the launches its
capture recorded), and every tick checked to be a graph replay; then host
times and profiler traces of one S=300 prefill and one 4-lane decode step,
eager beside the captured tick (the host's launches per tick, at most 10 by
graph). Then it serves whisper-medium (24 encoder and 24 decoder layers)
and paligemma-3b (18 layers, vocabulary 257216), whose families the engine
does not serve, through ``Model.prefill``, ``extend_caches`` and greedy
``decode_step`` at full width and depth: 4 requests, frames (4, 1500, 1024)
or patches (4, 256, 1152) from a seeded generator, a 32- or 64-token prompt
and 32 new tokens, in f32 through the kernels against the same run with the
model's attention patched to the plain versions (logits and caches within
1e-4 scaled, tokens equal but at near-ties), then in bf16 as the measured
path (the run's prefill ms, decode ms a step and tokens/s, traced
device-busy ms with whisper's encoder split out, peak memory, every
kernel's launches, K1's 72 or 18 a prefill). It then trains tinyllama,
mamba2, hymba, granite-moe, whisper-medium and paligemma-3b at full width
and depth (paligemma's cut to 9 of 18 layers) for a few bf16 steps each through ``repro_torch.runtime.Trainer``
(B=4, S=2048, remat; whisper 448 text tokens over 1500 frames and
paligemma 256 patches and 256 text tokens from the cells' data source
``EncDecVLMTokens``; checking every kernel's launches a step, the losses
and the MoE aux loss, that every leaf took a gradient, its master moved
and every bf16 leaf is its master rounded, the AdamW state and the final
checkpoint, saved into ``build/`` and deleted). The Trainer runs each
step as one CUDA graph (``repro_torch.runtime.graph``: an eager warm-up
step, then a captured step replayed), held against the same steps run
eagerly on a fresh state first: every step's metrics and every leaf of
the state equal bit for bit (a ``train_graph`` line a cell: capture
seconds, replays, the launches captured by kernel, and graph beside
eager: step s, traced busy ms, idle share, host launches a step, peak
allocated and reserved bytes); the launch check counts the warm-up's
launches plus replays x captured. Then the port's entry points as a user
runs them, each a process of its own on the card (``train_lm``): the
training tutorial ``examples/train_lm_torch.py`` at its defaults with
``--fail`` (124.6 M parameters, f32, B=8, S=256, 300 steps, restarted
from its step-150 checkpoint into a new capture; K1 and K1-bwd 12 launches
a step each), the serving example and ``repro_torch.launch.train`` on
reduced tinyllama with a restart. It holds each model's full-width f32
gradients through the kernels against those through the plain versions. Then deepseek-v2-236b (MLA and MoE) trains at full width on
the card (``deepseek_train``): its depth and sequence from the dry run
(``repro_torch.launch.dryrun``, run on the host in a process of its own
beside the card's phases: the deepest depth, at least its dense layer 0
and one MoE layer, whose predicted peak leaves 10 GB of the card free,
then the longest of S=2048, 1024 and 512 that does), B=1, AdamW's moments
in bf16 (the reference's rule over 1e11 parameters), a few bf16 steps of
``Trainer``'s step with the train cells' gates, tokens/s, the model-FLOP
share, the peak beside the prediction and a traced step, through the
train graph held against the eager steps as the train cells are, then its f32
gradients at depth 2, S=256 through the kernels against the plain
versions'. Then phi4-mini-3.8b and qwen1.5-4b (``dense_train``) the same
way at the train cells' B=4, S=2048, each at the deepest depth, walked
down from its full depth, whose predicted peak leaves 10 GB of the card
free, f32 moments, their f32 gradient gate at full depth, B=1, S=256. The
``dryrun`` phase prints the dry run's predicted peak of every train cell
and every plan beside the peak its phase measured, and one full-width
cell on a fake world of 256 ranks (tinyllama ``train_4k`` on 16x16).
Last, the parallelism layer (``repro_torch.parallel``) on
an NCCL process group of one rank and its (data=1, model=1) mesh: the
sharded f32 train step of tinyllama (B=1, S=256) against the single-device
Trainer step (1e-5 scaled), granite-moe's expert-parallel step at capacity
E/K against ``moe_dense``'s (1e-4), tinyllama trained in bf16 at the train
cell's shape through ``Trainer(mesh=)`` (K1 44 and K1-bwd 22 launches a
step, as on one device), its steps one CUDA graph (the sharded step's,
``parallel.steps``) held bit for bit against the eager sharded body on a
fresh state, with at most 6 host launches a replayed step (a
``train_graph`` line, as the train cells'), and 16 greedy tokens through
the sharded prefill and decode step, by their eager bodies and by their
graphs (bit for bit), equal to ``Model.prefill``/``decode_step``'s. The
families (``parallel_families``) the same way on the mesh of one, depth
cut. Then the
pipeline (``repro_torch.parallel.pipeline``, its tick table simulated by
the paper's scheduler) on a ("pod",) mesh of one rank over NCCL:
11 of tinyllama's 22 decoder layers as the stage, the embedding before it
and ``Model.head_loss`` as the loss, M=4 microbatches; in f32 (B=1, S=256)
the pipelined loss and every gradient against the serial ones over the same
microbatches (1e-5 scaled, the worst leaf printed), in bf16 at the train
cell's width (B=1 microbatches at S=2048, remat) K1 at exactly 2 x 11 x M
launches a step and K1-bwd at 11 x M, the step timed and traced beside the
serial step. Last, the pool on the host after the card is in use: one
graph (a condition loop, a subflow, dataflow edges) through ``Executor``
on the serial, thread, process and socket backends with equal results, a
seeded ``FaultInjector`` with the same schedule on each, ``verify="strict"``
passing a clean graph and refusing a planted race, a CUDA call in a forked
worker failing with torch's error, and the process ``Prefetcher``'s
batches, put on the card by the consumer, equal bit for bit to the thread
one's. Each phase prints one JSON line; any failure exits non-zero. The last three lines are
the kernels line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --k1-wide`` runs only K1 at the wide pairs'
main-path shapes (deepseek-v2's MLA prefill S=512 and training S=2048,
paligemma's prefill S=320 and training S=512 under the prefix span, the
head-dim-128 configs' training S=2048 and prefill S=512: :data:`K1_128`)
and K1-bwd at 128/128's two training shapes, with the kernels phases'
inputs, gates and timings and the ptxas registers and spills. Copied into
the root of another checkout (a parent commit, or a trial, unpacked under
``build/``) it reads that checkout's kernels the same way, so that two
forms compare within one chip call.

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

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of every kernel;
# the f32 kernels run FMA tiles, outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the served paths, in order: (arch, engine settings, kernels every prefill
# launches once per layer, depth by dtype where the full depth does not fit
# the card). tinyllama's, granite-moe's and deepseek-v2's prompts are padded
# to buckets that cover PROMPT_RANGE, so their prefills replay captured
# graphs; hymba's max_len stays above its window of 1024, so its window
# layers serve from ring caches. deepseek-v2 keeps its full width and is cut
# in depth: at 2 layers (the dense layer 0, one MoE layer of 160 experts;
# 5.36 B parameters, 21.4 GB) in f32, at 9 (33.2 B, 66.3 GB) in bf16, which
# peaks at 67.6 GB with the graphs' pools: each further layer adds 7.9 GB,
# and 9 is the deepest that keeps 10 GB of the card's 85 GB free. The head
# dim 128 dense configs run K1 at 128/128 with their KV heads zero-padded
# (kv_pad_to): phi4-mini-3.8b (48/16 heads, tied head) and qwen1.5-4b
# (32/32, QKV biases) at full depth, deepseek-coder-33b (112/16) in f32 at
# 2 layers and in bf16 at the dry run's depth (SERVE_PLANNED: its 62
# layers' weights alone are 81.25 GB). Every path's f32 gate (engine tokens
# against sequential decode) but deepseek-v2's and deepseek-coder's runs at
# F32_GATE_LAYERS of its repeated layers, to keep the script inside its
# time limit (tinyllama's, mamba2's and hymba's since the train_lm phase
# came; hymba's then holds one global layer, 0, beside seven window
# layers); every bf16 run but those two keeps the full depth
F32_GATE_LAYERS = 8
F32_GATE = {"float32": F32_GATE_LAYERS, "bfloat16": None}
BUCKETED = dict(max_slots=4, max_len=1024, page_size=64, prefill_buckets=(128, 256, 512))
PATHS = (
    ("tinyllama-1.1b", BUCKETED, ("flash_attention",), F32_GATE),
    ("mamba2-1.3b", dict(max_slots=4, max_len=1024, page_size=64), ("ssd",), F32_GATE),
    ("hymba-1.5b", dict(max_slots=4, max_len=2048, page_size=64), ("flash_attention", "ssd"),
     F32_GATE),
    ("granite-moe-1b-a400m", BUCKETED, ("flash_attention",), F32_GATE),
    ("deepseek-v2-236b", BUCKETED, ("flash_attention",), {"float32": 2, "bfloat16": 9}),
    ("phi4-mini-3.8b", BUCKETED, ("flash_attention",), F32_GATE),
    ("qwen1.5-4b", BUCKETED, ("flash_attention",), F32_GATE),
    # the bf16 depth from the dry run's serve plan (SERVE_PLANNED)
    ("deepseek-coder-33b", BUCKETED, ("flash_attention",), {"float32": 2, "bfloat16": None}),
)
N_REQUESTS, NEW_TOKENS, PROMPT_RANGE = 8, 32, (64, 512)
# the rounds a path without prompt buckets serves its prompts on one engine:
# the first prefills each length eagerly, the second captures each length's
# graph and replays it, the third replays only. In bf16, DRAWN_ROUNDS more
# rounds then serve N_REQUESTS prompts each of lengths drawn anew from
# PROMPT_RANGE, which rarely repeat: the traffic that pays for first sights
# and captures without the replays, each round comparable to the first
REPEAT_ROUNDS = 3
DRAWN_ROUNDS = 3
TIE_GAP = 1e-3  # a token mismatch at a top-2 logit gap below this is a near-tie
# the host's calls that put work on the card, as the profiler names them
HOST_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch|cudaMemcpyAsync)")
MAX_TICK_HOST_LAUNCHES = 10  # a 4-lane decode tick by graph replay


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

def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as ex:  # one nvcc per source, together
        list(ex.map(build.library, build.SOURCES))
    for name in build.SOURCES:
        log = build.build_log[name]
        emit("build", source=f"src/repro_torch/csrc/{name}.cu", nvcc_s=log["seconds"],
             cached=log["cached"], ptxas=log["ptxas"], resources=ptxas_resources(log["ptxas"]))
    # K1's wide pairs hold a 64-row output fragment of 64 (192/128, under
    # the 128 registers of two CTAs an SM) or 128 (256/256) f32 registers a
    # thread beside the score fragment, and K1-bwd's 96 to 128 dK, dV or dQ
    # accumulators a thread: none of their instantiations may spill
    wide = _wide_resources(build)
    check(len(wide["flash_attention"]) == 4 and len(wide["flash_attention_bwd"]) == 12
          and all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for res in wide.values() for v in res.values()),
          f"K1's or K1-bwd's wide instantiations spill or are missing: {wide}")
    # and at 128/128, the head-dim-128 configs' pair: 64 output (or dK, dV,
    # dQ) accumulators a thread beside the score fragment
    dh128 = _dh128_resources(build)
    check(len(dh128["flash_attention"]) == 2 and len(dh128["flash_attention_bwd"]) == 7
          and all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for res in dh128.values() for v in res.values()),
          f"K1's or K1-bwd's 128/128 instantiations spill or are missing: {dh128}")
    version = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[-1]
    cudart = _mapped_cudart()
    emit("build", total_s=time.perf_counter() - t0, nvcc=version, cudart=cudart)
    check(len(cudart) == 1,
          f"the kernel libraries and PyTorch must share one CUDA runtime; mapped: {cudart}")


def _wide_resources(build) -> dict:
    """ptxas registers and spills of K1's and K1-bwd's instantiations at
    256/256 and 192/128, per library: K1's bf16 ``flash_fwd_wide`` and f32
    ``flash_fwd_f32`` at each (4); K1-bwd's at 256 the preprocess in both
    dtypes, f32 dK/dV and dQ, bf16 ``bwd_dkdv_wg2``, ``bwd_dkdv_reduce``
    and ``bwd_dq_wg`` (7), at 192/128 the same but the preprocess, which is
    128/128's (5)."""
    bwd = ptxas_resources(build.build_log["flash_attention_bwd"]["ptxas"])
    return {"flash_attention": _wide_resources_of(build.build_log["flash_attention"]["ptxas"]),
            "flash_attention_bwd": {k: v for k, v in bwd.items()
                                    if re.search(r"<(?:(?:\w+,)?256|192,128)(?:,|>)", k)}}


def _dh128_resources(build) -> dict:
    """ptxas registers and spills of K1's and K1-bwd's instantiations at
    128/128, per library: K1's bf16 ``flash_fwd_wide`` and f32
    ``flash_fwd_f32`` (2); K1-bwd's preprocess in both dtypes (192/128's
    too: it is templated on Dv), f32 dK/dV and dQ, bf16 ``bwd_dkdv_wg2``,
    ``bwd_dkdv_reduce`` and ``bwd_dq_wg`` (7)."""
    fwd = ptxas_resources(build.build_log["flash_attention"]["ptxas"])
    bwd = ptxas_resources(build.build_log["flash_attention_bwd"]["ptxas"])
    return {"flash_attention": {k: v for k, v in fwd.items() if re.search(r"<128,128>", k)},
            "flash_attention_bwd": {k: v for k, v in bwd.items()
                                    if re.search(r"<(?:bf16,128|float,128|128,128(?:,\d+)?)>",
                                                 k)}}


def _wide_resources_of(ptxas: list) -> dict:
    """ptxas registers and spills of K1's instantiations at 192/128 and
    256/256 in one ``ptxas -v`` report of the forward's library."""
    return {k: v for k, v in ptxas_resources(ptxas).items()
            if re.search(r"<(?:192,128|256,256)(?:,|>)", k)}


def _kernel_label(mangled: str) -> str:
    """``bwd_dq_mma<64,true>`` or ``bwd_dkdv<float,128>`` from an Itanium-mangled
    kernel name in an anonymous namespace (``_ZN<len><name>...I...E``)."""
    i = mangled.find("_ZN") + 3
    name = mangled
    while 2 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j : j + n], j + n
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    type_arg = re.match(r"I(f|13__nv_bfloat16)", mangled[i:])
    args = re.findall(r"L([ib])(\d+)E", mangled[i:])
    values = [v if kind == "i" else ("true" if v == "1" else "false") for kind, v in args]
    return f"{name}<{','.join(([types[type_arg.group(1)]] if type_arg else []) + values)}>"


def ptxas_resources(lines: list) -> dict:
    """Registers and spill bytes of each kernel instantiation in a ``ptxas
    -v`` report, keyed by :func:`_kernel_label`."""
    out, current = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            current = _kernel_label(m.group(1))
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def _mapped_cudart() -> list:
    """The CUDA runtime libraries mapped into this process."""
    with open("/proc/self/maps") as f:
        paths = {ln.split()[-1] for ln in f if "libcudart" in ln}
    return sorted(os.path.realpath(p) for p in paths)


# -- kernels --------------------------------------------------------------------


def _qkv(B, H, KV, Sq, Sk, Dh, dtype, seed, model_layout, Dv=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda", 0)
    Dv = Dh if Dv is None else Dv
    if model_layout:  # (B, S, H, Dh), as the model's prefill hands them over
        shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dv)]
    else:
        shapes = [(B, H, Sq, Dh), (B, KV, Sk, Dh), (B, KV, Sk, Dv)]
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


def _host_ms(fn, n: int) -> float:
    """Host-clock ms of one of ``n`` back-to-back calls, to the end of their
    device work, after one call outside the clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


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


def _attention_bound(B, H, KV, Sq, Sk, Dh, elem_bytes, causal, peak_flops, Dv=None,
                     prefix_len=None, window=None):
    """Least time for the work: each input read once, the output written
    once; FLOPs over the (q, k) pairs the mask leaves visible
    (``analysis.roofline.visible_pairs``), 2 Dh for Q·Kᵀ and 2 Dv for P·V per pair and
    head."""
    from repro_torch.analysis.roofline import attention_cost

    Dv = Dh if Dv is None else Dv
    flops, nbytes = attention_cost(B, H, KV, Sq, Sk, Dh, Dv, elem_bytes, causal=causal,
                                   window=window, prefix_len=prefix_len)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# deepseek-v2's expanded MLA prefill at full width: H = KV = 128, Dqk = 128
# nope + 64 rope, Dv = 128 (the kernels phase's check and timing)
MLA_K1 = dict(B=1, H=128, KV=128, S=512, Dh=192, Dv=128)
# its training attention (K1-bwd's 192/128 instantiation), at the
# deepseek_train phase's B and sequence
DEEPSEEK_TRAIN_ATTN = dict(B=1, H=128, KV=128, Dh=192, Dv=128)
# the enc-dec and VLM prefills' K1 shapes at full width, B=4 (the kernels
# phase's checks and timings): paligemma's gemma backbone (MQA, Dh=256,
# the 256 image tokens a prefix-LM span before a 64-token prompt), and
# whisper's encoder over its 1500 frames, its decoder's causal 32-token
# prompt (one ragged tile) and the decoder's cross-attention from that
# prompt over the frames (Dh=64): (label, B, H, KV, Sq, Sk, Dh, causal,
# prefix_len)
ENCDEC_VLM_K1 = (
    ("paligemma prefill S=320 prefix 256", 4, 8, 1, 320, 320, 256, True, 256),
    ("whisper encoder S=1500", 4, 16, 16, 1500, 1500, 64, False, None),
    ("whisper decoder causal S=32", 4, 16, 16, 32, 32, 64, True, None),
    ("whisper cross Sq=32 Sk=1500", 4, 16, 16, 32, 1500, 64, False, None),
)


def _flash_cases() -> list:
    """K1's sweep, each case in bf16 and f32: (label, B, H, KV, Sq, Sk, Dh,
    causal, window, k_len, model_layout, dtype[, Dv[, prefix_len]])."""
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
            # the dense head-dim-128 configs' head layouts (GQA groups of 3,
            # 1 and 7, as kv_pad_to leaves them), ragged
            ("Dh=128 G=3 ragged S=445", 1, 6, 2, 445, 445, 128, True, None, None, True, dt),
            ("Dh=128 G=1 B=2 S=257 k_len=200", 2, 4, 4, 257, 257, 128, True, None, 200, True,
             dt),
            ("Dh=128 G=7 window 77 S=300", 1, 14, 2, 300, 300, 128, True, 77, None, True, dt),
            # hymba's prefill: H=25 KV=5 (a group of 5), global and window layers
            ("hymba global S=300", 1, 25, 5, 300, 300, 64, True, None, None, True, dt),
            ("hymba window=1024 S=300", 1, 25, 5, 300, 300, 64, True, 1024, None, True, dt),
            ("hymba window=1024 S=1100", 1, 25, 5, 1100, 1100, 64, True, 1024, None, True, dt),
        ]
    # the MoE paths' prefill shapes (granite-moe: KV heads padded to 16;
    # deepseek-v2: MLA at Dqk=192, Dv=128, the last entry of each case)
    m = MLA_K1
    for dt in (bf16, f32):
        cases += [
            ("granite-moe causal S=512 H=32 KV=16", 1, 32, 16, 512, 512, 64, True, None, None,
             True, dt),
            ("deepseek MLA causal S=512 Dqk=192 Dv=128", m["B"], m["H"], m["KV"], m["S"],
             m["S"], m["Dh"], True, None, None, True, dt, m["Dv"]),
            ("MLA Dqk=192 Dv=128 GQA ragged S=300", 1, 8, 2, 300, 300, 192, True, None, None,
             True, dt, 128),
            ("MLA Dqk=192 Dv=128 k_len=100 Sk=128", 2, 4, 4, 128, 128, 192, True, None, 100,
             False, dt, 128),
            ("MLA Dqk=192 Dv=128 B=2 ragged S=257", 2, 8, 8, 257, 257, 192, True, None, None,
             True, dt, 128),
            ("MLA Dqk=192 Dv=128 B=2 k_len=200 S=257", 2, 8, 8, 257, 257, 192, True, None, 200,
             True, dt, 128),
        ]
    # the enc-dec and VLM paths: paligemma's Dh=256 with its prefix span
    # (and the span's tile edges), whisper's non-causal forms at Dh=64
    for dt in (bf16, f32):
        for label, B, H, KV, Sq, Sk, Dh, causal, prefix in ENCDEC_VLM_K1:
            cases.append((label, B, H, KV, Sq, Sk, Dh, causal, None, None, True, dt, Dh, prefix))
        cases += [
            ("Dh=256 MQA ragged S=130 prefix 65", 1, 8, 1, 130, 130, 256, True, None, None, True,
             dt, 256, 65),
            ("Dh=256 MQA S=320 prefix 64", 2, 8, 1, 320, 320, 256, True, None, None, True, dt,
             256, 64),
            ("Dh=256 causal S=200 no prefix", 1, 4, 2, 200, 200, 256, True, None, None, False,
             dt, 256, None),
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
    mla_errs, dh256_errs = {}, {}
    for i, case in enumerate(_flash_cases()):
        label, B, H, KV, Sq, Sk, Dh, causal, window, k_len, model_layout, dt = case[:12]
        Dv = case[12] if len(case) > 12 else Dh
        prefix = case[13] if len(case) > 13 else None
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, dt, seed=i, model_layout=model_layout, Dv=Dv)
        kw = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix)
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
             shape=[B, H, KV, Sq, Sk, Dh, Dv], prefix_len=prefix, max_abs_err=err, tol=tol[dt],
             ok=ok, **where)
        check(ok, f"flash_attention {label} {dt}: max_abs_err {err} > {tol[dt]}")
        worst = max(worst, err)
        key = str(dt).split(".")[-1]
        if Dv != Dh:
            mla_errs[key] = max(mla_errs.get(key, 0.0), err)
        if Dh == 256:
            dh256_errs[key] = max(dh256_errs.get(key, 0.0), err)

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
    timings["deepseek MLA S=512"] = _mla_timing()
    timings.update(_encdec_vlm_timings())
    train = _wide_train_timings()
    return {"flash_attention": {"max_abs_err": worst, "timings": timings, "train": train,
                                "dh128": _k1_128_timings(), "mla_max_abs_err": mla_errs,
                                "dh256_max_abs_err": dh256_errs, "train_lm": _train_lm_k1()}}


# the training tutorial's attention (examples/train_lm_torch.py at its
# defaults: 12 heads in groups of 3, head dim 64, B=8, S=256, causal, f32,
# so the FMA designs): (B, H, KV, S, Dh)
TRAIN_LM_ATTN = (8, 12, 4, 256, 64)
TRAIN_LM_AT = "B={0} H={1} KV={2} Dh={4} Sq=Sk={3} f32 causal".format(*TRAIN_LM_ATTN)


def _train_lm_k1() -> dict:
    """K1 in f32 at :data:`TRAIN_LM_ATTN`, with the lse as the autograd
    Function asks for it: the output within the f32 tolerance of the plain
    version and the lse within its own (gated), then timed beside the plain
    version and SDPA in f32, with the bound at the f32 peak outside the
    tensor cores."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, H, KV, S, Dh = TRAIN_LM_ATTN
    q, k, v = _qkv(B, H, KV, S, S, Dh, torch.float32, seed=1200, model_layout=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o, lse = fa.flash_attention_lse(q, k, v, causal=True, bshd=True)
    o_want, lse_want = fa.flash_attention_lse_ref(qt, kt, vt, causal=True)
    torch.cuda.synchronize()
    r = {"design": fa.design(torch.float32, Dh),
         "max_abs_err": (o.transpose(1, 2) - o_want).abs().max().item(),
         "tol": FWD_TOL["float32"], "lse_scaled_err": _scaled(lse, lse_want),
         "lse_tol": LSE_TOL["float32"], "finite": bool(torch.isfinite(o).all())}
    emit("kernels", kernel="flash_attention", case=f"train_lm {TRAIN_LM_AT}", dtype="float32",
         shape=[B, H, KV, S, S, Dh, Dh], **r)
    check(r["finite"] and r["max_abs_err"] <= r["tol"] and r["lse_scaled_err"] <= r["lse_tol"],
          f"flash_attention train_lm {TRAIN_LM_AT}: {r}")
    qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))
    r.update(_times(
        lambda: fa.flash_attention_lse(q, k, v, causal=True, bshd=True),
        lambda: fa.flash_attention_lse_ref(qt, kt, vt, causal=True),
        lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True),
        iters=50))
    r["bound_ms"], r["bound_by"] = _attention_bound(B, H, KV, S, S, Dh, 4, True, PEAK_F32_FLOPS)
    r["library_note"] = "F.scaled_dot_product_attention in f32 (TF32 off)"
    emit("kernels", kernel="flash_attention", timing=f"train_lm {TRAIN_LM_AT}", **r)
    return r


# the wide pairs' training attention, as the train cells run K1 there
# (model layout, bf16): deepseek-v2's at S=2048 (causal, Dqk=192, Dv=128)
# and paligemma's over 256 patches and 256 text tokens (the prefix span):
# (label, B, H, KV, S, Dqk, Dv, prefix_len)
WIDE_TRAIN_K1 = (
    ("deepseek train S=2048", 1, 128, 128, 2048, 192, 128, None),
    ("paligemma train S=512 prefix 256", 4, 8, 1, 512, 256, 256, 256),
)


def _wide_train_timings() -> dict:
    """K1 at :data:`WIDE_TRAIN_K1` (bf16, causal, with the lse as the
    autograd Function asks for it): the output against the plain version,
    two launches' output and lse equal bit for bit (gated), then timed
    beside the plain version and SDPA (``is_causal``, or the boolean
    prefix-LM mask), which the port never calls, with the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for i, (label, B, H, KV, S, Dh, Dv, prefix) in enumerate(WIDE_TRAIN_K1):
        q, k, v = _qkv(B, H, KV, S, S, Dh, torch.bfloat16, seed=400 + i, model_layout=True,
                       Dv=Dv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(causal=True, prefix_len=prefix)
        with torch.no_grad():
            first = fa.flash_attention_lse(q, k, v, bshd=True, **kw)
            again = fa.flash_attention_lse(q, k, v, bshd=True, **kw)
        want = fa.flash_attention_ref(qt, kt, vt, **kw)
        torch.cuda.synchronize()
        err = (first[0].transpose(1, 2).float() - want.float()).abs().max().item()
        bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again, want
        torch.cuda.empty_cache()
        check(err <= FWD_TOL["bfloat16"], f"flash_attention {label}: max_abs_err {err}")
        check(bitwise, f"flash_attention {label}: two launches differ")
        qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))
        mask = fa._mask(S, S, True, None, None, q.device, prefix) if prefix else None

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=KV != H)

        try:  # measured, not used: the port never calls SDPA
            sdpa()
            torch.cuda.synchronize()
            note = "F.scaled_dot_product_attention" + (
                " with the boolean prefix-LM mask" if prefix else ", is_causal")
        except RuntimeError as e:
            sdpa, note = None, f"SDPA refused: {str(e)[:200]}"
        r = _times(lambda: fa.flash_attention_lse(q, k, v, bshd=True, **kw),
                   lambda: fa.flash_attention_lse_ref(qt, kt, vt, **kw), sdpa, iters=10)
        bound_ms, bound_by = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS,
                                              Dv=Dv, prefix_len=prefix)
        r.update(max_abs_err=err, bitwise_repeat=bitwise, bound_ms=bound_ms, bound_by=bound_by,
                 library_note=note, design=fa.design(torch.bfloat16, Dh, Dv))
        emit("kernels", kernel="flash_attention",
             timing=f"{label} bf16 causal B={B} H={H} KV={KV} Dqk={Dh} Dv={Dv}", **r)
        out[label] = r
        del q, k, v, qt, kt, vt, qc, kc, vc, mask
        torch.cuda.empty_cache()
    return out


# the head-dim-128 configs' attention at full width, as their paths give it
# to K1 (model layout, bf16, causal; the KV heads zero-padded by kv_pad_to,
# so H and KV are the counts the kernel is given: phi4-mini 48/16, qwen1.5
# 32/32, deepseek-coder 112/16): both trained models' S=2048 at B=4 and
# the three served models' prefill at S=512, the engine's largest bucket;
# K1-bwd at the two training shapes: (label, B, H, KV, S)
K1_128 = (
    ("phi4 train S=2048", 4, 48, 16, 2048),
    ("qwen train S=2048", 4, 32, 32, 2048),
    ("phi4 prefill S=512", 1, 48, 16, 512),
    ("qwen prefill S=512", 1, 32, 32, 512),
    ("deepseek-coder prefill S=512", 1, 112, 16, 512),
)
K1_BWD_128 = K1_128[:2]


def _k1_128_timings() -> dict:
    """K1 at :data:`K1_128` (bf16, causal, with the lse where the autograd
    Function asks for it, at the training shapes): the output against the
    plain version, two launches' output and lse equal bit for bit (gated),
    then timed beside the plain version and SDPA (``is_causal``), which
    the port never calls, with the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for i, (label, B, H, KV, S) in enumerate(K1_128):
        q, k, v = _qkv(B, H, KV, S, S, 128, torch.bfloat16, seed=1400 + i, model_layout=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with torch.no_grad():
            first = fa.flash_attention_lse(q, k, v, bshd=True, causal=True)
            again = fa.flash_attention_lse(q, k, v, bshd=True, causal=True)
        want = fa.flash_attention_ref(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        err = (first[0].transpose(1, 2).float() - want.float()).abs().max().item()
        bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again, want
        check(err <= FWD_TOL["bfloat16"], f"flash_attention {label}: max_abs_err {err}")
        check(bitwise, f"flash_attention {label}: two launches differ")
        qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                  enable_gqa=KV != H)

        train = "train" in label
        r = _times(lambda: fa.flash_attention_lse(q, k, v, bshd=True, causal=True) if train
                   else fa.flash_attention(q, k, v, causal=True),
                   lambda: fa.flash_attention_ref(qt, kt, vt, causal=True), sdpa,
                   iters=10 if train else 20)
        bound_ms, bound_by = _attention_bound(B, H, KV, S, S, 128, 2, True, PEAK_BF16_FLOPS)
        r.update(max_abs_err=err, bitwise_repeat=bitwise, bound_ms=bound_ms, bound_by=bound_by,
                 library_note="F.scaled_dot_product_attention, is_causal",
                 design=fa.design(torch.bfloat16, 128))
        emit("kernels", kernel="flash_attention",
             timing=f"{label} bf16 causal B={B} H={H} KV={KV} Dh=128", **r)
        out[label] = r
        del q, k, v, qt, kt, vt, qc, kc, vc
        torch.cuda.empty_cache()
    return out


def _k1_bwd_128() -> dict:
    """K1-bwd at :data:`K1_BWD_128` (bf16, causal, Dh=128): against the
    plain version, in ulps beside the lower-precision control (which must
    read above the gate) and SDPA's autograd backward (read, not gated),
    two launches equal bit for bit, then timed beside the plain version,
    SDPA's backward and the bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    out = {}
    kw = dict(causal=True, window=None, k_len=None)
    for i, (label, B, H, KV, S) in enumerate(K1_BWD_128):
        q, k, v = _qkv(B, H, KV, S, S, 128, torch.bfloat16, seed=1500 + i, model_layout=True)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1510 + i),
                         device=q.device).to(torch.bfloat16)
        sdpa, _ = _sdpa_bwd(q, k, v, do, causal=True)
        o, lse, r = _bwd_case(q, k, v, do, kw, True, library=None if sdpa is None else (
            lambda: [g.transpose(1, 2) for g in sdpa()]))
        del sdpa
        with torch.no_grad():
            first = fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **kw)
        r["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again
        full = f"{label} bf16 causal B={B} H={H} KV={KV} Dh=128"
        emit("kernels", kernel="flash_attention_bwd", case=full, dtype="bfloat16",
             shape=[B, H, KV, S, S, 128], **r)
        check(r["ok"], f"flash_attention_bwd {full}: {r}")
        check(r["bitwise_repeat"], f"flash_attention_bwd {full}: two launches differ")
        check(max(r["control_ulp_err"].values()) > BWD_ULP_TOL,
              f"the bf16 control passes the ulp tolerance at {full}: {r['control_ulp_err']}")
        r.update(_bwd_timing(q, k, v, o, lse, do, kw, B, H, KV, S, S, 128),
                 design=fa.design_bwd(torch.bfloat16, 128))
        emit("kernels", kernel="flash_attention_bwd", timing=full,
             **{k_: r[k_] for k_ in ("design", "ms", "plain_ms", "device_ms",
                                     "kernel_profiled_ms", "kernel_profiled_by_launch",
                                     "library_ms", "library_device_ms", "library_note",
                                     "bound_ms", "bound_by")})
        out[label] = r
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return out


def _encdec_vlm_timings(cases=ENCDEC_VLM_K1) -> dict:
    """K1 at the enc-dec and VLM prefills' shapes (``cases``, bf16) beside
    its plain version and SDPA on the same inputs (a causal case with its
    boolean mask, prefix-LM for paligemma), each with its bound and its
    ``max_abs_err`` from the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import _mask, flash_attention, flash_attention_ref

    out = {}
    for i, (label, B, H, KV, Sq, Sk, Dh, causal, prefix) in enumerate(cases):
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, torch.bfloat16, seed=200 + i, model_layout=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))
        kw = dict(causal=causal, prefix_len=prefix)
        mask = _mask(Sq, Sk, causal, None, None, q.device, prefix) if causal else None

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, enable_gqa=KV != H)

        try:  # measured, not used: the port never calls SDPA
            got = sdpa().transpose(1, 2)
            torch.cuda.synchronize()
            note = ("SDPA max abs diff from the kernel "
                    f"{(got.float() - flash_attention(q, k, v, **kw).float()).abs().max().item()}")
        except RuntimeError as e:
            sdpa, note = None, f"SDPA refused: {str(e)[:200]}"
        err = (flash_attention(q, k, v, **kw).transpose(1, 2).float()
               - flash_attention_ref(qt, kt, vt, **kw).float()).abs().max().item()
        out[label] = _times(lambda: flash_attention(q, k, v, **kw),
                            lambda: flash_attention_ref(qt, kt, vt, **kw), sdpa, iters=20)
        bound_ms, bound_by = _attention_bound(B, H, KV, Sq, Sk, Dh, 2, causal, PEAK_BF16_FLOPS,
                                              prefix_len=prefix)
        out[label].update(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, library_note=note,
                          library="F.scaled_dot_product_attention"
                          + (" with the boolean prefix-LM mask" if prefix
                             else " with the boolean causal mask" if causal else ""))
        emit("kernels", kernel="flash_attention",
             timing=f"{label} bf16 B={B} H={H} KV={KV} Dh={Dh}", **out[label])
    return out


def _mla_timing() -> dict:
    """K1 at deepseek-v2's expanded MLA prefill (:data:`MLA_K1`, bf16,
    causal) beside its plain version and, where it takes Dv != Dqk on the
    card, SDPA (which the port never calls): the error SDPA raises is kept
    as ``library_note`` otherwise; ``max_abs_err`` from the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    m = MLA_K1
    B, H, KV, S, Dh, Dv = m["B"], m["H"], m["KV"], m["S"], m["Dh"], m["Dv"]
    q, k, v = _qkv(B, H, KV, S, S, Dh, torch.bfloat16, seed=7, model_layout=True, Dv=Dv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qc, kc, vc = (t.contiguous() for t in (qt, kt, vt))

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)

    want = flash_attention_ref(qt, kt, vt, causal=True)
    err = (flash_attention(q, k, v, causal=True).transpose(1, 2).float()
           - want.float()).abs().max().item()
    note = None
    try:
        got = sdpa()
        torch.cuda.synchronize()
        note = f"SDPA max abs diff from the plain version {(got.float() - want.float()).abs().max().item()}"
    except RuntimeError as e:  # measured, not used: the port never calls SDPA
        sdpa, note = None, f"SDPA refused Dqk={Dh} Dv={Dv}: {str(e)[:200]}"
    del want
    out = _times(lambda: flash_attention(q, k, v, causal=True),
                 lambda: flash_attention_ref(qt, kt, vt, causal=True), sdpa, iters=20)
    bound_ms, bound_by = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS, Dv=Dv)
    out.update(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, library_note=note)
    emit("kernels", kernel="flash_attention",
         timing=f"deepseek MLA bf16 causal B={B} H={H} KV={KV} Dqk={Dh} Dv={Dv} S={S}", **out)
    return out


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
# hymba's: the same B and S, 25 heads in groups of 5
HYMBA_TRAIN_ATTN = (4, 25, 5, 2048, 64)


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


def _bwd_bf16_control(q, k, v, o, lse, do, *, causal, window, k_len, prefix_len=None):
    """A lower-precision backward, for reading what the bf16 tolerance
    rejects: the plain formulas with S, P and dS rounded to bf16 before
    their products, f32 accumulation. (B, H, S, D) layout, q and k Dqk
    wide, v, o and do Dv wide."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale, bf16 = H // KV, Dh**-0.5, torch.bfloat16

    def grouped(t):
        return t.reshape(B, KV, G, Sq, t.shape[-1]).to(bf16)

    qg, og, dog, kb, vb = grouped(q), grouped(o), grouped(do), k.to(bf16), v.to(bf16)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kb).float() * scale
    mask = fa._mask(Sq, Sk, causal, window, k_len, q.device, prefix_len)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq, 1).float()), 0.0).to(bf16)
    delta = (dog.float() * og.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    ds = (p.float() * (torch.einsum("bkgqd,bksd->bkgqs", dog, vb).float() - delta)).to(bf16)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kb).float() * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg).float() * scale
    return dq.reshape(B, H, Sq, Dh).to(bf16), dk.to(bf16), dv.to(bf16)


def _bwd_case(q, k, v, do, kw, model_layout, library=None) -> tuple:
    """One check of K1's forward (output and lse) and backward against the
    plain versions on the same inputs; the bf16 control read beside it, and
    ``library()``'s gradients (in q's layout), when given, read the same
    way (printed, not gated). Returns the kernel's (o, lse) and the
    readings."""
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
    if library is not None:
        lib = library()
        names = ("dq", "dk", "dv")
        r["library_scaled_err"] = {n: _scaled(a, b) for n, a, b in zip(names, lib, want)}
        r["library_ulp_err"] = {n: _ulps(a, b) for n, a, b in zip(names, lib, want)}
        del lib
    r["ok"] = ok
    del got, want
    return o, lse, r


def _profiled_ms(fn, calls: int = 10) -> dict:
    """Device ms of one call per kernel name, from a profiler trace of
    ``calls`` calls (for calls that autograd runs, which a CUDA graph
    capture does not take as they are)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def _attention_bwd_bound(B, H, KV, Sq, Sk, Dh, elem_bytes, peak_flops, causal=True,
                         prefix_len=None, window=None, Dv=None):
    """Least time for the backward (Dqk = ``Dh``, Dv = Dh if None): q, k, v,
    o, dO and the f32 lse read once, dq, dk, dv written once; FLOPs of its
    five products over the pairs the mask leaves visible
    (``analysis.roofline.visible_pairs``): S, dK and dQ 2 Dqk a pair and head, dP and dV
    2 Dv (at Dqk = Dv 2.5x the forward's)."""
    from repro_torch.analysis.roofline import attention_bwd_cost

    Dv = Dh if Dv is None else Dv
    flops, nbytes = attention_bwd_cost(B, H, KV, Sq, Sk, Dh, Dv, elem_bytes, causal=causal,
                                       window=window, prefix_len=prefix_len)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# the enc-dec and VLM train cells' K1-bwd shapes at full width, B=4, bf16
# (the train phases' own shapes): paligemma's gemma backbone over 256 image
# patches and 256 text tokens under the prefix-LM span, whisper's encoder
# over its 1500 frames, the decoder's cross-attention from its 448 text
# tokens over the frames, and its causal self-attention: (label, B, H, KV,
# Sq, Sk, Dh, causal, prefix_len)
ENCDEC_VLM_BWD = (
    ("paligemma train S=512 prefix 256", 4, 8, 1, 512, 512, 256, True, 256),
    ("whisper train encoder S=1500", 4, 16, 16, 1500, 1500, 64, False, None),
    ("whisper train cross Sq=448 Sk=1500", 4, 16, 16, 448, 1500, 64, False, None),
    ("whisper train decoder causal S=448", 4, 16, 16, 448, 448, 64, True, None),
)


def _sdpa_bwd(q, k, v, do, *, causal, window=None, prefix_len=None):
    """SDPA's forward once, in (B, H, S, D) copies of the model-layout
    inputs, and ``grads()``: its autograd backward alone (measured, never
    used by the port); a boolean mask where the case has a window or a
    prefix span, else ``is_causal``. Returns (grads, note); grads is None
    where SDPA refuses the case."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    Sq, Sk, H, KV = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    do_c = do.transpose(1, 2).contiguous()
    masked = causal and (window is not None or prefix_len)
    mask = fa._mask(Sq, Sk, True, window, None, q.device, prefix_len) if masked else None
    try:
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             is_causal=causal and not masked,
                                             enable_gqa=KV != H)
    except RuntimeError as e:
        return None, f"SDPA refused: {str(e)[:200]}"

    def grads():
        return torch.autograd.grad(out, (qs, ks, vs), do_c, retain_graph=True)

    return grads, ("F.scaled_dot_product_attention's autograd backward"
                   + (" with the boolean mask" if masked else ""))


def _bwd_timing(q, k, v, o, lse, do, kw, B, H, KV, Sq, Sk, Dh, Dv=None,
                peak_flops=PEAK_BF16_FLOPS) -> dict:
    """K1-bwd at one shape (model layout, bf16 unless the inputs are f32,
    whose FMA design is bound by ``peak_flops`` = :data:`PEAK_F32_FLOPS`):
    eager ms, device ms by graph replay and by profiler (in all, and by
    launch under the kernel's short name: ``kernel_profiled_by_launch``),
    the plain version's ms, SDPA's autograd backward (``library_ms``,
    ``library_device_ms`` from a profiler trace) and the bound."""
    from repro_torch.kernels import flash_attention as fa

    def kernel():
        fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **kw)

    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    t = {"ms": _time_ms(kernel, 10),
         "plain_ms": _time_ms(lambda: fa.flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, **kw),
                              3, 1)}
    t["device_ms"] = _graph_ms(kernel, calls=5, replays=3)
    by_launch = {}
    for name, ms in _profiled_ms(kernel, calls=3).items():
        short = re.search(r"bwd_\w+", name)
        short = short.group(0) if short else name[:80]
        by_launch[short] = by_launch.get(short, 0.0) + ms
    t["kernel_profiled_ms"] = sum(by_launch.values())
    t["kernel_profiled_by_launch"] = by_launch
    library, t["library_note"] = _sdpa_bwd(q, k, v, do, causal=kw["causal"],
                                           window=kw.get("window"),
                                           prefix_len=kw.get("prefix_len"))
    t["library_ms"] = None if library is None else _time_ms(library, 10)
    t["library_device_ms"] = None if library is None else sum(_profiled_ms(library).values())
    t["bound_ms"], t["bound_by"] = _attention_bwd_bound(
        B, H, KV, Sq, Sk, Dh, q.element_size(), peak_flops, causal=kw["causal"],
        prefix_len=kw.get("prefix_len"), window=kw.get("window"), Dv=Dv)
    return t


def _deepseek_bwd(S: int) -> dict:
    """K1-bwd at deepseek-v2's training attention (:data:`DEEPSEEK_TRAIN_ATTN`
    at sequence ``S``, causal, Dqk=192, Dv=128, its own instantiation): in
    bf16 and f32 against the plain version (bf16 also in ulps beside the
    lower-precision control, which must read above the gate), two launches
    equal bit for bit, and in bf16 timed beside the plain version, SDPA's
    autograd backward (which takes Dv != Dqk) and the bound."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    m = DEEPSEEK_TRAIN_ATTN
    B, H, KV, Dh, Dv = m["B"], m["H"], m["KV"], m["Dh"], m["Dv"]
    kw = dict(causal=True, window=None, k_len=None)
    label = f"deepseek train B={B} H={H} KV={KV} Dqk={Dh} Dv={Dv} S={S} causal"
    out = {"at": label}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        q, k, v = _qkv(B, H, KV, S, S, Dh, dt, seed=1300, model_layout=True, Dv=Dv)
        do = torch.randn((B, S, H, Dv), generator=torch.Generator(device="cuda").manual_seed(1301),
                         device=q.device).to(dt)
        sdpa = None
        if dt == torch.bfloat16:
            sdpa, _ = _sdpa_bwd(q, k, v, do, causal=True)
        o, lse, r = _bwd_case(q, k, v, do, kw, True, library=None if sdpa is None else (
            lambda: [g.transpose(1, 2) for g in sdpa()]))
        del sdpa
        with torch.no_grad():
            first = fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **kw)
        r["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again
        emit("kernels", kernel="flash_attention_bwd", case=label, dtype=name,
             shape=[B, H, KV, S, S, Dh, Dv], **r)
        check(r["ok"], f"flash_attention_bwd {label} {name}: {r}")
        check(r["bitwise_repeat"], f"flash_attention_bwd {label} {name}: two launches differ")
        if dt == torch.bfloat16:
            check(max(r["control_ulp_err"].values()) > BWD_ULP_TOL,
                  f"the bf16 control passes the ulp tolerance at {label}: {r['control_ulp_err']}")
            r.update(_bwd_timing(q, k, v, o, lse, do, kw, B, H, KV, S, S, Dh, Dv=Dv))
            emit("kernels", kernel="flash_attention_bwd", timing=label,
                 design=fa.design_bwd(dt, Dh, Dv),
                 **{k_: r[k_] for k_ in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                         "kernel_profiled_by_launch", "library_ms",
                                         "library_device_ms", "library_note", "bound_ms",
                                         "bound_by")})
        out[name] = r
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return out


def _train_lm_k1_bwd() -> dict:
    """K1-bwd in f32 at :data:`TRAIN_LM_ATTN` (the FMA design): the
    gradients, the forward's output and lse against the plain versions at
    the f32 gates (gated), then timed as the bf16 shapes are, with the bound
    at the f32 peak outside the tensor cores."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, KV, S, Dh = TRAIN_LM_ATTN
    f32 = torch.float32
    q, k, v = _qkv(B, H, KV, S, S, Dh, f32, seed=1300, model_layout=True)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1301),
                     device=q.device)
    kw = dict(causal=True, window=None, k_len=None)
    o, lse, r = _bwd_case(q, k, v, do, kw, True)
    emit("kernels", kernel="flash_attention_bwd", case=f"train_lm {TRAIN_LM_AT}",
         dtype="float32", shape=[B, H, KV, S, S, Dh], **r)
    check(r["ok"], f"flash_attention_bwd train_lm {TRAIN_LM_AT}: {r}")
    r.update(design=fa.design_bwd(f32, Dh), **_bwd_timing(
        q, k, v, o, lse, do, kw, B, H, KV, S, S, Dh, peak_flops=PEAK_F32_FLOPS))
    emit("kernels", kernel="flash_attention_bwd", timing=f"train_lm {TRAIN_LM_AT}",
         **{k_: r[k_] for k_ in ("design", "ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                 "kernel_profiled_by_launch", "library_ms", "library_device_ms",
                                 "library_note", "bound_ms", "bound_by")})
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return r


def phase_flash_bwd(deepseek_seq: int) -> dict:
    """K1's backward against its plain version over the forward's sweep
    (gemma's 256/256 with the prefix span, MLA's 192/128 and whisper's
    non-causal forms included), in both dtypes, with the forward's output
    and lse checked too, then the same in bf16 at the train paths' own
    shapes, each timed beside the plain version, the autograd backward of
    PyTorch's SDPA and its bound: tinyllama's, hymba's two masks, the
    enc-dec and VLM cells' four (:data:`ENCDEC_VLM_BWD`), in both
    dtypes deepseek-v2's at the ``deepseek_train`` phase's sequence
    (:func:`_deepseek_bwd`), and phi4-mini's and qwen1.5's at 128/128
    (:func:`_k1_bwd_128`)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = worst_abs = worst_ulp = 0.0
    dh256, mla = {}, {}

    def record(r, key=None):
        nonlocal worst, worst_abs, worst_ulp
        worst = max(worst, *r["scaled_err"].values())
        worst_abs = max(worst_abs, r["max_abs_err"])
        worst_ulp = max(worst_ulp, *r.get("ulp_err", {"": 0.0}).values())
        if key is not None:
            dh256[key] = max(dh256.get(key, 0.0), *r["scaled_err"].values())

    for i, case in enumerate(_flash_cases()):
        label, B, H, KV, Sq, Sk, Dh, causal, window, k_len, model_layout, dt = case[:12]
        Dv = case[12] if len(case) > 12 else Dh
        prefix = case[13] if len(case) > 13 else None
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, dt, seed=500 + i, model_layout=model_layout, Dv=Dv)
        g = torch.Generator(device="cuda").manual_seed(900 + i)
        do = torch.randn((*q.shape[:3], Dv), generator=g, device=q.device).to(dt)
        kw = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix)
        _, _, r = _bwd_case(q, k, v, do, kw, model_layout)
        name = str(dt).split(".")[-1]
        emit("kernels", kernel="flash_attention_bwd", case=label, dtype=name,
             shape=[B, H, KV, Sq, Sk, Dh, Dv], prefix_len=prefix, **r)
        check(r["ok"], f"flash_attention_bwd {label} {name}: {r}")
        record(r, name if Dh == 256 else None)
        if Dv != Dh:
            mla[name] = max(mla.get(name, 0.0), *r["scaled_err"].values())
        del q, k, v, do

    B, H, KV, S, Dh = TRAIN_ATTN
    bf16 = torch.bfloat16
    q, k, v = _qkv(B, H, KV, S, S, Dh, bf16, seed=1000, model_layout=True)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1001),
                     device=q.device).to(bf16)
    kw = dict(causal=True, window=None, k_len=None)
    sdpa_grads, _ = _sdpa_bwd(q, k, v, do, causal=True)
    o, lse, r_train = _bwd_case(q, k, v, do, kw, True,
                                library=lambda: [g.transpose(1, 2) for g in sdpa_grads()])
    del sdpa_grads
    label = f"train bf16 causal B={B} H={H} KV={KV} Dh={Dh} S={S}"
    emit("kernels", kernel="flash_attention_bwd", case=label, dtype="bfloat16",
         shape=[B, H, KV, S, S, Dh], **r_train)
    check(r_train["ok"], f"flash_attention_bwd {label}: {r_train}")
    # the ulp gate rejects a lower-precision backward at the path's shapes
    check(max(r_train["control_ulp_err"].values()) > BWD_ULP_TOL,
          f"the bf16 control passes the ulp tolerance at {label}: {r_train['control_ulp_err']}")
    record(r_train)
    torch.cuda.empty_cache()

    t = _bwd_timing(q, k, v, o, lse, do, kw, B, H, KV, S, S, Dh)
    fwd_bound, _ = _attention_bound(B, H, KV, S, S, Dh, 2, True, PEAK_BF16_FLOPS)
    t["forward"] = {"ms": _time_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True,
                                                                   bshd=True), 10),
                    "device_ms": _graph_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                           calls=5, replays=3),
                    "bound_ms": fwd_bound}
    emit("kernels", kernel="flash_attention_bwd", timing=label, **t)
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()

    # hymba's training attention (a GQA group of 5, the window on 29 of its
    # 32 layers and the global mask on 3), then the enc-dec and VLM cells'
    # shapes: each held, then timed
    B, H, KV, S, Dh = HYMBA_TRAIN_ATTN
    shapes = [(f"hymba train {mask}", B, H, KV, S, S, Dh, True, window, None)
              for mask, window in (("window 1024", 1024), ("global", None))]
    shapes += [(label, B_, H_, KV_, Sq, Sk, Dh_, causal, None, prefix)
               for label, B_, H_, KV_, Sq, Sk, Dh_, causal, prefix in ENCDEC_VLM_BWD]
    at_shapes = {}
    for i, (label, B, H, KV, Sq, Sk, Dh, causal, window, prefix) in enumerate(shapes):
        q, k, v = _qkv(B, H, KV, Sq, Sk, Dh, bf16, seed=1100 + i, model_layout=True)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1110 + i),
                         device=q.device).to(bf16)
        kw = dict(causal=causal, window=window, k_len=None, prefix_len=prefix)
        o, lse, r = _bwd_case(q, k, v, do, kw, True)
        full = f"{label} bf16 B={B} H={H} KV={KV} Dh={Dh} Sq={Sq} Sk={Sk}"
        emit("kernels", kernel="flash_attention_bwd", case=full, dtype="bfloat16",
             shape=[B, H, KV, Sq, Sk, Dh], prefix_len=prefix, **r)
        check(r["ok"], f"flash_attention_bwd {full}: {r}")
        check(max(r["control_ulp_err"].values()) > BWD_ULP_TOL,
              f"the bf16 control passes the ulp tolerance at {full}: {r['control_ulp_err']}")
        record(r, "bfloat16" if Dh == 256 else None)
        r.update(_bwd_timing(q, k, v, o, lse, do, kw, B, H, KV, Sq, Sk, Dh))
        emit("kernels", kernel="flash_attention_bwd", timing=full,
             design=fa.design_bwd(bf16, Dh),
             **{k_: r[k_] for k_ in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                     "kernel_profiled_by_launch", "library_ms",
                                     "library_device_ms", "library_note", "bound_ms",
                                     "bound_by")})
        at_shapes[label] = r
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    deepseek = _deepseek_bwd(deepseek_seq)
    for name in ("bfloat16", "float32"):
        record(deepseek[name])
        mla[name] = max(mla.get(name, 0.0), *deepseek[name]["scaled_err"].values())
    dh128 = _k1_bwd_128()
    for r in dh128.values():
        record(r)
    train_lm = _train_lm_k1_bwd()
    record(train_lm)
    return {"flash_attention_bwd": {"max_scaled_err": worst, "max_abs_err": worst_abs,
                                    "max_ulp_err": worst_ulp, "dh256_max_scaled_err": dh256,
                                    "mla_max_scaled_err": mla, "timing": t,
                                    "train_shape": r_train, "train_shapes": at_shapes,
                                    "deepseek": deepseek, "dh128": dh128,
                                    "train_lm": train_lm}}


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
    from repro_torch.analysis.roofline import ssd_cost

    flops, nbytes = ssd_cost(B, S, H, P, N, cl, elem_bytes)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _ssd_cases() -> list:
    """K2's sweep, each case in bf16 and f32 (and K2-bwd's): (label, B, S,
    H, P, N, chunk, dt/A laws)."""
    shapes = [(f"mamba2 S={S}", 1, S, 64, 64, 128, 256, "wide") for S in (300, 512, 1024)]
    return shapes + [
        ("mamba2 S=512 model's dt/A", 1, 512, 64, 64, 128, 256, "model"),
        ("hymba S=300", 1, 300, 25, 64, 16, 64, "wide"),
        ("B=2 H=25 N=128 chunk 64 S=100", 2, 100, 25, 64, 128, 64, "wide"),
        ("S=50 < chunk 256", 1, 50, 4, 64, 128, 256, "wide"),
        ("P=40 N=24 chunk 32 S=70", 2, 70, 3, 40, 24, 32, "wide"),
        ("B=2 H=5 P=32 N=16 chunk 64 S=130", 2, 130, 5, 32, 16, 64, "wide"),
    ]


def phase_ssd_kernels() -> dict:
    import torch

    from repro_torch.kernels.ssd import scaled_error, ssd_bshp, ssd_ref

    bf16, f32 = torch.bfloat16, torch.float32
    # scaled error: max |kernel - plain| / max(1, max |plain|); both compute in
    # f32 from the same inputs, so bf16 differs by about one rounding of y
    tol = {bf16: 1e-2, f32: 1e-4}
    worst, worst_scaled = 0.0, 0.0
    for i, (label, B, S, H, P, N, chunk, laws) in enumerate(_ssd_cases()):
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
    # the prefill shapes, and the training ones (SSD_TRAIN) the train
    # steps launch K2 at
    for label, B, S, H, P, N, chunk in (
        ("mamba2 S=512", 1, 512, 64, 64, 128, 256),
        ("mamba2 S=1024", 1, 1024, 64, 64, 128, 256),
        ("hymba S=512", 1, 512, 25, 64, 16, 64),
        *SSD_TRAIN,
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


# K2's backward against its plain version. Both compute in f32 from the same
# inputs, so f32 gradients (every gradient of an f32 case, and ddt and dA,
# which are f32 in a bf16 case too) differ by the sum order only: scaled,
# under 1e-4. bf16 gradients (dx, dB and dC of a bf16 case) are held as
# K1-bwd's are: 2^-7 scaled (BWD_TOL) and BWD_ULP_TOL bf16 ulps.
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
# the bf16 design's launches (csrc/ssd_bwd.cu), but for the state pass it
# shares with the f32 form as ssd_bwd_state_pass<true>
SSD_BWD_BF16_LAUNCHES = ("ssd_bwd_chunk_state_mma", "ssd_bwd_scores", "ssd_bwd_dx_mma",
                         "ssd_bwd_dbdc", "ssd_bwd_finish_mma")
# the training shapes, bf16 with the model's dt/A laws: (label, B, S, H, P,
# N, chunk)
SSD_TRAIN = (("mamba2 train", 4, 2048, 64, 64, 128, 256),
             ("hymba train", 4, 2048, 25, 64, 16, 64))


def _ssd_bwd_bound(B, S, H, P, N, cl, elem_bytes, peak_flops):
    """Least time for the scan's backward: x, B, C and dy (elem_bytes), dt
    and A (f32) read once; dx, dB, dC (elem_bytes), ddt and dA (f32) written
    once. FLOPs, the least work of the function: over each chunk's causal
    pairs, C B^T and, since B and C are shared by the heads, the chunk-local
    dB and dC from the scores summed over the heads (N each, once); per
    head, dy x^T and du = (C B^T e^..)^T dy over the same pairs (P each);
    and per head and row the state terms: the chunk states and the dy C^T
    sums recomputed, g B into du and g^T u into dB, and h^T dy into dC for
    every chunk but the first (which enters with a zero state). A count
    that takes the chunk-local dB and dC per head instead adds H 4 N per
    pair, work the head sums show the function does not need."""
    from repro_torch.analysis.roofline import ssd_bwd_cost

    flops, nbytes = ssd_bwd_cost(B, S, H, P, N, cl, elem_bytes)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _ssd_bwd_emulation(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk, split):
    """The bf16 backward kernels' arithmetic (``csrc/ssd_bwd.cu``) in plain
    PyTorch, gradients in the inputs' dtypes, on the inputs' device.
    ``split`` True: every f32 operand of a product (the weighted rows of the
    chunk states, the states h and g, W1 = G e^{..} and the head-summed Ŵ2)
    as bf16 hi + lo parts, one product each, summed in f32; False: those
    operands rounded to one bf16 each (the control, read beside the kernel
    here); None: no rounding (the restructured formulas in f32).
    ``tests/test_torch_ssd_bwd.py`` holds it to the plain version and to
    ``jax.vjp`` of the reference's oracle.

    Per chunk, with G = C·Bᵀ formed once for all heads and, per head, W2 =
    (dy·xᵀ) dt_j e^{Λ_i-Λ_j} over j ≤ i:

    * du_j = e^{Λ_L-Λ_j} B_j gᵀ + Σ_{i≥j} W1[i][j] dy_i, dx = dt du;
    * dC = Ŵ2 B + Σ_h e^{Λ_i} dy_i h, dB = Ŵ2ᵀ C + Σ_h e^{Λ_L-Λ_j} dt_j x_j g,
      with Ŵ2 = Σ_h W2;
    * the gradient of Λ_t per head is rowsum_t(W2∘G) − colsum_t(W2∘G) +
      e^{Λ_t} C_t·(hᵀ dy_t) − dt_t x_t·du_t's state part, and the last row
      adds ⟨g, state leaving⟩ = e^{Λ_L}⟨g, h⟩ + Σ_j dt_j x_j·du_j's state
      part, from the same numbers (the state h as the kernels read it back).
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ssd as tssd

    def parts(t):
        if split is None:
            return (t,)
        hi = t.to(torch.bfloat16).float()
        return (hi, (t - hi).to(torch.bfloat16).float()) if split else (hi,)

    def mm(eq, op, other):  # the split operand first, an exact one second
        return sum(torch.einsum(eq, part, other) for part in parts(op))

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
    cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(tssd._segsum(a))  # (B, nc, H, i, j)
    to_end = torch.exp(cum[..., -1:] - cum).transpose(2, 3)  # (B, nc, cl, H)
    from_start = torch.exp(cum).transpose(2, 3)
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, H)

    # the chunk states, their weighted rows split
    local = mm("bcjhp,bcjn->bchpn", xr * (to_end * dtr)[..., None], Br)
    g_local = mm("bcihp,bcin->bchpn", dyr * from_start[..., None], Cr)
    zeros = torch.zeros((Bb, H, Pd, N), device=x.device)
    state, entering = zeros, []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + local[:, c]
    h_in = torch.stack(entering, dim=1)
    grad = dfinal.float() if dfinal is not None else zeros
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = grad
        grad = grad * chunk_decay[:, c, :, None, None] + g_local[:, c]
    g = torch.stack(leaving, dim=1)

    # dx: the state part, then the decayed C·Bᵀ split
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    du_state = to_end[..., None] * mm("bchpn,bcjn->bcjhp", g, Br)
    xds = (xr * du_state).sum(-1)
    du = du_state + mm("bchij,bcihp->bcjhp", G[:, :, None] * decay, dyr)
    xdu = (xr * du).sum(-1)

    # the scores, summed over the heads before their N-wide products
    W2 = torch.einsum("bcihp,bcjhp->bchij", dyr, xr) * dtr.transpose(2, 3)[:, :, :, None] * decay
    W2G = W2 * G[:, :, None]
    W2h = W2.sum(2)
    dC_h = mm("bchpn,bcihp->bcihn", h_in, dyr)  # each head's hᵀ dy_i
    dC = mm("bcij,bcjn->bcin", W2h, Br) + (from_start[..., None] * dC_h).sum(3)
    dB = mm("bcij,bcin->bcjn", W2h, Cr) + (
        (to_end * dtr)[..., None] * mm("bchpn,bcjhp->bcjhn", g, xr)).sum(3)

    # the gradient of Λ: rowsum − colsum, the state terms, the last row
    cst = from_start * (dC_h * Cr[:, :, :, None]).sum(-1)
    dlam = (W2G.sum(-1) - W2G.sum(-2)).transpose(2, 3) + cst - dtr * xds
    h_read = sum(parts(h_in))  # the entering state as the state pass reads it back
    last = torch.zeros_like(dlam)
    last[:, :, -1] = chunk_decay * (g * h_read).sum((-1, -2)) + (dtr * xds).sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dlam + last, [2]), dim=2), [2])
    ddt = xdu + Af * da
    dA = (dtr * da).sum((0, 1, 2))

    def seq(t, *tail):
        return t.reshape(Bb, S, *tail)[:, :S_orig]

    return (
        seq(du * dtr[..., None], H, Pd).to(x.dtype),
        seq(ddt, H),
        dA,
        seq(dB, N).to(Bm.dtype),
        seq(dC, N).to(Cm.dtype),
    )


def _ssd_bwd_case(x, dt, A, Bm, Cm, dy, dfinal, chunk) -> tuple:
    """One set of K2-bwd launches against the plain version on the same
    inputs: each gradient's scaled error, and the bf16 ones' ulps beside
    those of the control, the bf16 design with its split operands rounded
    once (:func:`_ssd_bwd_emulation`). Returns the kernel's gradients and
    the readings."""
    import torch

    from repro_torch.kernels import ssd as tssd

    got = tssd.ssd_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)
    want = tssd.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk)
    torch.cuda.synchronize()
    r = {"scaled_err": {}, "ulp_err": {}, "max_abs_err": 0.0, "finite": True,
         "tol": BWD_TOL, "ulp_tol": BWD_ULP_TOL}
    ok = True
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        dtype = str(g.dtype).split(".")[-1]
        r["scaled_err"][name] = _scaled(g, w)
        r["max_abs_err"] = max(r["max_abs_err"], (g.float() - w.float()).abs().max().item())
        r["finite"] = r["finite"] and bool(torch.isfinite(g.float()).all())
        ok = ok and r["scaled_err"][name] <= BWD_TOL[dtype]
        if g.dtype == torch.bfloat16:
            r["ulp_err"][name] = _ulps(g, w)
            ok = ok and r["ulp_err"][name] <= BWD_ULP_TOL
    if x.dtype == torch.bfloat16:
        ctl = _ssd_bwd_emulation(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk, split=False)
        r["control_ulp_err"] = {n: _ulps(c, w) for n, c, w in zip(SSD_BWD_NAMES, ctl, want)
                                if c.dtype == torch.bfloat16}
        r["control_scaled_err"] = {n: _scaled(c, w) for n, c, w in zip(SSD_BWD_NAMES, ctl, want)}
        del ctl
    r["ok"] = ok and r["finite"]
    del want
    return got, r


def phase_ssd_bwd() -> dict:
    """K2's backward against its plain version over K2's sweep in both
    dtypes (every other case with a gradient of the final state too), then
    at mamba2's and hymba's training shapes in bf16, where two launches
    must agree bit for bit, the single-rounding control must read above the
    ulp gate, and it is timed beside the plain version."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as tssd

    bf16, f32 = torch.bfloat16, torch.float32
    worst = worst_abs = worst_ulp = 0.0

    def dy_and_final(x, seed, B, H, P, N, with_final):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dy = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
        return dy, (torch.randn((B, H, P, N), generator=g, device=x.device) if with_final
                    else None)

    def tally(r):
        nonlocal worst, worst_abs, worst_ulp
        worst = max(worst, *r["scaled_err"].values())
        worst_abs = max(worst_abs, r["max_abs_err"])
        worst_ulp = max(worst_ulp, *r["ulp_err"].values(), 0.0)

    for i, (label, B, S, H, P, N, chunk, laws) in enumerate(_ssd_cases()):
        for dt_ in (bf16, f32):
            x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, dt_, 400 + i, laws)
            dy, dfinal = dy_and_final(x, 450 + i, B, H, P, N, with_final=i % 2 == 1)
            got, r = _ssd_bwd_case(x, dt, A, Bm, Cm, dy, dfinal, chunk)
            emit("kernels", kernel="ssd_bwd", case=label, dtype=str(dt_).split(".")[-1],
                 shape=[B, S, H, P, N, chunk], laws=laws, final_state_grad=dfinal is not None,
                 **r)
            check(r["ok"], f"ssd_bwd {label} {dt_}: {r}")
            tally(r)
            del got

    # the registers and spills of the trained design's launches
    ptxas = {k: v for k, v in ptxas_resources(build.build_log["ssd_bwd"]["ptxas"]).items()
             if k.split("<")[0] in SSD_BWD_BF16_LAUNCHES or k == "ssd_bwd_state_pass<true>"}
    timings = {}
    for label, B, S, H, P, N, chunk in SSD_TRAIN:
        x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, bf16, 500 + H, "model")
        dy, _ = dy_and_final(x, 550 + H, B, H, P, N, with_final=False)
        got, r = _ssd_bwd_case(x, dt, A, Bm, Cm, dy, None, chunk)
        again = tssd.ssd_bwd(x, dt, A, Bm, Cm, dy, chunk=chunk)
        r["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again
        torch.cuda.empty_cache()

        def kernel():
            tssd.ssd_bwd(x, dt, A, Bm, Cm, dy, chunk=chunk)

        # no single PyTorch call computes the SSD scan's gradient
        t = {"ms": _time_ms(kernel, 5, 2),
             "plain_ms": _time_ms(lambda: tssd.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=chunk),
                                  2, 1),
             "library_ms": None}
        torch.cuda.empty_cache()
        t["device_ms"] = _graph_ms(kernel, calls=3, replays=3)
        launches = ((re.search(r"ssd_bwd_\w+", k), ms) for k, ms in _profiled_ms(kernel, 3).items())
        t["kernel_profiled_ms"] = {m.group(0): ms for m, ms in launches if m}  # by short name
        t["bound_ms"], t["bound_by"] = _ssd_bwd_bound(B, S, H, P, N, chunk, 2, PEAK_BF16_FLOPS)
        t["design"] = tssd.DESIGN_BWD[bf16]
        t["ptxas"] = ptxas
        case = f"{label} bf16 B={B} S={S} H={H} P={P} N={N} chunk={chunk}"
        emit("kernels", kernel="ssd_bwd", case=case, dtype="bfloat16",
             shape=[B, S, H, P, N, chunk], laws="model", **r, **t)
        check(r["ok"] and r["bitwise_repeatable"], f"ssd_bwd {case}: {r}")
        # the ulp gate rejects the single-rounding control at the path's shapes
        check(max(r["control_ulp_err"].values()) > BWD_ULP_TOL,
              f"the bf16 control passes the ulp tolerance at {case}: {r['control_ulp_err']}")
        tally(r)
        timings[label] = {**t, "case": case, "ulp_err": r["ulp_err"],
                          "control_ulp_err": r["control_ulp_err"]}
        del x, dt, A, Bm, Cm, dy
        torch.cuda.empty_cache()
    return {"ssd_bwd": {"max_scaled_err": worst, "max_abs_err": worst_abs,
                        "max_ulp_err": worst_ulp, "timings": timings}}


# -- serve ----------------------------------------------------------------------


def _prompts(vocab: int, n: int = N_REQUESTS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=n)
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


def _serve(model, params, rounds: list, serve_kw) -> list:
    """Serve each round's prompts (``rounds``, a list of prompt lists) on one
    engine, each round once the last has finished: per round its tokens,
    each request's TTFT marks, its wall s, the engine's stats after it
    (cumulative) and the bytes the exact-length prefill graphs hold then."""
    import torch

    from repro_torch.serve import ServeEngine

    runs = []
    with ServeEngine(model, params, **serve_kw) as engine:
        for prompts in rounds:
            t0 = time.perf_counter()
            handles = [engine.submit(p, NEW_TOKENS) for p in prompts]
            outs = [list(map(int, h.result(600))) for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append({"outs": outs, "wall": wall, "stats": engine.stats(),
                         "exact_held_bytes": engine._exact_graphs.held_bytes(),
                         # handles keep the engine (and its weights) alive
                         # through their cancellers
                         "marks": [{"ttft": h.ttft, "admit": h.prefill_start_t - h.submit_t,
                                    "prefill": h.prefill_done_t - h.prefill_start_t,
                                    "slot_wait": h.first_token_t - h.prefill_done_t}
                                   for h in handles]})
    return runs


def _round_line(run: dict, before) -> dict:
    """One round's serving metrics: tokens/s, TTFT p50 / p99 and its parts'
    shares, and its graph replays, exact-length graphs by length (eager
    runs, replays, captured this round, capture ms), ``before`` being the
    previous round's stats or None."""
    marks, stats = run["marks"], run["stats"]
    ttft = [m["ttft"] for m in marks]
    prev = before["graphs"] if before else {}

    def grew(k, g, key):
        return g[key] - prev.get(k, {}).get(key, 0)

    exact = {k[len("exact_"):]: {"eager": grew(k, g, "eager_steps"),
                                 "replays": grew(k, g, "replays"),
                                 "captured": g["capture_s"] is not None
                                 and prev.get(k, {}).get("capture_s") is None,
                                 "capture_ms": None if g["capture_s"] is None
                                 else 1e3 * g["capture_s"]}
             for k, g in stats["graphs"].items() if k.startswith("exact_")}
    return {
        "wall_s": run["wall"],
        "tokens_per_s": sum(len(o) for o in run["outs"]) / run["wall"],
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "ttft_parts_s": {k: [m[k] for m in marks] for k in ("admit", "prefill", "slot_wait")},
        "ttft_sum_s": sum(ttft),
        "ttft_share": {k: sum(m[k] for m in marks) / sum(ttft)
                       for k in ("admit", "prefill", "slot_wait")},
        "ticks": stats["ticks"] - (before["ticks"] if before else 0),
        "preemptions": stats["preemptions"] - (before["preemptions"] if before else 0),
        "graph_replays": {k: grew(k, g, "replays") for k, g in stats["graphs"].items()},
        "exact_by_length": exact,
        "exact_graph_evictions": stats["exact_graph_evictions"],
        "exact_held_bytes": run["exact_held_bytes"],
    }


def _traced(fn, top: int = 3) -> dict:
    """One call of ``fn`` under the profiler: host-clock ms to the end of its
    device work, the device-busy ms (the sum of its kernels' durations on the
    one stream), the idle share, the count of kernels the card ran, the
    host's calls that issued work (``host_launches``: kernel launches, graph
    launches and async copies, :data:`HOST_LAUNCH`; a graph replay runs many
    kernels for one call), the device ms of the
    port's kernels by name (K1 ``flash_fwd_*``, K1's backward ``bwd_*``, K2
    ``ssd_*``, K2's backward ``ssd_bwd_*``), of the ``top`` heaviest
    kernels, and of the GEMMs (cuBLAS
    kernels, by name) in all and the ``top`` largest."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_calls: dict = {}  # the host's launches and copies, by runtime call
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and HOST_LAUNCH.match(e.name):
            host_calls[e.name] = host_calls.get(e.name, 0) + 1
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ports = {}  # device ms of each of the port's kernels, by its short name
    by_name = {}  # device ms and count of every kernel, by its full name
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        ms0, n0 = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms0 + ms, n0 + 1)
        name = re.search(r"(flash_fwd_\w+|ssd_bwd_\w+|ssd_\w+|bwd_(?:dkdv|dq|preprocess)\w*)",
                         e.name)
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
        "host_launches": sum(host_calls.values()),
        "host_launches_by_call": host_calls,
        "k1_device_ms": sum(v for k, v in ports.items() if k.startswith("flash_fwd")),
        "k1_bwd_device_ms": sum(v for k, v in ports.items() if k.startswith("bwd_")),
        "k2_device_ms": sum(v for k, v in ports.items()
                            if k.startswith("ssd_") and not k.startswith("ssd_bwd_")),
        "k2_bwd_device_ms": sum(v for k, v in ports.items() if k.startswith("ssd_bwd_")),
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
    full width, and a profiler trace of each (:func:`_traced`): eager (the
    model's ``decode_step``), and the engine's tick (gather, decode, scatter,
    argmax over a paged pool of the serve settings) run eagerly and as its
    captured graph (``tick_eager_*``, ``tick_graph_*``; the graph's time
    includes the copies in and out). For a family that buckets its prompts,
    also the S=300 prefill by replay of the 512 bucket's graph, with the
    copy of its static cache (``prefill_graph_*``, ``prefill_clone_*``);
    for one that does not, the S=300 prefill by its length's graph, as the
    engine runs it from the length's second prefill (the copy in, the
    replay, the clone out and the first token's read-back;
    ``prefill_graph_*``), its first token and every cache leaf held equal
    to the eager body's bit for bit, beside that eager body under
    ``inference_mode`` as the length's first prefill runs it
    (``prefill_inference_*``). Then the host ms of one ``kv.write`` of the
    S=300 cache into a slot, as a join runs it (reported, not gated)."""
    import torch

    from repro_torch.serve import PagedKVCache, ServeEngine
    from repro_torch.serve.graphs import DecodeGraph, ExactPrefillGraphs, PrefillGraphs
    from repro_torch.serve.graphs import prefill_first
    from repro_torch.tree import tree_leaves, tree_map

    cfg = model.cfg
    S, lanes, width = 300, serve_kw["max_slots"], serve_kw["max_len"]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S))
    caches = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=model.device),
                      model.cache_shapes(lanes, width))
    tok = torch.zeros((lanes, 1), dtype=torch.long, device=model.device)
    idx = torch.tensor([100, 300, 500, 700], device=model.device)[:lanes]

    def prefill():
        model.prefill(params, {"tokens": tokens})

    def decode():
        model.decode_step(params, tok, caches, idx)

    kv = PagedKVCache(model, lanes, width, page_size=serve_kw["page_size"])
    graph = DecodeGraph(model, params, kv)
    tick_in = (np.zeros((lanes, 1), np.int64), idx.cpu().numpy(), {})
    graph.run(*tick_in)  # the static inputs now hold the lanes' positions

    def tick_graph():
        graph.run(*tick_in)

    def tick_eager():
        with torch.inference_mode():
            graph.body()["next"].cpu()

    out = {"arch": cfg.name, "prefill_ms_S300": _host_ms(prefill, 5),
           "decode_step_ms_4lanes": _host_ms(decode, 10),
           "tick_eager_ms_4lanes": _host_ms(tick_eager, 10),
           "tick_graph_ms_4lanes": _host_ms(tick_graph, 10),
           "tick_graph_capture_s": graph.stats()["capture_s"]}
    out.update({f"prefill_{k}": v for k, v in _traced(prefill).items()})
    out.update({f"decode_{k}": v for k, v in _traced(decode).items()})
    out.update({f"tick_eager_{k}": v for k, v in _traced(tick_eager).items()})
    out.update({f"tick_graph_{k}": v for k, v in _traced(tick_graph).items()})
    if ServeEngine.supports_prefill_buckets(cfg):
        bucket = 512
        graphs = PrefillGraphs(model, params, (bucket,))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = tokens[0]

        def prefill_graph():
            graphs.run(padded, S - 1)

        # a bucket's cache, of the shape the replay clones out of its static one
        static = model.prefill(params, {"tokens": padded})[1]
        out.update({
            "prefill_graph_ms_S300": _host_ms(prefill_graph, 5),
            "prefill_graph_bucket": bucket,
            "prefill_clone_ms": _time_ms(lambda: tree_map(torch.clone, static), 20, 2),
            "prefill_clone_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(static)),
        })
        out.update({f"prefill_graph_{k}": v for k, v in _traced(prefill_graph).items()})
    else:
        toks = tokens.astype(np.int32)
        graphs = ExactPrefillGraphs(model, params)

        def prefill_inference():
            with torch.inference_mode():
                return prefill_first(model, params, torch.as_tensor(toks, device=model.device))

        def prefill_graph():
            return graphs.run(toks)

        want = prefill_inference()
        prefill_graph()  # the length's first sight: eager
        t0 = time.perf_counter()
        cache, first = prefill_graph()  # captured, then replayed
        capture_ms = 1e3 * (time.perf_counter() - t0)
        runs = [(cache, first), prefill_graph()]
        bitwise = all(
            got_first == int(want["first"]) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(tree_leaves(got), tree_leaves(want["cache"]), strict=True))
            for got, got_first in runs)
        check(bitwise, f"{cfg.name}: a replayed S={S} prefill's first token or cache differs "
                       "from the eager body's")
        out.update({
            "prefill_inference_ms_S300": _host_ms(prefill_inference, 5),
            "prefill_graph_ms_S300": _host_ms(prefill_graph, 5),
            "prefill_graph_length": S,
            "prefill_graph_first_call_ms": capture_ms,
            "prefill_graph_capture_s": graphs.stats()[f"exact_{S}"]["capture_s"],
            "prefill_graph_pool_bytes": graphs.stats()[f"exact_{S}"]["pool_bytes"],
            "prefill_graph_bitwise_with_eager": bitwise,
        })
        # a length served k times costs e + c + (k - 2) r by its graph (first
        # sight eager, the capture's call, replays) against k e eagerly
        e, r = out["prefill_inference_ms_S300"], out["prefill_graph_ms_S300"]
        uses = 2 + (capture_ms - e) / (e - r) if e > r else None
        out["prefill_graph_break_even_uses"] = uses
        out["prefill_graph_break_even_repeat_share"] = 1 - 1 / uses if uses else None
        out.update({f"prefill_inference_{k}": v for k, v in _traced(prefill_inference).items()})
        out.update({f"prefill_graph_{k}": v for k, v in _traced(prefill_graph).items()})
        graphs.close()
        del runs, cache, want
    # one join's kv.write: the S=300 cache into a slot's pages
    slot = kv.alloc(kv.pages_for(S))
    with torch.inference_mode():
        cache = model.prefill(params, {"tokens": tokens})[1]
        out["kv_write_ms_S300"] = _host_ms(lambda: kv.write(slot, cache, S), 10)
    kv.free(slot)
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


def phase_readback() -> dict:
    """What a tick's read-back does to another thread's launches onto the
    same stream: one thread replays a CUDA graph of 2000 small kernels and
    reads 4 values back after each replay, by a blocking ``.cpu()`` or by
    the engine's ``read_back`` (pinned memory and an event), while another
    times 2500 launches of a small kernel, as an eager prefill beside the
    decode ticks makes. In turns: blocking, event, event, blocking.
    Reported, not gated."""
    import threading

    import torch

    from repro_torch.serve.graphs import read_back

    x = torch.zeros(1 << 20, device="cuda")
    y = torch.zeros(64, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2000):
            x.mul_(1.0000001)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(2000):
            x.mul_(1.0000001)

    def launches_ms():
        t0 = time.perf_counter()
        for _ in range(2500):
            y.add_(1)
        return 1e3 * (time.perf_counter() - t0)

    def ticks(blocking, stop, started):
        while not stop.is_set():
            graph.replay()
            x[:4].cpu() if blocking else read_back(x[:4])
            started.set()

    graph_ms = _time_ms(graph.replay, 10, 2)
    out = {"graph_device_ms": graph_ms, "launches_alone_ms": launches_ms(),
           "launches_beside_ticks_ms": {"blocking": [], "event": []}}
    for blocking in (True, False, False, True):
        stop, started = threading.Event(), threading.Event()
        th = threading.Thread(target=ticks, args=(blocking, stop, started))
        th.start()
        started.wait(60)
        out["launches_beside_ticks_ms"]["blocking" if blocking else "event"].append(launches_ms())
        stop.set()
        th.join(60)
        check(not th.is_alive(), "the read-back probe's tick thread did not stop")
    torch.cuda.synchronize()
    del graph
    emit("readback", **out)
    return out


def _check_graph_replays(arch: str, dtype: str, stats: dict, requests: int,
                         serve_kw: dict, repeat=None) -> None:
    """Every decode tick replayed the decode graph, and with prompt buckets
    every first prefill replayed its bucket's graph (a resume takes its
    length's graph). ``repeat`` (prompt lengths, the stats before the
    round): a round of prompts whose lengths were all seen before replays
    each length's captured graph for every prompt, and runs none eagerly."""
    graphs = stats["graphs"]
    check(graphs["decode"]["replays"] == stats["ticks"] > 0,
          f"{arch} {dtype}: {graphs['decode']['replays']} decode graph replays for "
          f"{stats['ticks']} ticks")
    if serve_kw.get("prefill_buckets"):
        n = sum(g["replays"] for k, g in graphs.items() if k.startswith("prefill_"))
        check(n == requests, f"{arch} {dtype}: {n} prefill graph replays for {requests} prompts")
    if repeat is not None:
        lens, before = repeat
        prev = before["graphs"]
        for n in sorted(set(lens)):
            g, p = graphs.get(f"exact_{n}"), prev.get(f"exact_{n}")
            check(g is not None and p is not None and g["capture_s"] is not None
                  and g["eager_steps"] == p["eager_steps"]
                  and g["replays"] - p["replays"] >= lens.count(n),
                  f"{arch} {dtype}: the repeated round's prompts of length {n} did not all "
                  f"replay its captured graph: {p} -> {g}")


def _reduced(arch: str, depth, dtype: str) -> dict:
    """What a serve run cut from the full config, for its lines: {} at full
    depth (no ``depth``, or None for ``dtype``)."""
    run = (depth or {}).get(dtype)
    if run is None:
        return {}
    from repro_torch.configs import get_config

    why = ("the f32 gate's depth, cut to keep the script inside its time limit"
           if dtype == "float32" and run == F32_GATE_LAYERS
           else "the depth one 80 GB card holds at full width")
    return {"num_layers": {"full": get_config(arch).num_layers, "run": run, "why": why}}


def phase_serve(arch: str, serve_kw: dict, path_kernels: tuple, depth=None) -> dict:
    """One served path: the f32 engine against sequential decode, then the
    measured bf16 run. A family without prompt buckets serves its prompts
    :data:`REPEAT_ROUNDS` times on one engine in both dtypes: every later
    round's prefills replay their lengths' graphs, its tokens held to the
    same gate (f32) or to the first round's exactly (bf16); in bf16
    :data:`DRAWN_ROUNDS` rounds of drawn lengths follow."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config(arch)
    rounds = 1 if serve_kw.get("prefill_buckets") else REPEAT_ROUNDS

    def config(dtype):
        layers = (depth or {}).get(dtype)
        return full.replace(dtype=dtype, **({} if layers is None else {"num_layers": layers}))

    prompts = _prompts(full.vocab_size)
    lens = [int(p.size) for p in prompts]
    emit("serve", arch=arch, **_release_device_memory())

    # f32, TF32 off: the engine against sequential batch-1 decode, every round
    model = build_model(config("float32"))
    params = model.init(seed=0)
    runs = _serve(model, params, [prompts] * rounds, serve_kw)
    refs = [_sequential(model, params, prompt, NEW_TOKENS, serve_kw["max_len"])
            for prompt in prompts]
    mismatches = []
    for i, run in enumerate(runs):
        for r, (out, (ref, gaps)) in enumerate(zip(run["outs"], refs)):
            if out != ref:
                j = next(j for j, (a, b) in enumerate(zip(out, ref)) if a != b)
                mismatches.append({"round": i + 1, "request": r, "step": j,
                                   "top2_gap": gaps[j]})
    stats = runs[-1]["stats"]
    emit("serve", arch=arch, dtype="float32", reduced=_reduced(arch, depth, "float32"),
         requests=len(prompts), rounds=rounds, wall_s=[run["wall"] for run in runs],
         ticks=stats["ticks"], preemptions=stats["preemptions"], mismatches=mismatches,
         graph_replays={k: g["replays"] for k, g in stats["graphs"].items()},
         phase_s=time.perf_counter() - t_start)
    _check_graph_replays(arch, "float32", runs[0]["stats"], len(prompts), serve_kw)
    for before, run in zip(runs, runs[1:]):
        _check_graph_replays(arch, "float32", run["stats"], len(prompts), serve_kw,
                             (lens, before["stats"]))
    for m in mismatches:
        check(m["top2_gap"] < TIE_GAP,
              f"{arch} float32 engine tokens differ from sequential decode at a gap of "
              f"{m['top2_gap']} (round {m['round']})")
    del model, params, runs
    # the closed engine sits in a reference cycle holding the f32 weights
    _release_device_memory()

    # bf16: the measured main path, warmed up by one request first; every
    # kernel's count is set to 0 just before the run and read just after
    t_bf16 = time.perf_counter()
    base = config("bfloat16")
    model = build_model(base)
    params = model.init(seed=0)
    _serve(model, params, [prompts[:1]], serve_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    drawn = [_prompts(base.vocab_size, seed=2 + i)
             for i in range(DRAWN_ROUNDS if rounds > 1 else 0)]
    runs = _serve(model, params, [prompts] * rounds + drawn, serve_kw)
    # the wrappers count the launches they run; a graph's replay runs the
    # launches its capture recorded, without the wrappers
    eager = {name: fn.launches for name, fn in counters.items()}
    stats = runs[-1]["stats"]
    graphs = stats["graphs"]
    replayed = {name: sum(g["replays"] * g["captured_launches"].get(name, 0)
                          for g in graphs.values()) for name in counters}
    launches = {name: eager[name] + replayed[name] for name in counters}
    prefills = (rounds + len(drawn)) * len(prompts) + stats["preemptions"]
    outs = runs[0]["outs"]
    lines = [_round_line(run, before["stats"] if before else None)
             for run, before in zip(runs, [None] + runs[:-1])]
    first = lines[0]
    seen = set(lens)
    for line, round_prompts in zip(lines[rounds:], drawn):
        # the drawn lengths: the share the engine had seen before
        repeats = 0
        for p in round_prompts:
            repeats += p.size in seen
            seen.add(p.size)
        line.update(lengths="drawn", prompt_lens=[int(p.size) for p in round_prompts],
                    repeat_share=repeats / len(round_prompts),
                    ttft_p50_over_round_1=line["ttft_p50_s"] / first["ttft_p50_s"],
                    ttft_p99_over_round_1=line["ttft_p99_s"] / first["ttft_p99_s"])
    res = {
        "arch": arch,
        "dtype": "bfloat16",
        "reduced": _reduced(arch, depth, "bfloat16"),
        "params": sum(t.numel() for t in params.parameters()),
        "serve": serve_kw,
        "requests": len(prompts),
        "prompt_lens": lens,
        "tokens": sum(len(o) for o in outs),
        # the first round's figures, as a one-round path reads them
        **{k: first[k] for k in ("wall_s", "tokens_per_s", "ttft_p50_s", "ttft_p99_s",
                                 "ttft_parts_s", "ttft_sum_s", "ttft_share")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ticks": stats["ticks"],
        "preemptions": stats["preemptions"],
        "launches": launches,
        "launches_eager": eager,
        "launches_replayed": replayed,
        "graphs": graphs,
        "prefills": prefills,
        "rounds": lines,
    }
    emit("serve", **res)
    for i, line in enumerate(lines):
        emit("serve_round", arch=arch, dtype="bfloat16", round=i + 1, **line)
    _check_graph_replays(arch, "bfloat16", runs[0]["stats"], len(prompts), serve_kw)
    for i, (before, run) in enumerate(zip(runs, runs[1:rounds])):
        _check_graph_replays(arch, "bfloat16", run["stats"], len(prompts), serve_kw,
                             (lens, before["stats"]))
        check(run["outs"] == outs,
              f"{arch} bf16 round {i + 2}: the tokens differ from the first round's at "
              f"{[r for r, (a, b) in enumerate(zip(run['outs'], outs)) if a != b]}")
    lay = _layer_times(model, params, serve_kw)
    emit("layers", **lay)
    res["layers"] = lay
    emit("serve_graphs", arch=arch, ticks=stats["ticks"],
         graph_replays={k: g["replays"] for k, g in graphs.items()},
         capture_ms={k: None if g["capture_s"] is None else 1e3 * g["capture_s"]
                     for k, g in graphs.items()},
         captured_launches={k: g["captured_launches"] for k, g in graphs.items()},
         peak_mem_bytes=res["peak_mem_bytes"], tokens_per_s=res["tokens_per_s"],
         tick_host_launches={"eager decode_step": lay["decode_host_launches"],
                             "eager tick": lay["tick_eager_host_launches"],
                             "graph tick": lay["tick_graph_host_launches"]},
         tick_device_busy_ms={"eager decode_step": lay["decode_device_busy_ms"],
                              "eager tick": lay["tick_eager_device_busy_ms"],
                              "graph tick": lay["tick_graph_device_busy_ms"]},
         tick_host_ms={"eager decode_step": lay["decode_step_ms_4lanes"],
                       "eager tick": lay["tick_eager_ms_4lanes"],
                       "graph tick": lay["tick_graph_ms_4lanes"]},
         kv_write_ms_S300=lay["kv_write_ms_S300"])
    check(lay["tick_eager_host_launches"] > MAX_TICK_HOST_LAUNCHES,
          f"{arch}: the trace counts {lay['tick_eager_host_launches']} host launches for an "
          "eager tick: the profiler's runtime calls are not being read")
    check(lay["tick_graph_host_launches"] <= MAX_TICK_HOST_LAUNCHES,
          f"{arch}: a decode tick by graph replay issues {lay['tick_graph_host_launches']} "
          f"host launches ({lay['tick_graph_host_launches_by_call']})")
    check(all(len(o) == NEW_TOKENS and all(0 <= t < base.vocab_size for t in o)
              for run in runs for o in run["outs"]),
          f"{arch} bf16 run: a request came back short or with an out-of-vocabulary token")
    for name in path_kernels:
        check(launches[name] >= base.num_layers * prefills,
              f"{arch}: {name} launched {launches[name]} times ({eager[name]} by its wrapper, "
              f"{replayed[name]} by graph replays) for {prefills} prefills of "
              f"{base.num_layers} layers")
        # every bucketed prefill, and every prefill of a repeated round,
        # replays a captured graph
        if serve_kw.get("prefill_buckets") or rounds > 1:
            check(replayed[name] >= base.num_layers * len(prompts),
                  f"{arch}: graph replays ran {name} {replayed[name]} times for "
                  f"{len(prompts)} prefills by graph of {base.num_layers} layers")
    del model, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve", arch=arch, bf16_phase_s=time.perf_counter() - t_bf16,
         phase_s=time.perf_counter() - t_start)
    return res


# the enc-dec and VLM paths, served at full width and depth through the
# model's own entry points (both engines reject these families): B=4
# requests, each with its frames or patches from a seeded generator, a
# prompt of PROMPT tokens, then ENCDEC_VLM_NEW greedy tokens by
# ``decode_step``: (arch, prompt tokens)
ENCDEC_VLM_PATHS = (("whisper-medium", 32), ("paligemma-3b", 64))
ENCDEC_VLM_B, ENCDEC_VLM_NEW = 4, 32
ENCDEC_VLM_TOL = 1e-4  # f32 logits through the kernels vs the plain versions, scaled


def _encdec_vlm_batch(cfg, prompt: int, dtype) -> dict:
    """Tokens (numpy, seed 0) and the family's frames (B, encoder_seq,
    d_model) or patches (B, num_image_tokens, vision_dim), drawn on the
    card from a ``torch.Generator`` seeded 0."""
    import torch

    B = ENCDEC_VLM_B
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt))}
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = ((B, cfg.encoder_seq, cfg.d_model) if cfg.is_encdec
             else (B, cfg.num_image_tokens, cfg.vision_dim))
    batch["frames" if cfg.is_encdec else "patches"] = torch.randn(
        shape, generator=g, device="cuda").to(dtype)
    return batch


def _greedy(model, params, batch, steps: int, force=None) -> dict:
    """``Model.prefill``, ``extend_caches`` by ``steps``, then greedy
    ``decode_step``s: the tokens (B, steps), each step's f32 logits and
    top-2 gaps, the prefill's caches, and the host seconds of the prefill
    and of the decode steps, each to the end of its device work. With
    ``force`` (B, steps), decode feeds those tokens in place of its own
    argmax (teacher forcing), so two runs' logits compare step for step."""
    import torch

    from repro_torch.models.lm import extend_caches

    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_caches = caches
    S = next(iter(caches.values()))["attn"]["k"].shape[2]
    caches = extend_caches(caches, steps)
    toks, steps_logits, gaps = [], [], []
    for i in range(steps):
        last = logits[:, -1].float()
        steps_logits.append(last)
        top = torch.topk(last, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        toks.append(torch.argmax(last, dim=-1))
        if i + 1 < steps:
            feed = toks[-1] if force is None else force[:, i]
            logits, caches = model.decode_step(params, feed[:, None], caches,
                                               torch.full_like(feed, S + i))
    tokens = torch.stack(toks, 1)
    torch.cuda.synchronize()
    return {"tokens": tokens, "logits": torch.stack(steps_logits, 1),
            "gaps": torch.stack(gaps, 1), "caches": prefill_caches, "S": S,
            "prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}


def phase_encdec_vlm(arch: str, prompt: int) -> dict:
    """Serve full-width ``arch`` (whisper-medium or paligemma-3b, random
    weights from seed 0) through ``Model.prefill``, ``extend_caches`` and
    greedy ``decode_step``: in f32 through the kernels and again with the
    model's attention patched to the plain versions (logits and caches
    within :data:`ENCDEC_VLM_TOL` scaled, tokens equal but at a top-2 gap
    below :data:`TIE_GAP`), then in bf16 as the measured path, every
    kernel's launch count set to 0 just before it and read just after (K1
    runs in every prefill layer: whisper's encoder once and decoder twice a
    layer, paligemma's layers once; decode runs none)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import build_model
    from repro_torch.models.lm import extend_caches
    from repro_torch.tree import tree_flatten_with_keys

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("encdec_vlm", arch=arch, **_release_device_memory())
    full = get_config(arch)
    per_prefill = (full.encoder_layers + 2 * full.num_layers if full.is_encdec
                   else full.num_layers)

    # f32: the kernels against the plain versions, on the same weights and inputs
    model = build_model(full.replace(dtype="float32"))
    params = model.init(seed=0)
    batch = _encdec_vlm_batch(model.cfg, prompt, torch.float32)
    flash_attention_bhsd.launches = 0
    ker = _greedy(model, params, batch, ENCDEC_VLM_NEW)
    f32_launches = flash_attention_bhsd.launches
    kernel_fn = attention_mod.flash_attention
    attention_mod.flash_attention = _plain_attention()
    try:
        plain = _greedy(model, params, batch, ENCDEC_VLM_NEW, force=ker["tokens"])
    finally:
        attention_mod.flash_attention = kernel_fn
    scale = max(1.0, plain["logits"].abs().max().item())
    logit_err = (ker["logits"] - plain["logits"]).abs().max().item() / scale
    cache_err = {}
    for (key, a), (_, b) in zip(tree_flatten_with_keys(ker["caches"]),
                                tree_flatten_with_keys(plain["caches"])):
        cache_err[key] = (a.float() - b.float()).abs().max().item() / max(
            1.0, b.float().abs().max().item())
    differ = (ker["tokens"] != plain["tokens"]).nonzero().tolist()
    near_ties = [plain["gaps"][b, i].item() for b, i in differ]
    emit("encdec_vlm", arch=arch, dtype="float32", batch=ENCDEC_VLM_B, prompt=prompt,
         seq=ker["S"], new_tokens=ENCDEC_VLM_NEW, k1_launches=f32_launches,
         logits_scaled_err=logit_err, caches_worst_scaled_err=max(cache_err.values()),
         token_mismatches=len(differ), mismatch_top2_gaps=near_ties, tol=ENCDEC_VLM_TOL,
         phase_s=time.perf_counter() - t_start)
    check(bool(torch.isfinite(ker["logits"]).all()), f"{arch} f32: non-finite logits")
    check(f32_launches == per_prefill,
          f"{arch} f32: K1 launched {f32_launches} times for one prefill of {per_prefill}")
    check(logit_err <= ENCDEC_VLM_TOL,
          f"{arch} f32 logits through the kernels: scaled error {logit_err}")
    check(max(cache_err.values()) <= ENCDEC_VLM_TOL, f"{arch} f32 caches: {cache_err}")
    check(all(g < TIE_GAP for g in near_ties),
          f"{arch} f32 tokens through the kernels differ at top-2 gaps {near_ties}")
    del model, params, batch, ker, plain
    _release_device_memory()

    # bf16: the measured path, warmed up by one run first
    model = build_model(full.replace(dtype="bfloat16"))
    params = model.init(seed=0)
    batch = _encdec_vlm_batch(model.cfg, prompt, torch.bfloat16)
    _greedy(model, params, batch, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out = _greedy(model, params, batch, ENCDEC_VLM_NEW)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    tok = out["tokens"][:, -1:]
    dcaches = extend_caches(out["caches"], 8)
    idx = torch.full((ENCDEC_VLM_B,), out["S"], device="cuda")

    def prefill():
        model.prefill(params, batch)

    def decode():
        model.decode_step(params, tok, dcaches, idx)

    res = {
        "arch": arch, "dtype": "bfloat16", "batch": ENCDEC_VLM_B, "prompt": prompt,
        "seq": out["S"], "new_tokens": ENCDEC_VLM_NEW,
        "params": sum(t.numel() for t in params.parameters()),
        # the measured run: one prefill, then ENCDEC_VLM_NEW - 1 decode steps
        "prefill_ms": 1e3 * out["prefill_s"],
        "decode_ms_per_step": 1e3 * out["decode_s"] / (ENCDEC_VLM_NEW - 1),
        "tokens_per_s": ENCDEC_VLM_B * ENCDEC_VLM_NEW / (out["prefill_s"] + out["decode_s"]),
        "peak_mem_bytes": peak,
        "launches": launches,
    }
    # traced after the run, one prefill and one decode step each
    res.update({f"prefill_{k}": v for k, v in _traced(prefill).items()})
    res.update({f"decode_{k}": v for k, v in _traced(decode).items()})
    if model.cfg.is_encdec:  # the prefill's split: the encoder alone, the rest the decoder's

        def encode():
            with torch.inference_mode():
                model._encode(params, batch["frames"])

        res["encoder_host_ms"] = _host_ms(encode, 3)
        res["decoder_host_ms"] = res["prefill_ms"] - res["encoder_host_ms"]
        traced = _traced(encode)
        res["encoder_device_busy_ms"] = traced["device_busy_ms"]
        res["encoder_k1_device_ms"] = traced["k1_device_ms"]
        res["decoder_device_busy_ms"] = res["prefill_device_busy_ms"] - traced["device_busy_ms"]
        res["decoder_k1_device_ms"] = res["prefill_k1_device_ms"] - traced["k1_device_ms"]
    emit("encdec_vlm", **res)
    check(bool(torch.isfinite(out["logits"]).all()), f"{arch} bf16: non-finite logits")
    check(out["tokens"].shape == (ENCDEC_VLM_B, ENCDEC_VLM_NEW)
          and bool(((out["tokens"] >= 0) & (out["tokens"] < full.vocab_size)).all()),
          f"{arch} bf16: tokens of shape {tuple(out['tokens'].shape)} or out of the vocabulary")
    check(launches["flash_attention"] == per_prefill,
          f"{arch} bf16: K1 launched {launches['flash_attention']} times in the run, want "
          f"{per_prefill} (one prefill; decode runs none)")
    del model, params, batch, out, dcaches
    gc.collect()
    torch.cuda.empty_cache()
    emit("encdec_vlm", arch=arch, phase_s=time.perf_counter() - t_start)
    return res


# the train cells, each at full width and depth but as TRAIN_DEPTH cuts it:
# bf16, remat "full", B=4, S=2048 (the enc-dec and VLM cells: TRAIN_TEXT),
# AdamW, prefetched synthetic batches, through the unchanged Trainer (which
# saves one final checkpoint, into build/, deleted after the phase): (arch,
# steps)
TRAIN_CELLS = (("tinyllama-1.1b", 6), ("mamba2-1.3b", 4), ("hymba-1.5b", 4),
               ("granite-moe-1b-a400m", 4), ("whisper-medium", 4), ("paligemma-3b", 4))
# decoder layers of a train cell cut in depth, to keep the script inside its
# time limit since the train_lm phase came: paligemma's 18 to 9, which
# halves its 35 GB final checkpoint's layers (its 257 216-row embedding stays)
TRAIN_DEPTH = {"paligemma-3b": 9}


def _train_cfg(arch: str):
    """A train cell's bf16 config: the full config, :data:`TRAIN_DEPTH`'s cut."""
    from repro_torch.configs import get_config

    cut = TRAIN_DEPTH.get(arch)
    return get_config(arch).replace(dtype="bfloat16",
                                    **({} if cut is None else {"num_layers": cut}))
TRAIN_KW = dict(seq_len=2048, global_batch=4, lr=3e-4, warmup=2)
# the enc-dec and VLM cells' text tokens a sample: whisper's decoder over its
# published n_text_ctx of 448 (beside its 1500 encoder frames), paligemma's
# 256 after its 256 image patches (S=512): one loss_chunk of 256, so its
# chunked cross-entropy drops no target
TRAIN_TEXT = {"whisper-medium": 448, "paligemma-3b": 256}
# the parity runs: f32, full width and depth, B=1, S spanning at least 4
# chunks of the SSD scan where the model has one (the enc-dec and VLM
# cells: their train shapes): (arch, B, S). Each leaf group's largest
# gradient error against the plain versions', over its largest gradient
# (f32 sums in another order, through every layer)
PARITY_CELLS = (("tinyllama-1.1b", 1, 256), ("mamba2-1.3b", 1, 1024), ("hymba-1.5b", 1, 256),
                ("granite-moe-1b-a400m", 1, 256), ("whisper-medium", 1, 448),
                ("paligemma-3b", 1, 256))
PARITY_TOL = 1e-4


class EncDecVLMTokens:
    """The enc-dec and VLM train cells' data source, the caller's as in the
    reference (``Trainer(data_source=)``): :class:`SyntheticTokens`' tokens
    and targets of ``text_len`` positions, plus an encoder-decoder's frames
    (B, encoder_seq, d_model) or a VLM's patches (B, num_image_tokens,
    vision_dim), standard normal f32 drawn from
    ``np.random.default_rng((seed, step))``: each step's batch is a function
    of the step, so a resumed run reads the same data."""

    def __init__(self, cfg, text_len: int, global_batch: int, *, seed: int = 0) -> None:
        from repro_torch.data import SyntheticTokens

        if not (cfg.is_encdec or cfg.family == "vlm"):
            raise ValueError(f"{cfg.name} takes no frames or patches")
        self.cfg, self.seed, self.global_batch = cfg, seed, global_batch
        self.tokens = SyntheticTokens(cfg.vocab_size, text_len, global_batch, seed=seed)

    def batch(self, step: int) -> dict:
        cfg, B = self.cfg, self.global_batch
        out = self.tokens.batch(step)
        rng = np.random.default_rng((self.seed, step))
        if cfg.is_encdec:
            out["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), np.float32)
        else:
            out["patches"] = rng.standard_normal((B, cfg.num_image_tokens, cfg.vision_dim),
                                                 np.float32)
        return out



def _train_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bhsd, flash_attention_bwd
    from repro_torch.kernels.ssd import ssd_bshp, ssd_bwd

    return {"flash_attention": flash_attention_bhsd, "flash_attention_bwd": flash_attention_bwd,
            "ssd": ssd_bshp, "ssd_bwd": ssd_bwd}


def _launches_per_step(cfg) -> dict:
    """Each kernel's launches in one step with remat "full": every layer's
    forward runs twice (the loss, and its recompute in the backward), its
    backward once, an encoder-decoder's encoder layers and its decoder
    layers' cross-attention as well (each a K1 call of its own); 0 for a
    kernel the model does not run."""
    L = cfg.num_layers
    attn = (cfg.attention != "none") * (L + (cfg.encoder_layers + L) * cfg.is_encdec)
    ssm = L * (cfg.family in ("ssm", "hybrid"))
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "ssd": 2 * ssm, "ssd_bwd": ssm}


def _stale_leaves(params, opt, init) -> dict:
    """Indices of the leaves (in ``tree_leaves`` order) that training left
    behind. ``no_grad``: the first moment is all zero, so no step gave the
    leaf a non-zero gradient element (weight decay alone moves the master,
    never the moment); ``unchanged``: the f32 master equals its init;
    ``off_master``: the parameter is not its master rounded. ``at_init``
    (reported, not a fault): the parameter equals its init, as a bf16 leaf
    may where every update stayed under half its ulp (whisper's LayerNorm
    gains at 1.0, where a step of lr 3e-4 does not move bf16(1.0)).
    ``init`` is a ``ParamTree`` or its leaves, which may wait on the host:
    each comes to the parameter's device in turn (a second copy of
    deepseek-v2's weights would not fit beside its training state)."""
    import torch

    from repro_torch.tree import tree_leaves

    init_leaves = tree_leaves(init.tree()) if hasattr(init, "tree") else init
    leaves = zip(tree_leaves(params.tree()), tree_leaves(opt["master"]), init_leaves,
                 tree_leaves(opt["m"]), strict=True)
    out = {"no_grad": [], "unchanged": [], "off_master": [], "at_init": []}
    for k, (p, mst, i, m1) in enumerate(leaves):
        i = i.to(p.device)
        if not bool(m1.ne(0).any()):
            out["no_grad"].append(k)
        if torch.equal(mst, i.float()):
            out["unchanged"].append(k)
        if not torch.equal(p, mst.to(p.dtype)):
            out["off_master"].append(k)
        if torch.equal(p, i):
            out["at_init"].append(k)
    return out


# a leaf's bits are digested in pieces of this many elements
DIGEST_PIECE = 1 << 24


def _state_digests(state: dict):
    """One int64 digest a leaf of the train state (params, moments, masters,
    the counter), on the device: the leaf's bits as integers times their
    positions' odd weights, summed modulo 2**64 (any order gives the same
    sum). Equal leaves give equal digests; a leaf that differs in any bit
    changes its digest but by a coincidence of weights, so two runs'
    digests hold them bit for bit without a second copy of the state
    beside the first (deepseek-v2's would not fit)."""
    import torch

    from repro_torch.tree import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_leaves({"params": state["params"].tree(), "opt": state["opt"]}):
        flat = t.detach().reshape(-1).view(ints[t.element_size()])
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, flat.numel(), DIGEST_PIECE):
            x = flat[i:i + DIGEST_PIECE].to(torch.int64)
            w = torch.arange(i, i + x.numel(), dtype=torch.int64, device=t.device)
            total += (x * (w * 2654435761 + 1)).sum()
        out.append(total)
    return torch.stack(out).cpu()


def _trainer_steps(tr) -> tuple:
    """A Trainer's (init, step, batch) for :func:`_eager_reference`: a fresh
    state, its eager ``train_step`` and the run's batch of a step."""
    from repro_torch.data import to_device

    return tr.init_state, tr.train_step, lambda step: to_device(tr.data.batch(step), tr.device)


def _eager_reference(steps: int, init, train_step, batch_of) -> dict:
    """The eager loop a train graph is held against: ``steps`` eager steps
    (``train_step(state, batch, step)``, its metrics) of a fresh state
    (``init()``) on the run's batches (``batch_of(step)``; the device
    drained before and after each, for its step time), one more under the
    profiler, and the state's digests after it; the state is freed before
    the graph's run takes the card."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    state = init()
    rows, steps_s = [], []
    for step in range(steps):
        batch = batch_of(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(state, batch, step)
        rows.append({k: float(v) for k, v in met.items()})  # waits for the device
        steps_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    batch = batch_of(steps)
    trace = _traced(lambda: train_step(state, batch, steps), top=6)
    digests = _state_digests(state)
    del state, batch
    _release_device_memory()
    return {"rows": rows, "step_s": steps_s, "step_s_median_after_first":
            float(np.median(steps_s[1:])), "peak_mem_bytes": peak,
            "peak_reserved_bytes": peak_reserved, "trace": trace, "digests": digests}


def _graph_launches(ran: dict, graph: dict) -> dict:
    """Each kernel's launches in a run through the train graph: the eager
    warm-ups' (``ran``: the wrappers count the launches they run) plus each
    replay's captured ones (a replay runs them without the wrappers)."""
    return {name: n + graph["replays"] * graph["captured_launches"].get(name, 0)
            for name, n in ran.items()}


def _graph_line(arch: str, eager: dict, rows: list, steps_s: list, state: dict, trace: dict,
                graph: dict, per_step: dict, peaks: dict) -> dict:
    """The train graph against the eager loop on one cell, emitted as the
    ``train_graph`` line: every step's metrics and every leaf's digest
    after the traced step equal (else the phase fails), the capture, the
    launches captured by kernel, and graph beside eager: step s, traced
    busy ms, idle share, host launches a step, peak memory."""
    digests = _state_digests(state)
    differ = (digests != eager["digests"]).nonzero().flatten().tolist()
    metrics = [{k: v for k, v in r.items() if k not in ("step", "step_s")} for r in rows]
    keys = ("traced_ms", "device_busy_ms", "device_idle_share", "host_launches",
            "kernel_launches", "k1_device_ms", "k1_bwd_device_ms", "k2_device_ms",
            "k2_bwd_device_ms", "gemm_device_ms")
    line = {
        "arch": arch, "metrics_equal": metrics == eager["rows"], "leaves": len(digests),
        "leaves_differing": differ[:20], "bit_for_bit": not differ and metrics == eager["rows"],
        "eager_steps": graph["eager_steps"], "replays": graph["replays"],
        "capture_s": graph["capture_s"], "captured_launches": graph["captured_launches"],
        "captured_launches_want": {k: n for k, n in per_step.items() if n},
        # the replays' own rows: the warm-up runs eagerly and the next step
        # is captured before its replay
        "step_s": {"graph": float(np.median(steps_s[1 + graph["eager_steps"]:])),
                   "eager": eager["step_s_median_after_first"]},
        "step_s_rows": {"graph": steps_s, "eager": eager["step_s"]},
        **{k: {"graph": trace[k], "eager": eager["trace"][k]} for k in keys},
        "peak_mem_bytes": {"graph": peaks["allocated"], "eager": eager["peak_mem_bytes"]},
        "peak_reserved_bytes": {"graph": peaks["reserved"], "eager": eager["peak_reserved_bytes"]},
        "pool_bytes": graph["pool_bytes"],
    }
    emit("train_graph", **line)
    check(line["metrics_equal"], f"{arch}: the graph's metrics {metrics} against the eager "
          f"loop's {eager['rows']}")
    check(not differ, f"{arch}: {len(differ)} of {len(digests)} state leaves differ from the "
          f"eager loop's (first {differ[:20]})")
    check(line["captured_launches"] == line["captured_launches_want"],
          f"{arch}: captured launches {graph['captured_launches']}, want "
          f"{line['captured_launches_want']} a step")
    return line


def phase_train(arch: str, steps: int) -> dict:
    """Train full-width ``arch`` for ``steps`` bf16 steps through
    ``repro_torch.runtime.Trainer`` (prefetched synthetic batches, the loss
    with remat, autograd through the kernels forward and backward, AdamW,
    the final checkpoint saved on the pool into ``build/`` and deleted at
    the end), its step one CUDA graph after an eager warm-up, checking
    every kernel's launches a step (eager plus replayed); first the same
    steps eagerly on a fresh state, which the graph's states and metrics
    must equal bit for bit (the ``train_graph`` line)."""
    import shutil

    import torch

    from repro_torch.analysis.roofline import step_model_flops
    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    allocated = _release_device_memory()
    cfg = _train_cfg(arch)
    check(cfg.remat == "full", f"{arch} trains with remat {cfg.remat!r}")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    emit("train", arch=arch, **allocated, disk_free_bytes=free)
    tcfg = TrainerConfig(num_steps=steps, checkpoint_every=10 * steps, log_every=1, **TRAIN_KW)
    B = TRAIN_KW["global_batch"]
    # the enc-dec and VLM cells' source; else the Trainer's own SyntheticTokens
    data = (EncDecVLMTokens(cfg, TRAIN_TEXT[arch], B, seed=tcfg.seed) if arch in TRAIN_TEXT
            else None)
    tr = Trainer(cfg, tcfg, str(ckpt_dir), device="cuda:0", data_source=data)
    try:
        counters = _train_counters()
        eager = _eager_reference(steps, *_trainer_steps(tr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        out = tr.run(resume=False)
        graph = tr.graph.stats()
        ran = {name: fn.launches for name, fn in counters.items()}
        launches = _graph_launches(ran, graph)
        peaks = {"allocated": torch.cuda.max_memory_allocated(),
                 "reserved": torch.cuda.max_memory_reserved()}
        # each logged row's step_s: the step's wall time, the device drained
        # at both ends (log_every=1); the save's record from the manager
        steps_s = [r["step_s"] for r in out["metrics"]]
        check(len(tr.ckpt.saves) == 1, f"saves recorded: {tr.ckpt.saves}")
        save = tr.ckpt.saves[0]
        peak = peaks["allocated"]
        saved = sorted(p.name for p in ckpt_dir.iterdir())
        check(saved == [f"step_{steps:08d}"], f"checkpoints after the run: {saved}")
        on_disk = sum(f.stat().st_size for f in (ckpt_dir / saved[0]).iterdir())

        rows = out["metrics"]
        params, opt = out["params"], out["opt"]
        n_params = sum(p.numel() for p in params.parameters())
        check(len(rows) == steps, f"{len(rows)} metric rows for {steps} steps")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
              f"a non-finite loss or grad norm: {rows}")
        # the MoE layers' load-balancing loss rides on the loss: finite, > 0
        check(all(np.isfinite(r["aux"]) and (r["aux"] > 0) == cfg.is_moe for r in rows),
              f"{arch}: aux losses {[r['aux'] for r in rows]}")
        stale = _stale_leaves(params, opt, tr.model.init(tcfg.seed))
        check(not stale["no_grad"],
              f"{len(stale['no_grad'])} leaves took no gradient in {steps} steps: {stale}")
        check(not stale["unchanged"], f"master leaves unchanged after training: {stale}")
        check(not stale["off_master"], f"parameter leaves differ from their master: {stale}")
        dtypes = {part: sorted({str(t.dtype) for t in tree_leaves(opt[part])})
                  for part in ("m", "v", "master")}
        dtypes["count"] = str(opt["count"].dtype)
        dtypes["params"] = sorted({str(t.dtype) for t in params.parameters()})
        # the SSM leaves a_log, d_skip and dt_bias and the MoE router stay
        # f32 in a bf16 model; every other leaf is bf16
        f32_leaves = cfg.family in ("ssm", "hybrid") or cfg.is_moe
        want_params = ["torch.bfloat16"] + (["torch.float32"] if f32_leaves else [])
        check(dtypes == {"m": ["torch.float32"], "v": ["torch.float32"],
                         "master": ["torch.float32"], "count": "torch.int32",
                         "params": want_params}, f"state dtypes {dtypes}")
        per_step = _launches_per_step(cfg)
        for name, n in per_step.items():
            check(launches[name] == n * steps,
                  f"{arch}: {name} launched {launches[name]} times in {steps} steps, "
                  f"want {n} a step")

        # one more step, under the profiler: a replay
        state = {"params": params, "opt": opt}
        batch = to_device(tr.data.batch(steps), tr.device)
        trace = _traced(lambda: tr.graph(batch, steps), top=6)
        line = _graph_line(arch, eager, rows, steps_s, state, trace, graph, per_step, peaks)
        S = TRAIN_TEXT.get(arch, TRAIN_KW["seq_len"])
        # the positions a sample runs through the decoder-side layers, and
        # the encoder's
        positions = S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        frames = cfg.encoder_seq if cfg.is_encdec else 0
        step_s = line["step_s"]["graph"]  # the replays' rows, as the train_graph line
        flops, formula, n_pos = step_model_flops(cfg, params, B, S)
        res = {
            "arch": arch, "dtype": "bfloat16", "steps": steps, "batch": B,
            "num_layers": {"full": get_config(arch).num_layers, "run": cfg.num_layers},
            "seq_len": S, "decoder_positions": positions, "encoder_frames": frames,
            "remat": cfg.remat, "params": n_params,
            "loss": [r["loss"] for r in rows], "aux": [r["aux"] for r in rows],
            "grad_norm": [r["grad_norm"] for r in rows],
            "lr": [r["lr"] for r in rows],
            "step_s": steps_s, "step_s_median_of_replays": step_s,
            "tokens_per_s": B * S / step_s,
            "positions_per_s": B * (positions + frames) / step_s,
            "peak_mem_bytes": peak,
            "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "launches_eager": ran,
            "graph": graph, "eager": {k: line[k]["eager"] for k in (
                "step_s", "device_busy_ms", "device_idle_share", "host_launches",
                "peak_mem_bytes")},
            "model_flops_per_step": flops, "model_flops_formula": formula,
            "model_flops_param_positions": n_pos,
            "model_flop_share_of_989_tflops": flops / step_s / PEAK_BF16_FLOPS,
            "ckpt": {"disk_free_bytes_before": free, "bytes": save["bytes"],
                     "bytes_on_disk": on_disk, "seconds": save["seconds"],
                     "snapshot_s": save["snapshot_s"]},
            "state_dtypes": dtypes,
            "bf16_leaves_at_init": len(stale["at_init"]),
        }
        res.update({f"step_{k}": v for k, v in trace.items()})
        res["step_k1_bwd_share_of_busy"] = trace["k1_bwd_device_ms"] / trace["device_busy_ms"]
        res["step_k2_bwd_share_of_busy"] = trace["k2_bwd_device_ms"] / trace["device_busy_ms"]
        emit("train", **res)
    finally:
        tr.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(not ckpt_dir.exists(), f"{ckpt_dir} was not removed")
    del tr, out, params, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    emit("train", arch=arch, ckpt_removed=True, phase_s=time.perf_counter() - t_start)
    return res


# the port's entry points as a user runs them (the train_lm phase): the
# training tutorial at its defaults with --fail (300 steps, B=8, S=256, f32,
# 124 649 472 parameters by param_count, a failure injected at step 150,
# checkpoints every 75 steps), then the serving example at its defaults and
# the training launcher on reduced tinyllama together, each a process of
# its own on the card, with a time limit (seconds)
TRAIN_LM = dict(steps=300, seq=256, batch=8, fail_at=150, every=75, params=124_649_472,
                layers=12, limit=600)
TRAIN_LM_LAUNCH = ("--arch", "tinyllama-1.1b", "--reduced", "--steps", "20", "--ckpt-every",
                   "5", "--fail-at", "10")
ENTRY_POINT_LIMIT = 300


def _entry_points(runs: dict, limit: float) -> dict:
    """Start ``python argv`` for each ``label: argv`` of ``runs`` at once,
    from the checkout's root on the card (the visible one),
    ``PYTHONPATH=src``; emit each one's exit code, seconds (to the reading
    of its output) and last output lines (a ``train_lm`` line), fail unless
    each exits 0, and return each one's output lines. Every process still
    running at ``limit`` seconds is killed."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {label: subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for label, argv in runs.items()}
    out = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=max(1.0, limit - time.perf_counter() + t0))
            out[label] = stdout.splitlines()
            emit("train_lm", run=label, argv=runs[label], rc=proc.returncode,
                 seconds=time.perf_counter() - t0,
                 stdout=[ln for ln in out[label] if not ln.startswith("summary:")][-40:],
                 stderr=stderr.splitlines()[-20:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, proc in procs.items():
        check(proc.returncode == 0, f"{label}: exit code {proc.returncode}")
    return out


def _restarts(lines: list) -> list:
    return [ln for ln in lines if ln.startswith("[trainer] restart")]


def phase_train_lm() -> dict:
    """The training tutorial ``examples/train_lm_torch.py`` at its defaults
    with ``--fail`` (:data:`TRAIN_LM`), a fresh checkpoint directory under
    ``build/`` (``run_with_restarts`` would resume from a stale one):
    one restart after the failure at step 150, resumed from the step-150
    checkpoint into a new capture (one eager step and one capture a run,
    the rest replays), the checkpoints at 75, 150, 225 and 300 committed,
    every logged loss finite and the last below the first, and K1 and
    K1-bwd launched once a layer a step (no remat; the tutorial's counters
    plus replays x captured). Then the serving example at its defaults
    (reduced tinyllama, 8 requests; it exits non-zero if its streamed
    tokens and its future's differ) and the training launcher
    (:data:`TRAIN_LM_LAUNCH`, a fresh directory, one restart), side by
    side. Returns the tutorial's launches for the kernels line."""
    import shutil

    t_start = time.perf_counter()
    allocated = _release_device_memory()
    ckpt = ROOT / "build" / "chip_smoke_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, fail_at, layers = TRAIN_LM["steps"], TRAIN_LM["fail_at"], TRAIN_LM["layers"]
    try:
        lines = _entry_points({"train_lm": ["examples/train_lm_torch.py", "--fail",
                                            "--ckpt", str(ckpt)]}, TRAIN_LM["limit"])["train_lm"]
        run = json.loads(next(ln for ln in lines if ln.startswith("summary:"))[8:])
        committed = sorted(p.name for p in ckpt.iterdir() if (p / "manifest.json").exists())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rows, graphs = run["rows"], run["graphs"]
    losses = [r["loss"] for r in rows]
    saves = sorted(run["checkpoints"], key=lambda c: c["step"])
    check((run["device"], run["params"], run["steps"], run["seq"], run["batch"])
          == ("cuda:0", TRAIN_LM["params"], steps, TRAIN_LM["seq"], TRAIN_LM["batch"]),
          f"train_lm ran {run}")
    check(_restarts(lines) == [f"[trainer] restart 1 after: injected failure at step {fail_at}"]
          and run["restarts"] == 1, f"train_lm restarts: {_restarts(lines)}")
    check([g["start_step"] for g in graphs] == [0, fail_at],
          f"train_lm runs started at {[g['start_step'] for g in graphs]}")
    check(all(g["eager_steps"] == 1 and g["capture_s"] is not None for g in graphs)
          and [g["eager_steps"] + g["replays"] for g in graphs] == [fail_at, steps - fail_at],
          f"train_lm graphs {graphs}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
          and losses[-1] < losses[0], f"train_lm losses {losses}")
    want_saves = list(range(TRAIN_LM["every"], steps + 1, TRAIN_LM["every"]))
    check([c["step"] for c in saves] == want_saves, f"train_lm saves {saves}")
    check(f"step_{steps:08d}" in committed, f"train_lm: committed checkpoints {committed}")
    want = {"flash_attention": layers, "flash_attention_bwd": layers}
    check(all(g["captured_launches"] == want for g in graphs),
          f"train_lm captured {[g['captured_launches'] for g in graphs]}, want {want}")
    check(run["launches"] == {k: n * steps for k, n in want.items()},
          f"train_lm launched {run['launches']} in {steps} steps, want {want} a step")
    res = {
        "arch": "train_lm tutorial (lm-100m, f32)",
        "launches": {name: run["launches"].get(name, 0) for name in _train_counters()},
    }
    tutorial = {
        "model": run["model"], "params": run["params"], "card": run["card"], "steps": steps,
        "batch": run["batch"], "seq_len": run["seq"], "restarts": run["restarts"],
        "resumed_from": graphs[1]["start_step"], "wall_s": run["wall_s"],
        "tokens_per_s_wall": run["tokens_per_s"], "step_s_median": run["step_s_median"],
        "tokens_per_s_median_step": run["seq"] * run["batch"] / run["step_s_median"],
        "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
        "step_s_rows": [r["step_s"] for r in rows],
        "peak_mem_bytes": run["peak_mem_bytes"], "capture_s": [g["capture_s"] for g in graphs],
        "replays": [g["replays"] for g in graphs],
        "launches_per_step": {k: n / steps for k, n in run["launches"].items()},
        "checkpoints": saves, "committed": committed, **allocated,
    }
    emit("train_lm", **tutorial)

    launch_ckpt = ROOT / "build" / "chip_smoke_launch_train"
    shutil.rmtree(launch_ckpt, ignore_errors=True)
    try:
        out = _entry_points({
            "launch_train": ["-m", "repro_torch.launch.train", *TRAIN_LM_LAUNCH,
                             "--ckpt", str(launch_ckpt)],
            "serve_lm": ["examples/serve_lm_torch.py"]}, ENTRY_POINT_LIMIT)
    finally:
        shutil.rmtree(launch_ckpt, ignore_errors=True)
    check(any(ln.startswith("streamed token ids") for ln in out["serve_lm"]),
          "serve_lm streamed nothing")
    lines = out["launch_train"]
    logged = [ln for ln in lines if ln.startswith("step ")]
    check(_restarts(lines) == ["[trainer] restart 1 after: injected failure at step 10"]
          and len(logged) == 20 and all(np.isfinite(float(ln.split()[3])) for ln in logged),
          f"launch_train: {lines[-25:]}")
    res["phase_s"] = time.perf_counter() - t_start
    emit("train_lm", phase_s=res["phase_s"])
    return res


def _plain_attention():
    """The model's attention call, for the parity runs only: the plain
    versions forward (``flash_attention_lse_ref``) and backward
    (``flash_attention_bwd_ref``), in the model's layout."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, k_len, prefix_len):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            o, lse = fa.flash_attention_lse_ref(qt, kt, vt, causal=causal, window=window,
                                                k_len=k_len, prefix_len=prefix_len)
            ctx.save_for_backward(qt, kt, vt, o, lse)
            ctx.mask = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix_len)
            return o.transpose(1, 2)

        @staticmethod
        def backward(ctx, do):
            qt, kt, vt, o, lse = ctx.saved_tensors
            grads = fa.flash_attention_bwd_ref(qt, kt, vt, o, lse, do.transpose(1, 2),
                                               **ctx.mask)
            return (*(g.transpose(1, 2) for g in grads), None, None, None, None)

    def attention(q, k, v, *, causal=True, window=None, k_len=None, prefix_len=None):
        return Plain.apply(q, k, v, causal, window, k_len, prefix_len)

    return attention


def _plain_ssd():
    """The SSM layer's scan call, for the parity run only: the plain
    versions forward (``ssd_ref``) and backward (``ssd_bwd_ref``)."""
    import torch

    from repro_torch.kernels import ssd as tssd

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, chunk):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.chunk = chunk
            return tssd.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)

        @staticmethod
        def backward(ctx, dy, dfinal):
            x, dt, A, Bm, Cm = ctx.saved_tensors
            dy = torch.zeros_like(x) if dy is None else dy
            return (*tssd.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=ctx.chunk), None)

    def ssd_bshp(x, dt, A, Bm, Cm, *, chunk=64, return_final_state=False):
        y, final = Plain.apply(x, dt, A, Bm, Cm, chunk)
        return (y, final) if return_final_state else y

    return ssd_bshp


def phase_train_parity(arch: str, B: int, S: int, depth=None) -> dict:
    """Loss and every gradient of full-width ``arch`` in f32 on the card
    (full depth, or ``depth`` decoder layers), through the kernels and then
    with the model's attention and scan calls patched (here only) to the
    plain versions; the largest scaled error per leaf group. With a
    ``depth``, the kernels' gradients wait on the host while the plain run
    takes the card (deepseek-v2's two layers are 21.4 GB of f32 weights)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.tree import tree_flatten_with_keys

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _release_device_memory()
    cfg = get_config(arch).replace(dtype="float32")
    if depth is not None:
        cfg = cfg.replace(num_layers=depth)
    model = build_model(cfg, device="cuda:0")
    params = model.init(seed=0)
    src = (EncDecVLMTokens(cfg, S, B) if arch in TRAIN_TEXT
           else SyntheticTokens(cfg.vocab_size, S, B, seed=0))
    batch = src.batch(0)
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
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    if depth is not None:
        grads_k = [g.cpu() for g in grads_k]
    kernel_fns = attention_mod.flash_attention, ssm_mod.ssd_bshp
    attention_mod.flash_attention, ssm_mod.ssd_bshp = _plain_attention(), _plain_ssd()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        attention_mod.flash_attention, ssm_mod.ssd_bshp = kernel_fns
    groups = {}  # leaf group (layer index dropped) -> (max abs diff, max abs plain)
    for (key, _), gk, gp in zip(keyed, grads_k, grads_p):
        group = ".".join(part for part in key.split(".") if not part.isdigit())
        d, m = (gk.to(gp.device) - gp).abs().max().item(), gp.abs().max().item()
        d0, m0 = groups.get(group, (0.0, 0.0))
        groups[group] = (max(d, d0), max(m, m0))
    scaled = {g: d / m if m else d for g, (d, m) in groups.items()}
    worst = max(scaled.values())
    chunks = -(-S // cfg.ssm_chunk) if cfg.family in ("ssm", "hybrid") else None
    emit("train_parity", arch=arch, dtype="float32", batch=B, seq_len=S, layers=cfg.num_layers,
         ssd_chunks=chunks,
         loss_kernels=loss_k, loss_plain=loss_p, launches=launches, scaled_grad_err=scaled,
         worst=worst, tol=PARITY_TOL, finite=finite, phase_s=time.perf_counter() - t_start)
    check(finite and np.isfinite(loss_k), f"{arch}: non-finite loss or gradient through the kernels")
    check(abs(loss_k - loss_p) <= PARITY_TOL * max(1.0, abs(loss_p)),
          f"{arch}: loss through the kernels {loss_k} against {loss_p}")
    check(worst <= PARITY_TOL, f"{arch}: gradients through the kernels: worst scaled error {worst}")
    check(chunks is None or chunks >= 4, f"{arch}: the parity run spans {chunks} SSD chunks")
    check(launches == _launches_per_step(cfg), f"{arch}: parity run launches {launches}")
    del model, params, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "worst": worst, "scaled": scaled}


# deepseek-v2-236b trained on one card at full width: the depth and S from
# the dry run (the deepest depth, at least the dense layer 0 and one MoE
# layer, whose predicted peak leaves FREE_BYTES of the card free, then the
# longest of DEEPSEEK_SEQS that does at that depth), B=1, AdamW's moments
# in bf16 (the reference's rule for a config over 1e11 parameters, applied
# to the full config) and moe_dense, as the single-device reference runs
# it; its f32 gradient gate at depth 2, B=1, S=256
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_MIN_DEPTH = 2
DEEPSEEK_SEQS = (2048, 1024, 512)
FREE_BYTES = 10e9
PLANNED_STEPS = 4
DEEPSEEK_PARITY = (1, 256, DEEPSEEK_MIN_DEPTH)
# the head-dim-128 dense configs trained at the train cells' shape (B=4,
# S=2048, bf16, remat "full", AdamW's moments f32), each at the deepest
# depth, walked down from its full depth, whose predicted peak leaves
# FREE_BYTES of the card free (phi4-mini 29 of 32 layers, qwen1.5 all 40);
# no checkpoint, as deepseek-v2's cell; their f32 gradient gate at full
# depth, B=1, S=256 (15 and 16 GB of f32 weights, three such sets with
# both runs' gradients)
DENSE_TRAIN = ("phi4-mini-3.8b", "qwen1.5-4b")
DENSE_PARITY = (1, 256, None)
# the served config that does not fit the card at full depth, and the
# shape its depth is planned at: four prompts of the engine's largest
# bucket at once (deepseek-coder's 62 layers are 81.25 GB of bf16 weights),
# beside the caches the engine keeps (_engine_cache_bytes)
SERVE_PLANNED = "deepseek-coder-33b"
SERVE_PLAN_SPEC = {"kind": "prefill", "seq_len": 512, "global_batch": 4}
DRYRUN_LOG = ROOT / "build" / "chip_smoke_dryrun.jsonl"
# the fake-world cell the dryrun phase runs beside the single-device ones
DRYRUN_MESH_CELL = ("tinyllama-1.1b", "train_4k", (16, 16))


def _train_spec(cfg, B: int, S: int) -> dict:
    """A train cell's shape as the dry run takes it: ``S`` text tokens, a
    VLM's patches ahead of them."""
    extra = cfg.num_image_tokens if cfg.family == "vlm" else 0
    return {"kind": "train", "seq_len": S + extra, "global_batch": B}


def _engine_cache_bytes(cfg, serve_kw: dict) -> int:
    """The KV caches a ``ServeEngine`` with ``serve_kw`` keeps on the card
    beside the weights and a prefill's activations, which the dry run's
    prefill does not hold: its paged pool and the decode graph's gathered
    caches (``max_slots`` lanes of ``max_len`` positions each) and each
    prefill bucket's graph's static cache (one prompt of the bucket)."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    model = build_model(cfg, device="cpu")

    def nbytes(batch, seq):
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(model.cache_shapes(batch, seq)))

    return (2 * nbytes(serve_kw["max_slots"], serve_kw["max_len"])
            + sum(nbytes(1, b) for b in serve_kw.get("prefill_buckets", ())))


def _deepest(peak, full_depth: int, limit: float) -> tuple:
    """The deepest depth from ``full_depth`` down whose ``peak(depth)`` is
    at most ``limit`` (1 if none is), and each depth's peak on the way."""
    preds = {}
    depth = full_depth
    while True:
        preds[depth] = peak(depth)
        if preds[depth] <= limit or depth == 1:
            return depth, preds
        depth -= 1


def _dryrun_child(total_bytes: int, path: str) -> None:
    """The dry run's predictions, in a process of their own on the host (it
    touches no card): deepseek-v2's train plan, deepseek-coder's serve
    plan, the dense head-dim-128 train cells' plans, then each train cell's
    single-device peak at its shape (AdamW's moments in f32, as ``Trainer``
    keeps them and the reference's rule gives them under 1e11 parameters),
    then one cell on a fake world of 256 ranks.
    One JSON line each into ``path``. It runs at the lowest priority on one
    thread: beside it the card's phases time host-bound paths (eager
    prefills, kernel enqueues), which a process competing for the host's
    cores at their priority slows."""
    import torch

    os.nice(19)
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import moments_dtype_for, run_cell

    def write(**fields):
        with open(path, "a") as f:
            f.write(json.dumps(fields, default=float) + "\n")

    limit = total_bytes - FREE_BYTES
    full = get_config(DEEPSEEK)
    preds = {}

    def peak(depth, S):
        if (depth, S) not in preds:
            cfg = full.replace(num_layers=depth, dtype="bfloat16")
            r = run_cell(cfg, "train", _train_spec(cfg, 1, S), None, full_cfg=full,
                         verbose=False)
            preds[(depth, S)] = r["memory"]["peak_bytes"]
        return preds[(depth, S)]

    depth = DEEPSEEK_MIN_DEPTH
    while depth < full.num_layers and peak(depth + 1, min(DEEPSEEK_SEQS)) <= limit:
        depth += 1
    fitting = [S for S in DEEPSEEK_SEQS if peak(depth, S) <= limit]
    seq = fitting[0] if fitting else min(DEEPSEEK_SEQS)
    write(kind="deepseek_plan", arch=DEEPSEEK, depth=depth, seq=seq, batch=1,
          moments=moments_dtype_for(full), limit_bytes=limit, fits=bool(fitting),
          predicted_peak_bytes=peak(depth, seq), parity=DEEPSEEK_PARITY,
          predictions=[{"depth": d, "seq": S, "peak_bytes": b} for (d, S), b in preds.items()])

    def planned(arch, shape, spec, serve_kw=None):
        full = get_config(arch)

        def peak_at(depth):
            cfg = full.replace(num_layers=depth, dtype="bfloat16")
            peak = run_cell(cfg, shape, spec, None, full_cfg=full,
                            verbose=False)["memory"]["peak_bytes"]
            return peak + (_engine_cache_bytes(cfg, serve_kw) if serve_kw else 0)

        depth, by_depth = _deepest(peak_at, full.num_layers, limit)
        return {"arch": arch, "depth": depth, "full_depth": full.num_layers,
                "limit_bytes": limit, "fits": by_depth[depth] <= limit,
                "predicted_peak_bytes": by_depth[depth], "moments": moments_dtype_for(full),
                "predictions": [{"depth": d, "peak_bytes": b} for d, b in by_depth.items()]}

    write(kind="serve_plan", seq_len=SERVE_PLAN_SPEC["seq_len"],
          batch=SERVE_PLAN_SPEC["global_batch"], engine_kw=BUCKETED,
          **planned(SERVE_PLANNED, "prefill", SERVE_PLAN_SPEC, BUCKETED))
    B, S = TRAIN_KW["global_batch"], TRAIN_KW["seq_len"]
    for arch in DENSE_TRAIN:
        cfg = get_config(arch)
        write(kind="train_plan", seq=S, batch=B, parity=DENSE_PARITY,
              **planned(arch, "train", _train_spec(cfg, B, S)))
    for arch, _steps in TRAIN_CELLS:
        cfg = _train_cfg(arch)
        S = TRAIN_TEXT.get(arch, TRAIN_KW["seq_len"])
        r = run_cell(cfg, "train", _train_spec(cfg, TRAIN_KW["global_batch"], S), None,
                     verbose=False)
        write(kind="train_cell", arch=arch, result=r)
    arch, shape, mesh = DRYRUN_MESH_CELL
    cfg = get_config(arch)
    r = run_cell(cfg, shape, dict(cfg.shapes()[shape]), mesh, verbose=False)
    write(kind="mesh_cell", result=r)


class DryRuns:
    """The dry-run process (:func:`_dryrun_child`), started with the script
    and joined by the ``dryrun`` phase (or killed when the script ends)."""

    def __init__(self) -> None:
        import multiprocessing

        import torch

        DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
        DRYRUN_LOG.unlink(missing_ok=True)
        self.total_bytes = torch.cuda.get_device_properties(0).total_memory
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_dryrun_child, args=(self.total_bytes, str(DRYRUN_LOG)), daemon=True)
        self.proc.start()

    def lines(self) -> list:
        return ([json.loads(ln) for ln in DRYRUN_LOG.read_text().splitlines()]
                if DRYRUN_LOG.exists() else [])

    def wait_for(self, kind: str, arch=None, timeout: float = 600.0) -> dict:
        """The first line of ``kind`` (and ``arch``, if given), waiting for
        the process to write it."""
        end = time.perf_counter() + timeout
        while True:
            found = [ln for ln in self.lines()
                     if ln["kind"] == kind and arch in (None, ln.get("arch"))]
            if found:
                return found[0]
            check(self.proc.is_alive() or self.proc.exitcode == 0,
                  f"the dry run exited with {self.proc.exitcode} before its {kind} line")
            check(time.perf_counter() < end, f"no {kind} line from the dry run in {timeout} s")
            time.sleep(0.5)

    def join(self, timeout: float = 600.0) -> list:
        self.proc.join(timeout)
        check(self.proc.exitcode == 0, f"the dry run exited with {self.proc.exitcode}")
        return self.lines()

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(30)


def phase_planned_train(plan: dict) -> dict:
    """A config trained at full width on one card, its depth, S, B and
    AdamW's moments from the dry run's ``plan`` (deepseek-v2's, as the
    ``deepseek_train`` phase, and the dense head-dim-128 cells', as
    ``dense_train``): ``PLANNED_STEPS`` bf16 steps through ``Trainer``'s
    train graph (``Trainer.step_graph``, what ``Trainer.run`` steps
    through; no checkpoint), after the same steps eagerly, which they equal
    bit for bit (the ``train_graph`` line), with the train cells' gates
    (finite loss, grad norm and aux loss, the aux loss > 0 exactly for MoE;
    every leaf a gradient, its master moved and its bf16 copy the master
    rounded; every kernel's launches a step exact), tokens/s, the
    model-FLOP share, the peak beside the dry run's prediction and a traced
    step; then the f32 gradient gate (``phase_train_parity``) at the plan's
    ``parity`` (B, S, depth)."""
    import torch

    from repro_torch.analysis.roofline import step_model_flops
    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    allocated = _release_device_memory()
    arch, depth, S, B, steps = plan["arch"], plan["depth"], plan["seq"], plan["batch"], PLANNED_STEPS
    phase = "deepseek_train" if arch == DEEPSEEK else "dense_train"
    full = get_config(arch)
    cfg = full.replace(dtype="bfloat16", num_layers=depth)
    check(cfg.remat == "full", f"{arch} trains with remat {cfg.remat!r}")
    reduced = ({} if depth == full.num_layers else {"num_layers": {
        "full": full.num_layers, "run": depth,
        "why": f"the deepest depth whose predicted peak leaves {FREE_BYTES:.0f} bytes of the "
               "card free"}})
    emit(phase, arch=arch, depth=depth, seq_len=S, batch=B, moments=plan["moments"],
         reduced=reduced, **allocated)
    tcfg = TrainerConfig(num_steps=steps, seq_len=S, global_batch=B, lr=TRAIN_KW["lr"],
                         warmup=TRAIN_KW["warmup"], moments_dtype=plan["moments"])
    tr = Trainer(cfg, tcfg, str(ROOT / "build" / "chip_smoke_planned_ckpt"), device="cuda:0")
    try:
        counters = _train_counters()
        eager = _eager_reference(steps, *_trainer_steps(tr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = tr.init_state()
        init_host = [t.detach().cpu() for t in tree_leaves(state["params"].tree())]
        for fn in counters.values():
            fn.launches = 0
        step_fn = tr.step_graph(state)  # what Trainer.run steps through
        rows, steps_s = [], []
        for step in range(steps):
            batch = to_device(tr.data.batch(step), tr.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(batch, step)
            rows.append({k: float(v) for k, v in metrics.items()})  # waits for the device
            steps_s.append(time.perf_counter() - t0)
        graph = tr.graph.stats()
        ran = {name: fn.launches for name, fn in counters.items()}
        launches = _graph_launches(ran, graph)
        peaks = {"allocated": torch.cuda.max_memory_allocated(),
                 "reserved": torch.cuda.max_memory_reserved()}
        peak = peaks["allocated"]
        per_step = _launches_per_step(cfg)
        batch = to_device(tr.data.batch(steps), tr.device)
        trace = _traced(lambda: step_fn(batch, steps), top=6)
        line = _graph_line(arch, eager, rows, steps_s, state, trace, graph, per_step, peaks)
        # the graph's pool, which general allocations cannot use, goes before
        # the gates' temporaries (a deepseek-v2 expert leaf's f32 copy is 5 GB)
        del metrics, step_fn
        tr.release_graph()
        _release_device_memory()
        params, opt = state["params"], state["opt"]
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
              f"{arch}: a non-finite loss or grad norm: {rows}")
        check(all(np.isfinite(r["aux"]) and (r["aux"] > 0) == cfg.is_moe for r in rows),
              f"{arch}: aux losses {[r['aux'] for r in rows]}")
        stale = _stale_leaves(params, opt, init_host)
        check(not stale["no_grad"], f"{arch}: leaves took no gradient: {stale}")
        check(not stale["unchanged"], f"{arch}: master leaves unchanged: {stale}")
        check(not stale["off_master"], f"{arch}: leaves differ from their master: {stale}")
        dtypes = {part: sorted({str(t.dtype) for t in tree_leaves(opt[part])})
                  for part in ("m", "v", "master")}
        moments = [f"torch.{plan['moments']}"]
        check(dtypes == {"m": moments, "v": moments, "master": ["torch.float32"]},
              f"{arch}: state dtypes {dtypes}")
        for name, n in per_step.items():
            check(launches[name] == n * steps,
                  f"{arch}: {name} launched {launches[name]} times in {steps} steps, want {n} "
                  "a step")
        step_s = line["step_s"]["graph"]  # the replays' rows, as the train_graph line
        flops, _formula, _n_pos = step_model_flops(cfg, params, B, S)
        n_params = sum(p.numel() for p in params.parameters())
        res = {
            "arch": arch, "dtype": "bfloat16", "layers": depth, "reduced": reduced, "batch": B,
            "seq_len": S, "moments": plan["moments"], "params": n_params, "steps": steps,
            "loss": [r["loss"] for r in rows], "aux": [r["aux"] for r in rows],
            "grad_norm": [r["grad_norm"] for r in rows],
            "step_s": steps_s, "step_s_median_of_replays": step_s,
            "tokens_per_s": B * S / step_s, "model_flops_per_step": flops,
            "model_flop_share_of_989_tflops": flops / step_s / PEAK_BF16_FLOPS,
            "peak_mem_bytes": peak, "predicted_peak_bytes": plan["predicted_peak_bytes"],
            "peak_over_predicted": peak / plan["predicted_peak_bytes"],
            "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
            "launches_eager": ran, "graph": graph,
            "eager": {k: line[k]["eager"] for k in ("step_s", "device_busy_ms",
                                                     "device_idle_share", "host_launches",
                                                     "peak_mem_bytes")},
            "bf16_leaves_at_init": len(stale["at_init"]),
        }
        res.update({f"step_{k}": v for k, v in trace.items()})
        emit(phase, **res)
    finally:
        tr.close()
    del tr, state, params, opt, init_host
    gc.collect()
    torch.cuda.empty_cache()
    B_p, S_p, depth_p = plan["parity"]
    res["parity"] = phase_train_parity(arch, B_p, S_p, depth=depth_p)
    res["phase_s"] = time.perf_counter() - t_start
    emit(phase, arch=arch, phase_s=res["phase_s"])
    return res


def phase_dryrun(dry: DryRuns, trains: list, serves: list) -> dict:
    """The dry run's predicted peak (``launch/dryrun.py --single-device``) of
    each train cell beside the peak its train phase measured
    (``torch.cuda.max_memory_allocated``), each plan's beside its phase's
    (deepseek-v2's and the dense cells' training, deepseek-coder's serving
    at its planned prefill shape against the engine's run), and the
    fake-world cell: a comparison, not a gate."""
    lines = dry.join()
    measured = {t["arch"]: t["peak_mem_bytes"] for t in trains if "peak_mem_bytes" in t}
    served = {s["arch"]: s["peak_mem_bytes"] for s in serves if "peak_mem_bytes" in s}
    out = {"wall_s": time.perf_counter() - dry.t0, "cells": {}, "plans": {}}
    for ln in lines:
        if ln["kind"] == "train_cell":
            r = ln["result"]
            got = measured.get(ln["arch"])
            cell = {"predicted_peak_bytes": r["memory"]["peak_bytes"], "measured_peak_bytes": got,
                    "measured_over_predicted": None if got is None
                    else got / r["memory"]["peak_bytes"],
                    "flops_per_device": r["flops_per_device"],
                    "bytes_per_device": r["bytes_per_device"],
                    "dominant": r["roofline"]["dominant"], "run_s": r["run_s"]}
            out["cells"][ln["arch"]] = cell
            emit("dryrun", arch=ln["arch"], batch=r["global_batch"], seq_len=r["seq_len"], **cell)
        elif ln["kind"] in ("deepseek_plan", "train_plan", "serve_plan"):
            got = (served if ln["kind"] == "serve_plan" else measured).get(ln["arch"])
            out["plans"][ln["arch"]] = {**ln, "measured_peak_bytes": got}
            emit("dryrun", arch=ln["arch"], plan=ln, measured_peak_bytes=got,
                 measured_over_predicted=None if got is None
                 else got / ln["predicted_peak_bytes"])
        elif ln["kind"] == "mesh_cell":
            r = ln["result"]
            out["mesh_cell"] = {k: r[k] for k in ("arch", "shape", "mesh", "chips", "run_s",
                                                  "flops_per_device", "bytes_per_device",
                                                  "collectives", "memory", "roofline")}
            emit("dryrun", **out["mesh_cell"])
    check("mesh_cell" in out and len(out["cells"]) == len(TRAIN_CELLS)
          and len(out["plans"]) == 2 + len(DENSE_TRAIN),
          f"the dry run's lines: {[ln['kind'] for ln in lines]}")
    emit("dryrun", wall_s=out["wall_s"])
    return out


# the parallel phase: the one card as a (data=1, model=1) mesh over an
# NCCL world of one rank. Its sharded train step is held against the
# single-device Trainer step (f32, the PARITY_CELLS shape, 1e-5 scaled:
# bitwise is expected at world 1) and granite-moe's expert-parallel step at
# a capacity where nothing drops (E/K) against moe_dense's (PARITY_TOL); it
# trains tinyllama in bf16 at the train cell's shape through Trainer(mesh=)
# and decodes greedily through the sharded prefill and decode step, the
# bf16 steps, the prefill and the decode steps through their CUDA graphs,
# each held bit for bit against its eager body
PARALLEL_TOL = 1e-5
PARALLEL_STEPS = 4
MAX_STEP_HOST_LAUNCHES = 6  # a replayed sharded train step
PARALLEL_PROMPT, PARALLEL_NEW, PARALLEL_B = 64, 16, 4


def _parallel_parity(arch: str, S: int, tol: float, data=None, **overrides) -> dict:
    """One f32 step of ``build_train_step`` on the mesh against one
    single-device ``Trainer`` step from the same parameters and batch: the
    loss and every updated leaf, scaled (``_scaled``), and each run's
    kernel launches. ``data`` (a source with ``batch(step)``, called with
    the config) draws the batch of one sample of ``S`` text tokens (with
    frames or patches), else ``SyntheticTokens``."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys

    _release_device_memory()
    cfg = get_config(arch).replace(dtype="float32", **overrides)
    ckpt_dir = ROOT / "build" / "chip_smoke_parallel"
    tcfg = TrainerConfig(num_steps=1, seq_len=S, global_batch=1, lr=3e-4, warmup=0)
    tr = Trainer(cfg, tcfg, str(ckpt_dir), device="cuda:0")
    try:
        single = tr.model.init(tcfg.seed)
        sharded = shard_params(tr.model, single, _MESH[0])
        source = data(cfg) if data else SyntheticTokens(cfg.vocab_size, S, 1, seed=0)
        batch = to_device(source.batch(0), tr.device)
        counters = _train_counters()
        runs = {}
        for name in ("single", "mesh"):
            for fn in counters.values():
                fn.launches = 0
            if name == "single":
                m = tr.train_step({"params": single, "opt": adamw_init(tr.ocfg, single.tree())},
                                  batch, 0)
            else:
                spec = {"seq_len": S + (cfg.num_image_tokens if cfg.family == "vlm" else 0),
                        "global_batch": 1, "kind": "train"}
                step, _, _ = build_train_step(tr.model, _MESH[0], tr.ocfg, tr.lr_fn,
                                              tr.model.input_specs("train", spec))
                opt = adamw_init(tr.ocfg, sharded.tree(), ctx=make_ctx(_MESH[0]))
                m = step(sharded, opt, batch, 0)[2]
            runs[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "launches": {k: fn.launches for k, fn in counters.items()}}
        worst, worst_leaf = 0.0, None
        for (key, a), (_, b) in zip(tree_flatten_with_keys(sharded.tree()),
                                    tree_flatten_with_keys(single.tree())):
            err = _scaled(a.detach(), b.detach())
            if err >= worst:
                worst, worst_leaf = err, key
        loss_err = abs(runs["mesh"]["loss"] - runs["single"]["loss"]) / max(
            1.0, abs(runs["single"]["loss"]))
        out = {"arch": arch, "dtype": "float32", "batch": 1, "seq_len": S, **overrides,
               "runs": runs, "loss_scaled_err": loss_err, "worst_leaf_scaled_err": worst,
               "worst_leaf": worst_leaf, "bitwise": worst == 0.0 and loss_err == 0.0, "tol": tol}
    finally:
        tr.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(loss_err <= tol, f"parallel {arch}: loss {runs['mesh']['loss']} against "
                           f"{runs['single']['loss']}")
    check(worst <= tol, f"parallel {arch}: updated leaf {worst_leaf} off by {worst} scaled")
    gn_mesh, gn_single = runs["mesh"]["grad_norm"], runs["single"]["grad_norm"]
    check(abs(gn_mesh - gn_single) <= tol * max(1.0, abs(gn_single)),
          f"parallel {arch}: the clip's global norm {gn_mesh} against {gn_single}")
    check(runs["mesh"]["launches"] == runs["single"]["launches"] == _launches_per_step(cfg),
          f"parallel {arch}: launches {runs}")
    del tr, single, sharded
    return out


def _parallel_train(single_cell: dict) -> dict:
    """tinyllama in bf16 at the train cell's shape through Trainer(mesh=),
    whose steps run through the sharded step's graph (an eager warm-up,
    then the captured step replayed), held against the sharded step's
    eager body on a fresh state over the same batches first: every step's
    metrics and every state leaf bit for bit (a ``train_graph`` line, as
    the train cells': capture s, replays, launches captured by kernel, and
    graph beside eager: step s, traced busy ms, idle share, host launches
    a step, pool and peak bytes). Gated: K1 and K1-bwd launches a step
    (warm-up plus replays x captured) exactly the single-device step's, at
    most MAX_STEP_HOST_LAUNCHES host launches a replayed step, and the
    final checkpoint gathered and saved."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.runtime import Trainer, TrainerConfig

    allocated = _release_device_memory()
    arch, steps = "tinyllama-1.1b", PARALLEL_STEPS
    cfg = get_config(arch).replace(dtype="bfloat16")
    ckpt_dir = ROOT / "build" / "chip_smoke_parallel"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainerConfig(num_steps=steps, checkpoint_every=10 * steps, log_every=1, **TRAIN_KW)
    tr = Trainer(cfg, tcfg, str(ckpt_dir), mesh=_MESH[0], device="cuda:0")
    try:
        counters = _train_counters()
        eager = _eager_reference(steps, *_trainer_steps(tr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        out = tr.run(resume=False)
        graph = tr.graph.stats()
        launches = _graph_launches({name: fn.launches for name, fn in counters.items()}, graph)
        peaks = {"allocated": torch.cuda.max_memory_allocated(),
                 "reserved": torch.cuda.max_memory_reserved()}
        rows = out["metrics"]
        steps_s = [r["step_s"] for r in rows]
        check(len(rows) == steps and all(np.isfinite(r["loss"]) for r in rows),
              f"parallel train rows {rows}")
        per_step = _launches_per_step(cfg)
        for name, n in per_step.items():
            check(launches[name] == n * steps,
                  f"parallel {arch}: {name} launched {launches[name]} times in {steps} steps, "
                  f"want {n} a step")
        check(len(tr.ckpt.saves) == 1, f"parallel saves {tr.ckpt.saves}")
        save = tr.ckpt.saves[0]
        state = {"params": out["params"], "opt": out["opt"]}
        batch = to_device(tr.data.batch(steps), tr.device)
        trace = _traced(lambda: tr.graph(batch, steps), top=4)
        line = _graph_line(f"{arch} on the (1, 1) mesh", eager, rows, steps_s, state, trace,
                           graph, per_step, peaks)
        _check_step_host_launches(arch, line)
        step_s = line["step_s"]["graph"]
        res = {
            "arch": arch, "dtype": "bfloat16", "mesh": "(data=1, model=1)", "steps": steps,
            "batch": TRAIN_KW["global_batch"], "seq_len": TRAIN_KW["seq_len"],
            "loss": [r["loss"] for r in rows], "step_s": steps_s,
            "step_s_median_of_replays": step_s,
            "step_s_eager_median_after_first": line["step_s"]["eager"],
            "single_device_train_cell_step_s_median_of_replays":
                single_cell["step_s_median_of_replays"],
            "tokens_per_s": TRAIN_KW["global_batch"] * TRAIN_KW["seq_len"] / step_s,
            "peak_mem_bytes": peaks["allocated"], "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "graph": graph, "bit_for_bit": line["bit_for_bit"],
            "ckpt": {"bytes": save["bytes"], "seconds": save["seconds"],
                     "snapshot_s": save["snapshot_s"]},
            **allocated,
        }
        for name in ("graph", "eager"):
            res.update({f"step_{name}_{k}": line[k][name] for k in
                        ("traced_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                         "host_launches", "k1_device_ms", "k1_bwd_device_ms")})
    finally:
        tr.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr, out, state
    return res


def _check_step_host_launches(arch: str, line: dict) -> None:
    """A replayed sharded step issues at most MAX_STEP_HOST_LAUNCHES host
    launches: the batch's copies into the static inputs, the lr's fill and
    the graph's launch (the single-device graph reads 4 to 5)."""
    n = line["host_launches"]["graph"]
    check(n <= MAX_STEP_HOST_LAUNCHES,
          f"parallel {arch}: a replayed sharded step issues {n} host launches")


def _greedy_run(model, prefill, decode, batch: dict, S: int, new: int, feed=None) -> dict:
    """``new`` greedy tokens: ``prefill(batch)``, then ``new - 1`` steps of
    ``decode(tokens, caches, index)`` over the caches padded by ``new``
    positions, each step fed its own argmax or ``feed``'s column (teacher
    forcing). The tokens, each step's last-position logits (f32) and their
    top-2 gaps, and the kernel launches the wrappers counted."""
    import torch

    from repro_torch.models.lm import extend_caches

    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    logits, caches = prefill(batch)
    caches = extend_caches(caches, new, window=model.cfg.window)
    B = logits.shape[0]
    toks, seen, gaps = [], [], []
    for i in range(new):
        last = logits[:, -1].float()
        seen.append(last)
        top = torch.topk(last, 2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        toks.append(last.argmax(-1))
        if i + 1 < new:
            fed = toks[-1] if feed is None else feed[:, i]
            logits, caches = decode(fed[:, None], caches,
                                    torch.full((B,), S + i, device=model.device))
    return {"tokens": torch.stack(toks, 1), "logits": torch.stack(seen, 1),
            "gaps": torch.stack(gaps, 1),
            "launches": {k: fn.launches for k, fn in counters.items()}}


def _sharded_greedy(model, sharded, mesh, batch: dict, S: int, new: int, feed=None) -> dict:
    """:func:`_greedy_run` through ``build_prefill`` and
    ``build_decode_step`` on the mesh, by their eager bodies (``mesh``) and
    by their graphs (``graph``: the prefill's eager warm-up first, then its
    capture and replay; the decode step's warm-up, capture and replays),
    from the same shards: the graphs' logits and tokens gated equal to the
    bodies' bit for bit, their launches (the wrappers' counts plus replays
    x captured) equal. Returns both runs, the graph run with the graphs'
    stats."""
    import torch

    from repro_torch.parallel.steps import build_decode_step, build_prefill

    B = batch["tokens"].shape[0]
    prefill, _ = build_prefill(model, mesh, model.input_specs(
        "prefill", {"seq_len": S, "global_batch": B, "kind": "prefill"}))
    meta = torch.device("meta")
    decode, _ = build_decode_step(model, mesh, {
        "tokens": torch.empty((B, 1), device=meta), "caches": model.cache_shapes(B, S + new),
        "index": torch.empty((B,), device=meta)})

    def run(pre, dec):
        return _greedy_run(model, lambda b: pre(sharded, b),
                           lambda t, c, i: dec(sharded, t, c, i), batch, S, new, feed)

    runs = {"mesh": run(prefill.body, decode.body)}
    prefill(sharded, batch)  # the prefill graph's eager warm-up
    graph = run(prefill, decode)
    stats = {"prefill": prefill.stats(), "decode": decode.stats()}
    graph["launches"] = {k: n + sum(g["replays"] * g["captured_launches"].get(k, 0)
                                    for g in stats.values())
                         for k, n in graph["launches"].items()}
    graph["graphs"] = stats
    runs["graph"] = graph
    prefill.release()
    decode.release()
    arch = model.cfg.name
    check(stats["prefill"]["replays"] == 1 and stats["decode"]["replays"] == new - 2,
          f"parallel {arch}: the greedy graphs' stats {stats}")
    check(torch.equal(graph["logits"], runs["mesh"]["logits"])
          and torch.equal(graph["tokens"], runs["mesh"]["tokens"]),
          f"parallel {arch}: greedy logits or tokens through the graphs differ from the "
          f"eager bodies'")
    check(graph["launches"] == runs["mesh"]["launches"],
          f"parallel {arch}: greedy launches, graph {graph['launches']} against eager "
          f"{runs['mesh']['launches']}")
    return runs


def _greedy_stats(run: dict) -> dict:
    """A greedy run's graphs: replays, captured launches, capture s."""
    return {kind: {k: g[k] for k in ("eager_steps", "replays", "captured_launches",
                                     "capture_s", "pool_bytes")}
            for kind, g in run["graphs"].items()}


def _parallel_greedy() -> dict:
    """tinyllama in f32: B=4 prompts of PARALLEL_PROMPT tokens and
    PARALLEL_NEW greedy tokens through build_prefill and build_decode_step
    on the mesh, by their eager bodies and by their graphs
    (:func:`_sharded_greedy`), against Model.prefill and decode_step; the
    tokens must be equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import shard_params

    _release_device_memory()
    cfg = get_config("tinyllama-1.1b").replace(dtype="float32")
    model = build_model(cfg, device="cuda:0")
    params = model.init(0)
    mesh = _MESH[0]
    sharded = shard_params(model, params, mesh)
    B, S, new = PARALLEL_B, PARALLEL_PROMPT, PARALLEL_NEW
    batch = {"tokens": np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))}
    runs = {"single": _greedy_run(model, lambda b: model.prefill(params, b),
                                  lambda t, c, i: model.decode_step(params, t, c, i), batch,
                                  S, new)}
    runs.update(_sharded_greedy(model, sharded, mesh, batch, S, new))
    out = {name: {"tokens": r["tokens"].cpu().tolist(), "launches": r["launches"]}
           for name, r in runs.items()}
    out["graph"]["graphs"] = _greedy_stats(runs["graph"])
    check(out["mesh"]["tokens"] == out["single"]["tokens"],
          f"parallel greedy tokens differ: {out}")
    check(out["mesh"]["launches"] == out["single"]["launches"], f"parallel greedy {out}")
    del model, params, sharded, runs
    return {"batch": B, "prompt": S, "new_tokens": new, "graph_bit_for_bit_with_eager": True,
            **out}


_MESH: list = []  # the phase's mesh, for its helpers


def phase_parallel(single_cell: dict) -> dict:
    """The parallelism layer on the card: an NCCL process group of one rank
    on ``cuda:0`` and its (data=1, model=1) mesh from
    ``make_host_mesh(1, device_type="cuda")``. Four runs, each freeing its
    state before the next: tinyllama's f32 sharded train step against the
    single-device Trainer step, granite-moe's expert-parallel f32 step at
    capacity E/K against moe_dense's, tinyllama's bf16 training through
    ``Trainer(mesh=)`` at the train cell's shape, and greedy decoding
    through the sharded prefill and decode step. One ``parallel`` line."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", rank=0, world_size=1, store=dist.HashStore(),
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda:0"))
    try:
        _MESH[:] = [make_host_mesh(1, device_type="cuda")]
        granite = get_config("granite-moe-1b-a400m")
        res = {
            "world": dist.get_world_size(), "backend": dist.get_backend(),
            "mesh": dict(zip(_MESH[0].mesh_dim_names, _MESH[0].shape)),
            "tinyllama_f32": _parallel_parity("tinyllama-1.1b", 256, PARALLEL_TOL),
            "granite_moe_ep_f32": _parallel_parity(
                "granite-moe-1b-a400m", 256, PARITY_TOL,
                capacity_factor=float(granite.num_experts // granite.experts_per_token)),
            "tinyllama_bf16_trainer": _parallel_train(single_cell),
            "greedy": _parallel_greedy(),
        }
    finally:
        _MESH.clear()
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_start
    emit("parallel", **res)
    return res


# the parallel_families phase: the families beyond the dense and GQA-MoE
# decoders through the sharded steps, on an NCCL world of one rank and its
# (data=1, model=1) mesh, at full width (the configs' own d_model, heads,
# ssm_* and vocab) with the depth cut to FAMILY_CUTS. f32 gates: the
# sharded train step of the four trainable families against the
# single-device step (FAMILY_TOL scaled, their kernels' launches equal), and
# greedy tokens of all five through the sharded prefill and decode step
# against Model.prefill and decode_step (teacher-forced, so each step's
# logits compare; a token may differ only at a top-2 gap below TIE_GAP),
# the prefill and decode graphs bit for bit with their eager bodies.
# deepseek-v2 keeps its expert_mlp rule on data (its experts' hidden dim
# is gathered over a data group of one). bf16: FAMILY_STEPS sharded steps
# at the family's train cell shape through the step's graph, held bit for
# bit against as many eager steps of its body, timed and traced beside
# them, and K1, K1-bwd, K2 and K2-bwd launched a step exactly as the
# single-device step launches them.
FAMILY_CUTS = {
    "mamba2-1.3b": dict(num_layers=2),
    "hymba-1.5b": dict(num_layers=3, global_layers=(0,)),
    "whisper-medium": dict(num_layers=2, encoder_layers=2),
    "paligemma-3b": dict(num_layers=2),
    "deepseek-v2-236b": dict(num_layers=2),  # its dense layer 0 and MoE layer 1
}
FAMILY_TRAIN = ("mamba2-1.3b", "hymba-1.5b", "whisper-medium", "paligemma-3b")
# the f32 step's text tokens (B=1): mamba2 over 4 chunks of its scan, the
# enc-dec and VLM cells' own (with 1500 frames, 256 patches)
FAMILY_F32_S = {"mamba2-1.3b": 1024, "hymba-1.5b": 256, "whisper-medium": 448,
                "paligemma-3b": 256}
FAMILY_TOL = 1e-4
FAMILY_B, FAMILY_PROMPT, FAMILY_NEW = 4, 64, 8
FAMILY_STEPS = 4


def _family_source(cfg, S: int, B: int):
    """A family's batches: tokens with frames or patches where it takes
    them (:class:`EncDecVLMTokens`), else :class:`SyntheticTokens`."""
    from repro_torch.data import SyntheticTokens

    if cfg.is_encdec or cfg.family == "vlm":
        return EncDecVLMTokens(cfg, S, B)
    return SyntheticTokens(cfg.vocab_size, S, B, seed=0)


def _family_greedy(arch: str, mesh) -> dict:
    """f32 greedy decoding through ``build_prefill`` and
    ``build_decode_step`` on the mesh, by their eager bodies and by their
    graphs (:func:`_sharded_greedy`: the graphs bit for bit with the
    bodies), against ``Model.prefill`` and ``decode_step`` from the same
    weights: the single-device run's own argmax, then the sharded runs fed
    those tokens; each step's logits scaled and the tokens, a mismatch
    allowed only at a near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import shard_params

    allocated = _release_device_memory()
    cfg = get_config(arch).replace(dtype="float32", **FAMILY_CUTS[arch])
    model = build_model(cfg, device="cuda:0")
    params = model.init(0)
    B, new = FAMILY_B, FAMILY_NEW
    batch = to_device(_family_source(cfg, FAMILY_PROMPT, B).batch(0), model.device)
    batch.pop("targets")
    S = FAMILY_PROMPT + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    single = _greedy_run(model, lambda b: model.prefill(params, b),
                         lambda t, c, i: model.decode_step(params, t, c, i), batch, S, new)
    sharded = shard_params(model, params, mesh)
    del params  # one copy of the weights at a time (deepseek-v2's are 21 GB)
    runs = _sharded_greedy(model, sharded, mesh, batch, S, new, feed=single["tokens"])
    mesh_run = runs["mesh"]
    err = _scaled(mesh_run["logits"], single["logits"])
    differ = (mesh_run["tokens"] != single["tokens"]).nonzero().tolist()
    near = [single["gaps"][b, i].item() for b, i in differ]
    launches = {"single": single["launches"], "mesh": mesh_run["launches"],
                "graph": runs["graph"]["launches"]}
    out = {"arch": arch, "dtype": "float32", **_family_cut(arch), "batch": B,
           "prompt": FAMILY_PROMPT, "positions": S, "new_tokens": new,
           "logits_scaled_err": err, "token_mismatches": len(differ),
           "mismatch_top2_gaps": near, "tokens": single["tokens"].cpu().tolist(),
           "launches": launches, "graph_bit_for_bit_with_eager": True,
           "graphs": _greedy_stats(runs["graph"]), **allocated}
    check(err <= FAMILY_TOL, f"parallel {arch}: greedy logits off by {err} scaled")
    check(all(g < TIE_GAP for g in near), f"parallel {arch}: tokens differ at gaps {near}")
    check(mesh_run["launches"] == single["launches"],
          f"parallel {arch}: greedy launches {launches}")
    del model, sharded, runs, single
    return out


def _family_cut(arch: str) -> dict:
    """The cut of a family's depth, for its lines."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    return {"reduced": {k: {"full": getattr(full, k), "run": v} for k, v in
                        FAMILY_CUTS[arch].items()},
            "reduced_why": "depth cut to fit the phase's time; widths are the config's own"}


def _family_bf16(arch: str, mesh, single_cell: dict) -> dict:
    """bf16 sharded steps at the family's train cell shape (B=4, S=2048 or
    its enc-dec/VLM text) through ``build_train_step``'s graph (an eager
    warm-up, then the captured step replayed), held against its eager body
    (``step.body``) on a fresh state over the same batches first: every
    step's metrics and every state leaf bit for bit (a ``train_graph``
    line: capture s, replays, launches captured by kernel, and graph beside
    eager: step s, the device drained at both ends, traced busy ms, idle
    share, host launches a step, pool and peak bytes). Gated: its kernel
    launches (warm-up plus replays x captured) the single-device step's,
    at most MAX_STEP_HOST_LAUNCHES host launches a replayed step. With the
    family's full-depth single-device train cell from this run, as the
    phase received it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import to_device
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params

    allocated = _release_device_memory()
    cfg = get_config(arch).replace(dtype="bfloat16", **FAMILY_CUTS[arch])
    model = build_model(cfg, device="cuda:0")
    B, S = TRAIN_KW["global_batch"], TRAIN_TEXT.get(arch, TRAIN_KW["seq_len"])
    positions = S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    ocfg = AdamWConfig(lr=TRAIN_KW["lr"])
    lr_fn = cosine_schedule(TRAIN_KW["lr"], TRAIN_KW["warmup"], FAMILY_STEPS + 2)
    step, _, _ = build_train_step(model, mesh, ocfg, lr_fn, model.input_specs(
        "train", {"seq_len": positions, "global_batch": B, "kind": "train"}))
    source = _family_source(cfg, S, B)

    def init():
        params = shard_params(model, model.init(0), mesh)
        return {"params": params, "opt": adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))}

    def eager_step(state, batch, i):
        lr = torch.full((), float(lr_fn(i)), dtype=torch.float32, device=model.device)
        return step.body(state["params"], state["opt"], batch, lr)[2]

    def batch_of(i):
        return to_device(source.batch(i), model.device)

    eager = _eager_reference(FAMILY_STEPS, init, eager_step, batch_of)
    state = init()
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, steps_s = [], []
    for i in range(FAMILY_STEPS):
        batch = batch_of(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state["params"], state["opt"], batch, i)[2]
        rows.append({k: float(v) for k, v in m.items()})  # waits for the device
        steps_s.append(time.perf_counter() - t0)
    graph = step.stats()
    launches = _graph_launches({name: fn.launches for name, fn in counters.items()}, graph)
    peaks = {"allocated": torch.cuda.max_memory_allocated(),
             "reserved": torch.cuda.max_memory_reserved()}
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite(x) for x in losses), f"parallel {arch} bf16 losses {losses}")
    per_step = _launches_per_step(cfg)
    for name, n in per_step.items():
        check(launches[name] == n * FAMILY_STEPS,
              f"parallel {arch}: {name} launched {launches[name]} times in {FAMILY_STEPS} "
              f"steps, want {n} a step")
    batch = batch_of(FAMILY_STEPS)
    trace = _traced(lambda: step(state["params"], state["opt"], batch, FAMILY_STEPS), top=4)
    line = _graph_line(f"{arch} on the (1, 1) mesh", eager, rows, steps_s, state, trace, graph,
                       per_step, peaks)
    _check_step_host_launches(arch, line)
    step_s = line["step_s"]["graph"]
    res = {"arch": arch, "dtype": "bfloat16", "mesh": "(data=1, model=1)", **_family_cut(arch),
           "steps": FAMILY_STEPS, "batch": B, "seq_len": S, "decoder_positions": positions,
           "encoder_frames": cfg.encoder_seq if cfg.is_encdec else 0, "loss": losses,
           "step_s": steps_s, "step_s_median_of_replays": step_s,
           "step_s_eager_median_after_first": line["step_s"]["eager"],
           "tokens_per_s": B * S / step_s, "peak_mem_bytes": peaks["allocated"],
           "launches": launches,
           "launches_per_step": {k: v / FAMILY_STEPS for k, v in launches.items()},
           "graph": graph, "bit_for_bit": line["bit_for_bit"],
           # the family's single-device train cell of this run, at its depth
           "single_device_train_cell": {
               k: single_cell[k] for k in ("step_s_median_of_replays", "step_device_busy_ms",
                                           "step_device_idle_share", "step_host_launches",
                                           "launches_per_step")},
           "single_device_train_cell_num_layers": _train_cfg(arch).num_layers,
           **allocated}
    for name in ("graph", "eager"):
        res.update({f"step_{name}_{k}": line[k][name] for k in
                    ("traced_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                     "host_launches", "k1_device_ms", "k1_bwd_device_ms", "k2_device_ms",
                     "k2_bwd_device_ms")})
    step.release()
    del model, state, step
    return res


def phase_parallel_families(single_cells: dict) -> dict:
    """Every family beyond the dense and GQA-MoE decoders under a mesh on
    the card: an NCCL group of one rank on ``cuda:0`` and its (data=1,
    model=1) mesh. For each of :data:`FAMILY_CUTS`' families at full width:
    the f32 sharded train step against the single-device step (the four
    trainable families: deepseek-v2's attention has no K1-bwd at
    Dqk=192/Dv=128 yet, so its training raises on the card), f32 greedy
    tokens through the sharded prefill and decode step (eager and by their
    graphs), and the bf16 sharded step's graph held against its eager body,
    timed and traced beside it.
    ``single_cells`` are this run's train cells by arch. One
    ``parallel_families`` line."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", rank=0, world_size=1, store=dist.HashStore(),
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda:0"))
    res: dict = {"world": 1, "backend": "nccl", "mesh": {"data": 1, "model": 1}}
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        _MESH[:] = [mesh]
        for arch in FAMILY_TRAIN:
            res[f"{arch}_f32_step"] = _parallel_parity(
                arch, FAMILY_F32_S[arch], FAMILY_TOL,
                data=lambda cfg, S=FAMILY_F32_S[arch]: _family_source(cfg, S, 1),
                **FAMILY_CUTS[arch])
        for arch in FAMILY_CUTS:
            res[f"{arch}_f32_greedy"] = _family_greedy(arch, mesh)
        for arch in FAMILY_TRAIN:
            res[f"{arch}_bf16"] = _family_bf16(arch, mesh, single_cells[arch])
    finally:
        _MESH.clear()
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_start
    emit("parallel_families", **res)
    return res


# the pipeline phase: tinyllama's decoder layers, cut to PIPE_LAYERS of 22
# (to keep the script inside its time limit since the train_lm phase came),
# as the stage function of repro_torch.parallel.pipeline on a ("pod",) mesh
# of one rank over NCCL.
# The embedding runs on the inputs before stage 0 and Model.head_loss (the
# final norm, the head and the CE) is loss_fn. In f32 (B=1, S=256, M=4) the
# pipelined loss and every gradient are held to the serial loss over the
# same microbatches (PIPE_TOL scaled); in bf16 at the train cell's width
# (M=4 microbatches of B=1 at S=2048, remat on) K1 must launch exactly
# 2 x PIPE_LAYERS x M times a step and K1-bwd PIPE_LAYERS x M, the step's
# loss and every gradient must equal the serial step's bit for bit (one
# rank: the same kernels on the same inputs in the same order), and the
# step is timed and traced beside the serial step of the same microbatches
PIPE_ARCH = "tinyllama-1.1b"
PIPE_LAYERS = 11
PIPE_M = 4
PIPE_F32 = (1, 256)  # microbatch size and sequence, f32
PIPE_BF16 = (1, 2048)
PIPE_TOL = 1e-5
PIPE_REPS = 3


def _pipeline_losses(model, tree, mesh, M: int):
    """The pipelined loss and the serial one, each ``f(tokens, targets)``
    over ``M`` microbatches of the rows of ``tokens``: the embedding, the
    decoder layers as one stage (under ``torch.utils.checkpoint``) and
    ``Model.head_loss`` per microbatch, the mean over the microbatches.
    Returns (pipelined, serial, tick table)."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.blocks import block_apply
    from repro_torch.parallel.pipeline import build_pipelined_loss

    cfg = model.cfg
    check(len(model.plan) == 1 and model.plan[0].kind == "scan" and cfg.window is None,
          f"{cfg.name}: the pipeline phase takes one stack of full-attention layers")
    layers = tree["layers"][model.plan[0].name]

    def stage_fn(lps, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in lps:
            x = block_apply(cfg, lp, x, positions)[0]
        return x

    def loss_fn(x, y):
        return model.head_loss(tree, x, y)[0]

    def microbatches(tokens, targets):
        x = model._embed_tokens(tree, model._as_index(tokens))
        B, S = x.shape[:2]
        return (x.reshape(M, B // M, S, -1),
                model._as_index(targets).reshape(M, B // M, S))

    pipe, table = build_pipelined_loss(stage_fn, loss_fn, mesh, num_microbatches=M,
                                       remat=True)

    def pipelined(tokens, targets):
        return pipe(layers, *microbatches(tokens, targets))

    def serial(tokens, targets):
        x_mb, y_mb = microbatches(tokens, targets)
        total = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        for m in range(M):
            out = checkpoint(stage_fn, layers, x_mb[m], use_reentrant=False)
            total = total + loss_fn(out, y_mb[m]).float()
        return total / M

    return pipelined, serial, table


def _pipeline_tokens(cfg, B: int, S: int, seed: int) -> tuple:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1))
    return toks[:, :-1], toks[:, 1:]


def _pipeline_f32(mesh, device) -> dict:
    """The pipelined f32 loss and every gradient against the serial ones."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_flatten_with_keys

    _release_device_memory()
    cfg = get_config(PIPE_ARCH).replace(dtype="float32", num_layers=PIPE_LAYERS)
    model = build_model(cfg, device=device)
    tree = model.init(0).tree()
    keys, leaves = zip(*tree_flatten_with_keys(tree))
    mb, S = PIPE_F32
    tokens, targets = _pipeline_tokens(cfg, mb * PIPE_M, S, seed=11)
    pipelined, serial, table = _pipeline_losses(model, tree, mesh, PIPE_M)
    runs = {}
    for name, fn in (("pipelined", pipelined), ("serial", serial)):
        loss = fn(tokens, targets)
        runs[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
    loss_err = _scaled(runs["pipelined"][0], runs["serial"][0])
    worst, worst_leaf = 0.0, None
    for key, a, b in zip(keys, runs["pipelined"][1], runs["serial"][1]):
        err = _scaled(a, b)
        if err >= worst:
            worst, worst_leaf = err, key
    out = {"arch": PIPE_ARCH, "num_layers": cfg.num_layers, "dtype": "float32",
           "microbatches": PIPE_M, "microbatch": mb,
           "seq_len": S, "table": table.tolist(),
           "loss": float(runs["pipelined"][0]), "serial_loss": float(runs["serial"][0]),
           "loss_scaled_err": loss_err, "worst_leaf_scaled_err": worst,
           "worst_leaf": worst_leaf, "leaves": len(keys),
           "bitwise": loss_err == 0.0 and worst == 0.0, "tol": PIPE_TOL}
    check(loss_err <= PIPE_TOL, f"pipeline f32 loss {out['loss']} against {out['serial_loss']}")
    check(worst <= PIPE_TOL, f"pipeline f32 gradient {worst_leaf} off by {worst} scaled")
    del model, tree, leaves, runs
    return out


def _pipeline_bf16(mesh, device) -> dict:
    """The bf16 step (loss and every gradient) at the train cell's width:
    K1 and K1-bwd launches gated, the first timed step's loss and gradients
    equal bit for bit to the serial step's, step times beside the serial
    step's, and one traced step of each (the host launches the pipeline
    adds)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_flatten_with_keys

    allocated = _release_device_memory()
    cfg = get_config(PIPE_ARCH).replace(dtype="bfloat16", num_layers=PIPE_LAYERS)
    model = build_model(cfg, device=device)
    tree = model.init(0).tree()
    keys, leaves = zip(*tree_flatten_with_keys(tree))
    mb, S = PIPE_BF16
    tokens, targets = _pipeline_tokens(cfg, mb * PIPE_M, S, seed=12)
    pipelined, serial, _ = _pipeline_losses(model, tree, mesh, PIPE_M)
    counters = _train_counters()

    def step(fn):
        loss = fn(tokens, targets)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step(fn)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss, grads

    for fn in (pipelined, serial):  # warm: the kernels' first launches
        step(fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    times = {"pipelined": [], "serial": []}
    losses = {}
    first = {}  # the first timed step's loss and gradients
    for rep in range(PIPE_REPS):
        for name, fn in (("pipelined", pipelined), ("serial", serial)):
            if rep == 0:
                for c in counters.values():
                    c.launches = 0
            dt, loss, grads = timed(fn)
            times[name].append(dt)
            losses[name] = float(loss)
            if rep == 0:
                launches[name] = {k: c.launches for k, c in counters.items()}
                first[name] = (loss, grads)
            del grads
    peak = torch.cuda.max_memory_allocated()
    (p_loss, p_grads), (s_loss, s_grads) = first["pipelined"], first["serial"]
    differ = [k for k, a, b in zip(keys, p_grads, s_grads) if not torch.equal(a, b)]
    worst = max(((_scaled(a, b), k) for k, a, b in zip(keys, p_grads, s_grads)
                 if k in differ), default=(0.0, None))
    del first, p_grads, s_grads
    want = {"flash_attention": 2 * cfg.num_layers * PIPE_M,
            "flash_attention_bwd": cfg.num_layers * PIPE_M}
    for name in ("pipelined", "serial"):
        for k, n in want.items():
            check(launches[name][k] == n,
                  f"pipeline bf16 {name}: {k} launched {launches[name][k]} times, want {n}")
    check(all(np.isfinite(v) for v in losses.values()), f"pipeline bf16 losses {losses}")
    check(torch.equal(p_loss, s_loss),
          f"pipeline bf16 loss {float(p_loss)} against the serial {float(s_loss)}")
    check(not differ, f"pipeline bf16: {len(differ)} of {len(keys)} gradients differ from the "
          f"serial step's, the worst {worst[1]} by {worst[0]} scaled")
    traced = {name: _traced(lambda fn=fn: step(fn), top=4)
              for name, fn in (("pipelined", pipelined), ("serial", serial))}
    res = {
        "arch": PIPE_ARCH, "num_layers": cfg.num_layers, "dtype": "bfloat16",
        "microbatches": PIPE_M, "microbatch": mb,
        "seq_len": S, "remat": True, "loss": losses["pipelined"],
        "serial_loss": losses["serial"], "bitwise": True, "leaves": len(keys),
        "launches": launches["pipelined"],
        "serial_launches": launches["serial"], "want_launches": want,
        "step_s": times["pipelined"], "serial_step_s": times["serial"],
        "step_s_median": float(np.median(times["pipelined"])),
        "serial_step_s_median": float(np.median(times["serial"])),
        "tokens_per_s": mb * PIPE_M * S / float(np.median(times["pipelined"])),
        "peak_mem_bytes": peak,
        # both steps traced on the same inputs in this call
        "host_launches_added": (traced["pipelined"]["host_launches"]
                                - traced["serial"]["host_launches"]),
        "traced_ms_added": traced["pipelined"]["traced_ms"] - traced["serial"]["traced_ms"],
        **allocated,
    }
    for name in ("pipelined", "serial"):
        res.update({f"step_{name}_{k}": traced[name][k] for k in
                    ("traced_ms", "device_busy_ms", "device_idle_share", "kernel_launches",
                     "host_launches", "k1_device_ms", "k1_bwd_device_ms")})
    del model, tree, leaves
    return res


def phase_pipeline() -> dict:
    """The pipeline on the card: an NCCL process group of one rank on
    ``cuda:0`` and its ("pod",) mesh of one (the exchange is skipped at
    world 1, as the parallel layer's collectives are); the f32 parity run,
    then the bf16 run at the train cell's width. One ``pipeline`` line."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    dist.init_process_group("nccl", rank=0, world_size=1, store=dist.HashStore(),
                            timeout=datetime.timedelta(seconds=300), device_id=device)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        res = {"world": dist.get_world_size(), "backend": dist.get_backend(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "f32": _pipeline_f32(mesh, device),
               "bf16": _pipeline_bf16(mesh, device)}
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_start
    emit("pipeline", **res)
    return res


# the pool phase: the paper's executor on the chip machine's host, after the
# card is in use (the process and socket backends fork from a process that
# holds a CUDA context, so their workers must not touch the card)
POOL_BACKENDS = ("serial", "thread", "process", "socket")
POOL_CHAOS = dict(fail_rate=0.25, delay_rate=0.1, kill_rate=0.08, delay_s=0.001)


def _pool_graph(core):
    """A condition loop (its state in the condition body), a subflow
    gathered into a dataflow value and dataflow edges joining them, with
    numpy work on the edges. Returns (graph, result tasks, loop state)."""
    g = core.TaskGraph("smoke")
    state = {"i": 0}
    src = g.add(lambda: np.arange(4096, dtype=np.float64), name="src")
    sq = g.then(src, lambda a: a * a, name="sq")

    def spawn(rt):
        return rt.gather([rt.add(lambda k=k: float(np.sin(np.arange(1000) * k).sum()),
                                 name=f"p{k}") for k in range(6)])

    sub = g.add(spawn, takes_runtime=True, name="sub")
    sub.after(src)
    total = g.then(g.gather([sq, sub], name="both"),
                   lambda both: float(both[0].sum()) + float(np.sum(both[1])), name="total")
    body = g.add(lambda: None, name="body")
    body.after(src)

    def more():
        state["i"] += 1
        return 0 if state["i"] < 5 else 1

    cond = g.add(more, kind="condition", name="more")
    cond.after(body)
    cond.precede(body)
    return g, (sq, sub, total), state


def _chaos_graph(core, died):
    g = core.TaskGraph("chaos")
    tasks = [g.add(lambda i=i: i + 1, name=f"c:{i}",
                   retry=core.RetryPolicy(max_attempts=10, backoff=0,
                                          retry_on=(core.ChaosError, died)))
             for i in range(30)]
    return g, g.gather(tasks, name="collect")


class _PoolTokens:
    """The prefetcher's source: seeded token batches."""

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(step)
        return {"tokens": rng.integers(0, 32000, (4, 2048)), "step": np.asarray(step)}


def _pool_transform(batch: dict) -> dict:
    """A numpy-level transform (module level, so it ships by reference)."""
    t = batch["tokens"]
    return {"tokens": (t * 7 + 3) % 32000, "mask": (t % 5 != 0).astype(np.float32),
            "step": batch["step"]}


def phase_pool() -> dict:
    """The executor's four backends on the host, after the card is in use:
    one graph with equal results on each, a seeded fault injector with the
    same schedule on each, the strict verifier passing a clean graph and
    refusing a planted race, a task body that touches CUDA in a worker
    failing with torch's own error (no fallback), and the process
    prefetcher's batches on ``cuda:0`` equal bit for bit to the thread
    prefetcher's. One ``pool`` line."""
    import torch

    import repro_torch.core as core
    from repro_torch.analysis.verify import GraphVerificationError
    from repro_torch.data import Prefetcher, to_device
    from repro_torch.dist import WorkerDiedError

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    check(torch.cuda.is_initialized(), "the card is not in use yet")
    res: dict = {"backends": list(POOL_BACKENDS)}
    results, schedules, seconds = {}, {}, {}
    for backend in POOL_BACKENDS:
        t0 = time.perf_counter()
        n = 2 if backend in ("process", "socket") else 4
        with core.Executor(n, backend=backend) as ex:
            g, outs, state = _pool_graph(core)
            values = []
            for _ in range(2):  # the second pass replays the settled graph
                state["i"] = 0
                ex.run(g).result(120)
                values.append((float(outs[0].result.sum()), sorted(outs[1].result),
                               outs[2].result, state["i"]))
            results[backend] = values
            inj = core.FaultInjector(seed=123, match=lambda t: (t.name or "").startswith("c:"),
                                     **POOL_CHAOS)
            cg, sink = _chaos_graph(core, WorkerDiedError)
            with inj.on(ex.pool):
                ex.run(cg).result(120)
            schedules[backend] = (inj.schedule(), list(sink.result))
            if backend == "process":
                # a worker forked from this process cannot use CUDA: torch's
                # error reaches the caller, and nothing falls back
                task = core.Task(lambda: torch.cuda.current_device(), affinity="remote",
                                 name="cuda-in-worker")
                task.propagate_errors = False
                fut = ex.run(task)
                try:
                    fut.result(120)
                    res["cuda_in_worker"] = "no error"
                except Exception as exc:  # noqa: BLE001 - the error is the result
                    res["cuda_in_worker"] = f"{type(exc).__name__}: {exc}"[:200]
        seconds[backend] = time.perf_counter() - t0
    first = results["serial"]
    check(all(v == first for v in results.values()), f"pool results differ: {results}")
    check(first[0][3] == 5 and first[0] == first[1], f"pool loop or replay: {first}")
    sched = schedules["serial"]
    check(all(v == sched for v in schedules.values()), "the seeded fault schedules differ")
    check(sched[1] == [i + 1 for i in range(30)], f"chaos values {sched[1]}")
    kinds = [k for _n, _o, k in sched[0]]
    check("cuda_in_worker" in res and "no error" not in res["cuda_in_worker"],
          f"a CUDA call in a worker: {res.get('cuda_in_worker')}")
    # the verifier: a clean graph passes strict, a planted race is refused
    with core.Executor(2, backend="thread", verify="strict") as ex:
        g, outs, state = _pool_graph(core)
        ex.run(g).result(120)
        racy = core.TaskGraph("racy")
        total = 0

        def wa():
            nonlocal total
            total += 1

        def wb():
            nonlocal total
            total += 2

        racy.add(wa, name="wa")  # two unordered writers of one closure cell
        racy.add(wb, name="wb")
        try:
            ex.run(racy).result(120)
            refused = None
        except GraphVerificationError as exc:
            refused = str(exc)[:300]
    check(refused is not None, "verify='strict' ran a graph with a write race")
    # the prefetchers: the process backend transforms in a worker, the
    # consumer puts each batch on the card; the thread backend puts it there
    # in its transform
    steps = 6
    src = _PoolTokens()
    got = {}
    with Prefetcher(src, depth=2, backend="thread",
                    put_fn=lambda b: to_device(_pool_transform(b), device)) as pf:
        got["thread"] = [pf.get(120) for _ in range(steps)]
    with Prefetcher(src, depth=2, backend="process", put_fn=_pool_transform) as pf:
        got["process"] = [to_device(pf.get(120), device) for _ in range(steps)]
    same = all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(got["thread"], got["process"]))
    on_device = all(t.device == device for b in got["process"] for t in b.values())
    check(same and on_device, "the process prefetcher's batches differ from the thread one's")
    res.update({
        "results_equal": True, "graph_result": first[0][:1] + first[0][2:],
        "chaos_schedule_equal": True, "chaos_events": len(sched[0]),
        "chaos_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
        "verify_strict_refused": refused, "prefetch_steps": steps,
        "prefetch_bitwise_equal": same, "prefetch_device": str(device),
        "backend_s": seconds, "phase_s": time.perf_counter() - t_start,
    })
    emit("pool", **res)
    return res


def _kernel_line(kern: dict, serves: list, trains: list) -> dict:
    """The kernels JSON line: launches summed over the measured runs of the
    paths (listed per path: each train run and each served model), the rest
    from the kernels phases; ``design`` names the bf16 kernel's instruction
    path."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIM_PAIRS
    from repro_torch.kernels.flash_attention import design as fa_design
    from repro_torch.kernels.flash_attention import bwd_head_split, design_bwd
    from repro_torch.kernels.ssd import DESIGN_BWD as SSD_DESIGN_BWD
    from repro_torch.kernels.ssd import DESIGNS as SSD_DESIGNS

    def launches(name):
        by_path = {f"train {t['arch']}": t["launches"][name] for t in trains}
        by_path.update({s["arch"]: s["launches"][name] for s in serves if name in s["launches"]})
        return sum(by_path.values()), by_path

    fa, t_fa = kern["flash_attention"], kern["flash_attention"]["timings"]["tinyllama S=512"]
    t_mla = fa["timings"]["deepseek MLA S=512"]
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
                   "library_device_ms", "library_note")
    ssd, t_ssd = kern["ssd"], kern["ssd"]["timings"]["mamba2 S=512"]
    fa_n, fa_by = launches("flash_attention")
    ssd_n, ssd_by = launches("ssd")
    bwd, t_bwd = kern["flash_attention_bwd"], kern["flash_attention_bwd"]["timing"]
    bwd_n, bwd_by = launches("flash_attention_bwd")
    sbwd, t_sbwd = kern["ssd_bwd"], kern["ssd_bwd"]["timings"]["mamba2 train"]
    sbwd_n, sbwd_by = launches("ssd_bwd")
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
                # deepseek-v2's expanded MLA prefill, its own instantiation
                "dqk_192_dv_128": {
                    "at": "B={B} H={H} KV={KV} Dqk={Dh} Dv={Dv} Sq=Sk={S} bf16 causal".format(
                        **MLA_K1),
                    "design": fa_design(torch.bfloat16, 192, 128),
                    "max_abs_err": fa["mla_max_abs_err"],
                    "ptxas": {k: v for k, v in ptxas_resources(
                        build.build_log["flash_attention"]["ptxas"]).items()
                        if re.search(r"<192,128(?:,|>)", k)},
                    **{k: t_mla[k] for k in timing_keys},
                    # deepseek-v2's training attention
                    "train": {"at": WIDE_TRAIN_K1[0][0] + " B=1 H=KV=128 bf16 causal",
                              **fa["train"][WIDE_TRAIN_K1[0][0]]},
                },
                # paligemma's prefill (its own instantiation, the prefix-LM
                # span) and whisper's two non-causal forms at Dh=64
                "dqk_256_dv_256": {
                    "at": "B=4 H=8 KV=1 Dqk=Dv=256 Sq=Sk=320 prefix 256 bf16",
                    "design": fa_design(torch.bfloat16, 256, 256),
                    "max_abs_err": fa["dh256_max_abs_err"],
                    "ptxas": {k: v for k, v in ptxas_resources(
                        build.build_log["flash_attention"]["ptxas"]).items()
                        if re.search(r"<256,256(?:,|>)", k)},
                    **{k: fa["timings"][ENCDEC_VLM_K1[0][0]][k] for k in timing_keys},
                    # paligemma's training attention
                    "train": {"at": WIDE_TRAIN_K1[1][0] + " B=4 H=8 KV=1 bf16",
                              **fa["train"][WIDE_TRAIN_K1[1][0]]},
                },
                # the head-dim-128 dense configs' training and prefill
                # attention (phi4-mini, qwen1.5, deepseek-coder; padded KV heads)
                "dqk_128_dv_128": {
                    "design": fa_design(torch.bfloat16, 128),
                    "max_abs_err": max(r["max_abs_err"] for r in fa["dh128"].values()),
                    "ptxas": _dh128_resources(build)["flash_attention"],
                    "shapes": {label: {"at": f"B={B} H={H} KV={KV} Dh=128 Sq=Sk={S} bf16 causal",
                                       **{k: fa["dh128"][label][k]
                                          for k in timing_keys + ("bitwise_repeat",)}}
                               for label, B, H, KV, S in K1_128},
                },
                "whisper": {
                    label: {"at": f"B={B} H={H} KV={KV} Dh={Dh} Sq={Sq} Sk={Sk} bf16 "
                                  + ("causal" if causal else "non-causal"),
                            **{k: fa["timings"][label][k] for k in timing_keys}}
                    for label, B, H, KV, Sq, Sk, Dh, causal, _prefix in ENCDEC_VLM_K1[1:]
                },
                # the training tutorial's attention, the f32 FMA design
                "train_lm_f32": {
                    "at": TRAIN_LM_AT + " (examples/train_lm_torch.py), with the lse; bound "
                                        "at the f32 peak outside the tensor cores, 67 TFLOP/s",
                    **{k: fa["train_lm"][k] for k in ("design", "max_abs_err", "lse_scaled_err")
                       + timing_keys},
                },
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
                "launch_unit": "one set of kernels (preprocess, dK/dV, dQ, and at the wide "
                               "pairs with a head split the dK/dV partials' reduce)",
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
                "design": design_bwd(torch.bfloat16, 64),
                "design_by_dtype_head_dim": {
                    str(dt).split(".")[-1]: {f"{dqk}/{dv}": design_bwd(dt, dqk, dv)
                                             for dqk, dv in BWD_HEAD_DIM_PAIRS}
                    for dt in (torch.bfloat16, torch.float32)},
                "ptxas": {k: v for k, v in ptxas_resources(
                    build.build_log["flash_attention_bwd"]["ptxas"]).items()
                    if not k.startswith("bwd_preprocess")},
                "train_shape_ulp_err": bwd["train_shape"]["ulp_err"],
                "train_shape_control_ulp_err": bwd["train_shape"]["control_ulp_err"],
                "train_shape_library_ulp_err": bwd["train_shape"]["library_ulp_err"],
                "at": "B=4 H=32 KV=4 Dh=64 Sq=Sk=2048 bf16 causal; library: the autograd "
                      "backward of F.scaled_dot_product_attention",
                "dh256_max_scaled_err": bwd["dh256_max_scaled_err"],
                # deepseek-v2's training attention, its own instantiation
                "dqk_192_dv_128": {
                    "at": bwd["deepseek"]["at"] + " bf16; library: SDPA's autograd backward",
                    "design": design_bwd(torch.bfloat16, 192, 128),
                    "max_scaled_err": bwd["mla_max_scaled_err"],
                    "bitwise_repeat": {dt: bwd["deepseek"][dt]["bitwise_repeat"]
                                       for dt in ("bfloat16", "float32")},
                    "ptxas": {k: v for k, v in ptxas_resources(
                        build.build_log["flash_attention_bwd"]["ptxas"]).items()
                        if re.search(r"<(?:\w+,)?(?:192,)?128(?:,|>)", k) and
                        ("192" in k or k.startswith("bwd_preprocess"))},
                    **{k: bwd["deepseek"]["bfloat16"][k]
                       for k in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                 "kernel_profiled_by_launch", "library_ms",
                                 "library_device_ms", "library_note", "bound_ms", "bound_by",
                                 "ulp_err", "control_ulp_err")},
                },
                # paligemma's training attention, its own instantiation,
                # the q-heads split over CTAs
                "dqk_256_dv_256": {
                    "at": "B=4 H=8 KV=1 Dqk=Dv=256 Sq=Sk=512 prefix 256 bf16",
                    "design": design_bwd(torch.bfloat16, 256, 256),
                    "head_split": bwd_head_split(
                        4, 1, 8, 8, torch.cuda.get_device_properties(0).multi_processor_count),
                    "ptxas": {k: v for k, v in ptxas_resources(
                        build.build_log["flash_attention_bwd"]["ptxas"]).items()
                        if re.search(r"<(?:\w+,)?256(?:,|>)", k)},
                    **{k: bwd["train_shapes"][ENCDEC_VLM_BWD[0][0]][k]
                       for k in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                 "kernel_profiled_by_launch", "library_ms",
                                 "library_device_ms", "library_note", "bound_ms", "bound_by",
                                 "ulp_err", "control_ulp_err")},
                },
                # the head-dim-128 dense configs' training attention
                "dqk_128_dv_128": {
                    "design": design_bwd(torch.bfloat16, 128),
                    "ptxas": _dh128_resources(build)["flash_attention_bwd"],
                    "shapes": {label: {
                        "at": f"B={B} H={H} KV={KV} Dh=128 Sq=Sk={S} bf16 causal; library: "
                              "SDPA's autograd backward",
                        "head_split": bwd_head_split(
                            B, KV, -(-S // 64), H // KV,
                            torch.cuda.get_device_properties(0).multi_processor_count),
                        **{k: bwd["dh128"][label][k]
                           for k in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                     "kernel_profiled_by_launch", "library_ms",
                                     "library_device_ms", "library_note", "bound_ms",
                                     "bound_by", "ulp_err", "control_ulp_err", "scaled_err",
                                     "bitwise_repeat")}}
                        for label, B, H, KV, S in K1_BWD_128},
                },
                # the training tutorial's attention, the f32 FMA design
                "train_lm_f32": {
                    "at": TRAIN_LM_AT + " (examples/train_lm_torch.py); bound at the f32 peak "
                                        "outside the tensor cores, 67 TFLOP/s; library: SDPA's "
                                        "autograd backward in f32",
                    **{k: bwd["train_lm"][k] for k in (
                        "design", "scaled_err", "max_abs_err", "ms", "plain_ms", "device_ms",
                        "kernel_profiled_ms", "kernel_profiled_by_launch", "library_ms",
                        "library_device_ms", "library_note", "bound_ms", "bound_by")},
                },
                # hymba's two masks and the enc-dec and VLM cells' shapes
                "train_shapes": {
                    label: {k: r[k] for k in ("ms", "plain_ms", "device_ms", "kernel_profiled_ms",
                                              "kernel_profiled_by_launch", "library_ms",
                                              "library_device_ms", "library_note",
                                              "bound_ms", "bound_by", "ulp_err")}
                    for label, r in bwd["train_shapes"].items()},
            },
            {
                "name": "ssd_bwd",
                "route": "cuda",
                "source": "src/repro_torch/csrc/ssd_bwd.cu",
                # the Pallas scan has no VJP: the reference differentiates
                # its oracle ssd_reference through XLA
                "replaces": "src/repro/models/ssm.py:80",
                "launches": sbwd_n,
                "launches_by_path": sbwd_by,
                "launch_unit": "one set of six kernels (bf16: chunk states, state passes, "
                               "scores, dx, dB/dC, ddt/dA)",
                "max_abs_err": sbwd["max_abs_err"],
                "max_scaled_err": sbwd["max_scaled_err"],
                "max_ulp_err_bf16": sbwd["max_ulp_err"],
                "ms": t_sbwd["ms"],
                "plain_ms": t_sbwd["plain_ms"],
                "bound_ms": t_sbwd["bound_ms"],
                "bound_by": t_sbwd["bound_by"],
                "library_ms": t_sbwd["library_ms"],
                "device_ms": t_sbwd["device_ms"],
                "design": SSD_DESIGN_BWD[torch.bfloat16],
                "design_by_dtype": {str(dt).split(".")[-1]: d for dt, d in SSD_DESIGN_BWD.items()},
                "ptxas": t_sbwd["ptxas"],
                "kernel_profiled_ms": t_sbwd["kernel_profiled_ms"],
                "train_shape_ulp_err": t_sbwd["ulp_err"],
                "train_shape_control_ulp_err": t_sbwd["control_ulp_err"],
                "hymba_train_shape": {k: kern["ssd_bwd"]["timings"]["hymba train"][k]
                                      for k in ("ms", "plain_ms", "device_ms", "bound_ms",
                                                "bound_by", "kernel_profiled_ms", "ulp_err",
                                                "control_ulp_err")},
                "at": t_sbwd["case"] + ", the model's dt/A laws",
            },
        ]
    }


def main(argv: list) -> int:
    # one card: the first, unless the caller chose the visible devices
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if argv not in ([], ["--k1-wide"]):
        print(f"chip_smoke: unknown arguments {argv}; the only one is --k1-wide",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails first in a directory without the port)

    t0 = time.perf_counter()
    dev = phase_device()
    if argv:
        return k1_wide(dev)
    dry = DryRuns()  # on the host, beside the card's phases
    try:
        return _run(t0, dev, dry)
    finally:
        dry.close()


def k1_wide(dev: dict) -> int:
    """K1 at the wide pairs' main-path shapes, as the kernels phases hold
    and time them: deepseek-v2's MLA prefill, paligemma's prefill, both
    models' training attention (:func:`_mla_timing`,
    :func:`_encdec_vlm_timings`, :func:`_wide_train_timings`) and the
    head-dim-128 configs' training and prefill attention
    (:func:`_k1_128_timings`), each output within the bf16 tolerance of the
    plain version; then K1-bwd at 128/128's training shapes
    (:func:`_k1_bwd_128`); with the ptxas registers and spills of both
    libraries' wide instantiations. The last line is ``{"ok": true,
    "k1_wide": {shape: {design, ms, device_ms, ...}}}``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    for name in ("flash_attention", "flash_attention_bwd"):
        build.library(name)
    emit("build", resources={**_wide_resources(build), "dh128": _dh128_resources(build)})
    got = {"deepseek MLA S=512": _mla_timing(), **_encdec_vlm_timings(ENCDEC_VLM_K1[:1]),
           **_wide_train_timings(), **_k1_128_timings()}
    for label, r in got.items():
        check(r["max_abs_err"] <= FWD_TOL["bfloat16"],
              f"flash_attention {label}: max_abs_err {r['max_abs_err']}")
    got.update({f"{label} bwd": r for label, r in _k1_bwd_128().items()})
    keys = ("ms", "device_ms", "plain_ms", "library_device_ms", "bound_ms", "bound_by",
            "max_abs_err", "kernel_profiled_by_launch", "ulp_err", "control_ulp_err")
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "k1_wide": {
        label: {"design": r.get("design") or fa.design(
                    torch.bfloat16, 192 if "deepseek" in label else 256,
                    128 if "deepseek" in label else 256),
                **{k: r.get(k) for k in keys}} for label, r in got.items()}}))
    return 0


def _planned_paths(dry: DryRuns, paths):
    """The served paths, :data:`SERVE_PLANNED`'s bf16 depth taken from the
    dry run's serve plan when its turn comes."""
    for arch, serve_kw, path_kernels, depth in paths:
        if arch == SERVE_PLANNED:
            plan = dry.wait_for("serve_plan")
            emit("dryrun", serve_plan=plan, waited_s=time.perf_counter() - dry.t0)
            check(plan["fits"], f"{arch}: no depth fits the card: {plan}")
            depth = {**depth, "bfloat16": plan["depth"]}
        yield arch, serve_kw, path_kernels, depth


def _run(t0: float, dev: dict, dry: DryRuns) -> int:
    phase_build()
    kern = phase_kernels()
    plan = dry.wait_for("deepseek_plan")
    emit("dryrun", deepseek_plan=plan, waited_s=time.perf_counter() - dry.t0)
    kern.update(phase_flash_bwd(plan["seq"]))
    kern.update(phase_ssd_kernels())
    kern.update(phase_ssd_bwd())
    emit("timing", kernels_phases_s=time.perf_counter() - t0)
    phase_readback()
    serves = [phase_serve(*path) for path in _planned_paths(dry, PATHS)]
    emit("timing", serve_phases_s=time.perf_counter() - t0)
    serves += [phase_encdec_vlm(*path) for path in ENCDEC_VLM_PATHS]
    emit("timing", encdec_vlm_phases_s=time.perf_counter() - t0)
    trains = [phase_train(arch, steps) for arch, steps in TRAIN_CELLS]
    emit("timing", train_phases_s=time.perf_counter() - t0)
    trains.append(phase_train_lm())
    emit("timing", train_lm_phases_s=time.perf_counter() - t0,
         train_lm_phase_s=trains[-1]["phase_s"])
    for arch, B, S in PARITY_CELLS:
        phase_train_parity(arch, B, S)
    trains.append(phase_planned_train(plan))
    emit("timing", deepseek_train_phase_s=time.perf_counter() - t0)
    for arch in DENSE_TRAIN:
        dense_plan = dry.wait_for("train_plan", arch)
        check(dense_plan["fits"], f"{arch}: no depth fits the card: {dense_plan}")
        trains.append(phase_planned_train(dense_plan))
    emit("timing", dense_train_phases_s=time.perf_counter() - t0)
    phase_dryrun(dry, trains, serves)
    par = phase_parallel(trains[0])
    # the sharded bf16 training run's launches count on the kernels line
    trains.append({"arch": "tinyllama-1.1b on the (1, 1) mesh",
                   "launches": par["tinyllama_bf16_trainer"]["launches"]})
    fams = phase_parallel_families({t["arch"]: t for t in trains})
    trains += [{"arch": f"{arch} on the (1, 1) mesh", "launches": fams[f"{arch}_bf16"]["launches"]}
               for arch in FAMILY_TRAIN]
    pipe = phase_pipeline()
    # and the pipelined bf16 step's
    trains.append({"arch": "tinyllama-1.1b pipelined", "launches": {
        name: pipe["bf16"]["launches"].get(name, 0) for name in _train_counters()}})
    phase_pool()
    emit("timing", total_s=time.perf_counter() - t0)
    print(json.dumps(_kernel_line(kern, serves, trains)))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
