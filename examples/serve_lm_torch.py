"""Serving example for the PyTorch/CUDA port: a thin client of
``repro_torch.serve.ServeEngine``, the counterpart of ``serve_lm.py``.

Submits a handful of prompts to the continuous-batching engine — prefill
runs as low-priority tasks on the work-stealing pool, decode ticks at high
priority, sequences join and retire between ticks. KV storage is the paged
pool, the admit queue is bounded (``QueueFull`` backpressure), every
request carries a TTFT deadline, and the first request is **streamed**
token by token while the rest resolve through their futures.

The prompts take a few lengths in turn, so lengths repeat: a family that
may not pad its prompts to buckets (``--arch mamba2-1.3b``, hymba) prefills
each length eagerly the first time and by that length's CUDA graph after,
as the reference's ``jax.jit(model.prefill)`` compiles once per length; the
graph counts are printed at the end.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch mamba2-1.3b] [--device cpu]

The engine runs on ``cuda:0`` unless ``--device`` says otherwise (without a
GPU, pass ``--device cpu``). Uses the arch's REDUCED config, random weights
from seed 0, so it runs in seconds; ``--full`` builds the real config. On
the card a reduced config's attention head dim (16, or 24) is raised to
32, the flash kernel's smallest (``kernels.flash_attention.fit_head_dims``).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.kernels.flash_attention import fit_head_dims
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.serve import QueueFull, ServeEngine

# the engine serves text-prompt families; encdec/vlm need non-token inputs
SERVABLE = tuple(
    n for n in ARCH_NAMES
    if not get_config(n).is_encdec and get_config(n).family != "vlm"
)
LENGTHS = 3  # distinct prompt lengths, taken in turn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=SERVABLE)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--deadline", type=float, default=60.0,
                    help="per-request TTFT deadline (seconds)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the model and engine run (default cuda:0)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if device.type == "cuda":  # a reduced config's head dim is below the kernel's
        cfg = fit_head_dims(cfg)
    model = build_model(cfg, device=device)
    print(f"arch={cfg.name} family={cfg.family} device={device}")
    params = model.init(seed=0)

    rng = np.random.default_rng(1)
    lengths = rng.integers(args.prompt_len // 2, args.prompt_len + 1, size=LENGTHS)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=int(lengths[i % LENGTHS])).astype(np.int32)
        for i in range(args.requests)
    ]
    budgets = [int(rng.integers(max(2, args.new // 2), args.new + 1)) for _ in range(args.requests)]

    max_len = args.prompt_len + args.new + 1
    buckets = None
    if ServeEngine.supports_prefill_buckets(cfg):
        buckets = (args.prompt_len // 2, args.prompt_len)

    t0 = time.perf_counter()
    with ServeEngine(
        model, params, max_slots=args.slots, max_len=max_len,
        prefill_buckets=buckets,
        max_waiting=4 * args.slots,  # bounded admit queue: QueueFull past this
        device=device,
    ) as engine:
        handles = []
        for p, n in zip(prompts, budgets):
            while True:
                try:
                    handles.append(engine.submit(p, n, deadline=args.deadline))
                    break
                except QueueFull:  # backpressure: shed upstream or retry
                    time.sleep(0.002)

        # stream the first request token by token as its decode ticks land;
        # `async for tok in handle` is the asyncio equivalent
        streamed = [int(tok) for tok in handles[0]]
        print(f"request 0 streamed {len(streamed)} tokens, "
              f"TTFT {handles[0].ttft * 1e3:.1f} ms")

        outs = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        stats = engine.stats()

    if streamed != list(map(int, outs[0])):
        raise SystemExit(f"the stream {streamed} and the future {list(outs[0])} disagree")
    total = sum(len(o) for o in outs)
    ttfts = sorted(h.ttft for h in handles)
    print(f"{len(outs)} requests, {total} tokens in {wall * 1e3:.1f} ms "
          f"(incl. first-use prefills) -> {total / max(wall, 1e-9):,.0f} tok/s")
    print(f"TTFT p50={ttfts[len(ttfts) // 2] * 1e3:.1f} ms "
          f"max={ttfts[-1] * 1e3:.1f} ms "
          f"deadline_misses={stats['deadline_misses']} rejected={stats['rejected']}")
    kv = stats["kv"]
    print(f"ticks={stats['ticks']} mean_occupancy={stats['mean_occupancy']:.2f} "
          f"preemptions={stats['preemptions']} "
          f"pages={kv['pages_live']}/{kv['pages_total']} live "
          f"(peak {kv.get('peak_pages_live', kv['peak_live'])}) "
          f"pool_steals={stats['pool']['steals']}")
    # a length's first prefill is eager (eager_steps), the rest replay its graph
    print("graphs:", {name: {k: g[k] for k in ("eager_steps", "replays") if k in g}
                      for name, g in stats["graphs"].items()})
    print("streamed token ids (first request):", streamed)
    print("generated token ids (first request):", list(map(int, outs[0])))


if __name__ == "__main__":
    main()
