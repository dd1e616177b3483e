"""End-to-end training tutorial for the PyTorch/CUDA port: train a
124.6M-parameter LM for a few hundred steps, the counterpart of
``train_lm.py``.

Exercises the port's trainer on one card: a model zoo config, synthetic
batches prefetched on the pool's lanes, the train step as one CUDA graph
(an eager first step, then a captured step replayed; ``runtime/graph.py``),
AdamW, async checkpoints with atomic commit and resume, and (optionally) a
failure injected halfway to show the restart: the run resumes from the last
committed checkpoint and captures its step anew.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--fail] [--device cpu]

The model (12 layers, d=768, 12/4 heads, head dim 64, d_ff 2048, vocab
32 000, f32, no remat) has 124 649 472 parameters by ``param_count``, the
untied head included (75.5 M without the embedding and the head). It runs
on ``cuda:0`` unless ``--device`` says otherwise and raises without a GPU;
``--tiny --device cpu`` trains a 4-layer model on the CPU, where the
kernels' plain versions stand in. With ``--fail`` the run resumes from the
latest checkpoint under ``--ckpt``, a stale one included: give a fresh
directory.

Besides the reference's lines it prints the device, the median step time,
the restarts, each run's graph (captures and replays), the attention
kernels' launches a step and each checkpoint's bytes and seconds, and last
a ``summary:`` line with all of it as JSON.
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, param_count
from repro_torch.kernels.flash_attention import flash_attention_bhsd, flash_attention_bwd
from repro_torch.models.common import resolve_device
from repro_torch.runtime import Trainer, TrainerConfig

CKPT = Path(__file__).resolve().parents[1] / "build" / "train_lm_torch"
# the attention kernels' wrappers, whose ``launches`` count the launches
# that ran outside a graph
COUNTERS = {"flash_attention": flash_attention_bhsd, "flash_attention_bwd": flash_attention_bwd}


def model_100m() -> ModelConfig:
    # 124.6M params by param_count: 12L, d=768, llama-style
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32_000,
        remat="none", dtype="float32",
    )


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="lm-tiny", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=688, vocab_size=4_096,
        remat="none", dtype="float32",
    )


def trainer_config(steps: int, seq: int, batch: int, fail: bool) -> TrainerConfig:
    """The run's settings from the flags, as the reference derives them."""
    return TrainerConfig(
        num_steps=steps,
        checkpoint_every=max(steps // 4, 10),
        log_every=max(steps // 20, 1),
        seq_len=seq,
        global_batch=batch,
        lr=3e-4,
        warmup=20,
        fail_at_step=steps // 2 if fail else None,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--fail", action="store_true", help="inject a failure mid-run")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="where the model trains (default cuda:0)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = model_tiny() if args.tiny else model_100m()
    n_params = int(param_count(cfg)["total"])
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M ({n_params:,} by param_count)")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else None
    print(f"device: {device}" + (f" ({card})" if card else ""))
    tcfg = trainer_config(args.steps, args.seq, args.batch, args.fail)
    for fn in COUNTERS.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    with Trainer(cfg, tcfg, args.ckpt, device=device) as tr:
        out = tr.run_with_restarts() if args.fail else tr.run(resume=False)
        runs, saves = tr.runs, tr.ckpt.saves
    dt = time.time() - t0
    rows = out["metrics"]
    first, last = rows[0], rows[-1]
    toks = args.seq * args.batch * args.steps
    print(f"\nsteps={args.steps} wall={dt:.1f}s  tokens/s={toks / dt:,.0f}")
    print(f"loss: {first['loss']:.4f} (step {first['step']}) -> "
          f"{last['loss']:.4f} (step {last['step']})")

    step_s = float(np.median([r["step_s"] for r in rows[1:]]))
    print(f"step_s median of the logged rows after the first: {step_s:.4f} s "
          f"({args.seq * args.batch / step_s:,.0f} tokens/s)")
    # every run's steps went through its graph: one eager step, then the
    # captured step's replays, which launch what the capture recorded
    graphs = [{"start_step": r["start_step"], **{k: r["graph"][k] for k in (
        "eager_steps", "replays", "capture_s", "captured_launches")}} for r in runs]
    ran = sum(g["eager_steps"] + g["replays"] for g in graphs)
    launches = {name: fn.launches + sum(g["replays"] * g["captured_launches"].get(name, 0)
                                        for g in graphs)
                for name, fn in COUNTERS.items()}
    print(f"restarts: {len(runs) - 1}, resumed from steps {[g['start_step'] for g in graphs[1:]]}")
    print("graphs:", [{k: g[k] for k in ("start_step", "eager_steps", "replays", "capture_s")}
                      for g in graphs])
    print(f"launches a step over {ran} steps:",
          {name: n / ran for name, n in launches.items()})
    for s in saves:
        print(f"checkpoint step {s['step']}: {s['bytes'] / 1e9:.3f} GB, snapshot "
              f"{s['snapshot_s']:.3f} s, committed after {s['seconds']:.3f} s")
    peak = None
    if device.type == "cuda":
        peak = {"allocated": torch.cuda.max_memory_allocated(device),
                "reserved": torch.cuda.max_memory_reserved(device)}
        print(f"peak memory: {peak['allocated'] / 1e9:.3f} GB allocated, "
              f"{peak['reserved'] / 1e9:.3f} GB reserved")
    print("summary:", json.dumps({
        "model": cfg.name, "params": n_params, "device": str(device), "card": card,
        "steps": args.steps, "seq": args.seq, "batch": args.batch, "wall_s": dt,
        "tokens_per_s": toks / dt, "step_s_median": step_s, "rows": rows,
        "restarts": len(runs) - 1, "graphs": graphs, "steps_run": ran,
        "launches": launches, "checkpoints": saves, "peak_mem_bytes": peak,
    }))
    assert last["loss"] < first["loss"], "loss did not decrease"


if __name__ == "__main__":
    main()
