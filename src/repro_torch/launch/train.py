"""Training launcher: the CLI over the port's fault-tolerant Trainer, ported
from the reference's ``repro/launch/train.py``. It trains on ``--device``
(``cuda:0`` by default; a run on the CPU asks for it)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --device cpu --reduced --steps 20 --ckpt build/ckpt
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="build/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainerConfig(
        num_steps=args.steps,
        checkpoint_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1),
        seq_len=args.seq,
        global_batch=args.batch,
        lr=args.lr,
        fail_at_step=args.fail_at,
    )
    with Trainer(cfg, tcfg, args.ckpt, device=args.device) as tr:
        out = tr.run_with_restarts() if args.fail_at else tr.run(resume=args.resume)
    for row in out["metrics"]:
        print(
            f"step {row['step']:>6d}  loss {row['loss']:.4f}  "
            f"grad_norm {row['grad_norm']:.3f}  lr {row['lr']:.2e}"
        )


if __name__ == "__main__":
    main()
