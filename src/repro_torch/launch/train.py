"""Training launcher: the CLI over the port's fault-tolerant Trainer, ported
from the reference's ``repro/launch/train.py``. It trains on ``--device``
(``cuda:0`` by default; a run on the CPU asks for it)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --device cpu --reduced --steps 20 --ckpt build/ckpt

``--depth`` cuts the decoder's layers (a full-width model that does not
fit the card whole, as deepseek-v2's); AdamW's moments are bf16 where the
arch's full config has over 1e11 parameters (the reference's rule,
``launch.dryrun.moments_dtype_for``), whatever the depth. On the card a
``--reduced`` config's attention head dims (16, or 24) are raised to 32,
the flash kernel's smallest (``kernels.flash_attention.fit_head_dims``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.kernels.flash_attention import fit_head_dims
from repro_torch.launch.dryrun import moments_dtype_for
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
    ap.add_argument("--depth", type=int, default=None, help="decoder layers (default: all)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.depth is not None:
        cfg = cfg.replace(num_layers=args.depth)
    if args.device.startswith("cuda"):  # a reduced config's head dim is below the kernel's
        cfg = fit_head_dims(cfg)
    tcfg = TrainerConfig(
        num_steps=args.steps,
        checkpoint_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1),
        seq_len=args.seq,
        global_batch=args.batch,
        lr=args.lr,
        fail_at_step=args.fail_at,
        moments_dtype=moments_dtype_for(get_config(args.arch)),
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
