"""Fresh-process first-launch trials of the flash attention kernel.

Each trial is a new Python process that builds ``csrc/flash_attention.cu``
with nvcc into a build directory of its own, so that its first kernel launch
follows a fresh build, as in a first run of ``chip_smoke.py``. It runs the
first check of ``chip_smoke.py``'s kernels phase (tinyllama shapes, bf16,
Sq=Sk=64, causal, model layout) against the plain version, launches again on
the same inputs, and checks Sq=Sk=300 in bf16 and f32. The wrapper's own
first-launch check runs before each instantiation's first launch; when it
raises, the trial ends with a non-zero exit and counts as a first-launch
failure.
``--cudart`` picks the CUDA runtime the library links: ``shared`` (the
port's build) or ``static`` (nvcc's default), and trials alternate between
the runtimes given. Needs a CUDA card::

    PYTHONPATH=src python -m repro_torch.kernels.launch_trials --trials 24 --jobs 4

Prints one JSON line per trial and, last, one summary line per runtime.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _flags(cudart: str) -> tuple:
    from . import build

    flags, out, skip = build.NVCC_FLAGS, [], False
    for f in flags:  # drop the runtime choice, then state it
        if skip:
            skip = False
        elif f == "-cudart":
            skip = True
        else:
            out.append(f)
    return (*out, "-cudart", cudart)


def _child(build_dir: str, cudart: str) -> dict:
    import torch

    from . import build
    from .flash_attention import flash_attention, flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build.BUILD_DIR = Path(build_dir)
    build.NVCC_FLAGS = _flags(cudart)
    with ThreadPoolExecutor(1) as ex:  # built and loaded off the main thread, as chip_smoke
        ex.submit(build.library, "flash_attention").result()

    def case(S, dtype, seed, repeat=1):
        g = torch.Generator(device="cuda").manual_seed(seed)
        shapes = [(1, S, 32, 64), (1, S, 4, 64), (1, S, 4, 64)]
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes)
        want = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), causal=True)
        errs = []
        for _ in range(repeat):
            got = flash_attention(q, k, v, causal=True).transpose(1, 2)
            torch.cuda.synchronize()
            errs.append((got.float() - want.float()).abs().max().item())
        return errs

    first, second = case(64, torch.bfloat16, 0, repeat=2)
    with open("/proc/self/maps") as f:
        cudart_libs = sorted({os.path.realpath(ln.split()[-1]) for ln in f if "libcudart" in ln})
    return {
        "first_launch_err": first,
        "second_launch_err": second,
        "s300_bf16_err": case(300, torch.bfloat16, 1)[0],
        "s300_f32_err": case(300, torch.float32, 2)[0],
        "nvcc_s": build.build_log["flash_attention"]["seconds"],
        "cudart_libs": cudart_libs,
    }


def _ok(r: dict) -> bool:
    bf16 = (r["first_launch_err"], r["second_launch_err"], r["s300_bf16_err"])
    return all(e <= TOL["bfloat16"] for e in bf16) and r["s300_f32_err"] <= TOL["float32"]


def _run_trial(i: int, cudart: str, root: Path) -> dict:
    build_dir = root / f"{cudart}-{i}"
    shutil.rmtree(build_dir, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", __spec__.name, "--child", str(build_dir), "--cudart", cudart],
        capture_output=True, text=True, timeout=600,
    )
    shutil.rmtree(build_dir, ignore_errors=True)
    res = {"trial": i, "cudart": cudart, "rc": proc.returncode}
    if proc.returncode == 0:
        res.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        res["ok"] = _ok(res)
    else:
        res.update(ok=False, stderr=proc.stderr[-2000:])
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=24, help="trials per runtime")
    ap.add_argument("--jobs", type=int, default=4, help="trials running at once")
    ap.add_argument("--cudart", nargs="+", default=["shared"], choices=["shared", "static"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child, args.cudart[0])))
        return 0
    from . import build

    root = build.BUILD_DIR / "trials"
    plan = [(i, rt) for i in range(args.trials) for rt in args.cudart]  # alternate runtimes
    with ThreadPoolExecutor(args.jobs) as ex:
        results = list(ex.map(lambda a: _run_trial(*a, root), plan))
    for rt in args.cudart:
        mine = [r for r in results if r["cudart"] == rt]
        print(json.dumps({
            "cudart": rt,
            "trials": len(mine),
            "failed": sum(not r["ok"] for r in mine),
            "first_launch_failed": sum(
                r["rc"] != 0 or r["first_launch_err"] > TOL["bfloat16"] for r in mine
            ),
            "max_first_launch_err": max(
                (r["first_launch_err"] for r in mine if r["rc"] == 0), default=None
            ),
        }), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
