"""The port's examples run as a user runs them, here on the CPU: the
serving example (``examples/serve_lm_torch.py``) on reduced mamba2, prompt
lengths repeating, so its prefills replay their lengths' graphs, the first
request's streamed tokens equal to its future's; the training tutorial
(``examples/train_lm_torch.py``) at its tiny config, restarted mid-run."""
import ast
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _printed(out: str, label: str):
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return ast.literal_eval(line[len(label):].strip())


def test_serve_example_streams_the_futures_tokens_and_replays_prefill_graphs():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"), "--device", "cpu",
         "--arch", "mamba2-1.3b"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr + proc.stdout
    streamed = _printed(proc.stdout, "streamed token ids (first request):")
    assert streamed and streamed == _printed(proc.stdout, "generated token ids (first request):")
    graphs = _printed(proc.stdout, "graphs:")
    exact = {k: g for k, g in graphs.items() if k.startswith("exact_")}
    assert exact and all(g["eager_steps"] == 1 for g in exact.values())
    assert sum(g["replays"] for g in exact.values()) == 8 - len(exact)  # eight prompts


def test_train_example_restarts_once_and_its_loss_falls(tmp_path):
    """The training tutorial at its tiny config on the CPU with ``--fail``:
    one restart after the failure injected at step 20, resumed from the
    step-20 checkpoint into a graph of its own, the loss lower at the end,
    the step-40 checkpoint committed."""
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--device", "cpu",
         "--tiny", "--steps", "40", "--seq", "64", "--batch", "4", "--fail",
         "--ckpt", str(ckpt)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr + proc.stdout
    lines = proc.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("[trainer] restart")] == [
        "[trainer] restart 1 after: injected failure at step 20"]
    summary = json.loads(next(ln for ln in lines if ln.startswith("summary:"))[8:])
    assert summary["restarts"] == 1 and summary["steps_run"] == 40
    assert [g["start_step"] for g in summary["graphs"]] == [0, 20]
    assert all(g["eager_steps"] == 1 and g["replays"] == 19 for g in summary["graphs"])
    losses = [r["loss"] for r in summary["rows"]]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert [s["step"] for s in summary["checkpoints"]] == [10, 20, 30, 40]
    assert (ckpt / "step_00000040" / "manifest.json").exists()
