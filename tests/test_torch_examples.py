"""The port's serving example (``examples/serve_lm_torch.py``) run as a
user runs it, here on the CPU: reduced mamba2, prompt lengths repeating,
so its prefills replay their lengths' graphs; the first request's streamed
tokens equal its future's."""
import ast
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
