"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and neither of the port's examples
(``examples/serve_lm_torch.py``, ``examples/train_lm_torch.py``) imports
JAX, ``ml_dtypes`` or anything of the reference package, and importing the
whole port loads none of them."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "train_lm_torch.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_reference_module():
    code = (
        "import sys, repro_torch, repro_torch.bridge, repro_torch.configs, "
        "repro_torch.core, repro_torch.kernels, repro_torch.kernels.ssd, "
        "repro_torch.models.ssm, repro_torch.serve, repro_torch.optim, repro_torch.data, "
        "repro_torch.checkpoint, repro_torch.runtime, repro_torch.launch.train, "
        "repro_torch.core.schedule, repro_torch.core.chaos, repro_torch.dist, "
        "repro_torch.dist.remote_worker, repro_torch.dist.socket_pool, repro_torch.analysis, "
        "repro_torch.analysis.lint, repro_torch.analysis.races, repro_torch.analysis.fuzz, "
        "repro_torch.analysis.verify, repro_torch.parallel.pipeline\n"
        "from repro_torch.configs import get_config\n"
        "[get_config(a) for a in ('tinyllama-1.1b', 'mamba2-1.3b', 'hymba-1.5b')]\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "sys.exit(f'loaded {bad}' if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr + proc.stdout
