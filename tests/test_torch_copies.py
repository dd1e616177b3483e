"""The port's copies of the reference's jax-free modules stay copies.

Each module below is the reference's with one rewrite (:func:`rewrite`):
an absolute import of the reference package becomes a relative one (every
copy sits one package below ``repro_torch``, as its original sits below
``repro``), and every other ``repro.`` (docstrings, CLI program names,
error messages, doctests) becomes ``repro_torch.``. A line the port changed
or added beyond that is a repair and is listed in :data:`REPAIRS` with the
reason; any other difference (a changed, added or dropped line) is drift
and fails here.

The copies' command lines run with the reference absent: ``python -m
repro_torch.dist.remote_worker --help``, ``python -m repro_torch.analysis.lint
--help`` and ``python -m repro_torch.analysis.fuzz --quick`` load no module
of ``repro`` or JAX.
"""
import difflib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# the copies, by path under each package
COPIES = (
    "core/task.py",
    "core/deque.py",
    "core/graph.py",
    "core/pool.py",
    "core/replay.py",
    "core/executor.py",
    "core/baseline.py",
    "core/observer.py",
    "core/schedule.py",
    "core/chaos.py",
    "dist/__init__.py",
    "dist/wire.py",
    "dist/shm_arena.py",
    "dist/worker.py",
    "dist/process_pool.py",
    "dist/remote_worker.py",
    "dist/socket_pool.py",
    "analysis/lint.py",
    "analysis/races.py",
    "analysis/verify.py",
    "analysis/fuzz.py",
    "testing.py",
)

# path -> the port's lines that a repair or a rewording changed or added,
# with the reason in the comment above each
REPAIRS = {
    # wording of a docstring
    "core/graph.py": ["    consumers receive plain values. The graph-building API mirrors"],
    # ROADMAP F13: a worker forked after the owner's resource tracker started
    # shares it, and its unregister after attaching a pooled segment dropped
    # the owner's registration, so the owner's unlink made the tracker print
    # KeyError tracebacks (from the second process pool of a process on).
    # The owner now starts the tracker before any worker forks, so every
    # worker shares it, and an attach leaves the owner's registration alone.
    "dist/shm_arena.py": [
        "from multiprocessing import resource_tracker, shared_memory",
        "        if not attach_only:",
        "            # the owner's resource tracker runs before any worker forks, so",
        "            # every worker shares it: a worker's attach then registers a",
        "            # name the owner already holds, and must not unregister it",
        "            resource_tracker.ensure_running()",
        "            seg = shared_memory.SharedMemory(name=ref.name)  # the owner unlinks it",
    ],
    # the shim's docstring names its own module: the rewrite's relative
    # import is for a copy one package below, and this one sits at the top;
    # and the wording of the composite's inner function's name
    "testing.py": [
        "        from repro_torch.testing import given, settings, st",
        "        def strategy_of(*args: Any, **kw: Any) -> Strategy:",
        "        return strategy_of",
    ],
    # wording of the section comment over the CLI's entry point
    "analysis/lint.py": [
        "# -- command line --------------------------------------------------------------",
    ],
}

_IMPORT = re.compile(r"^(\s*)from repro\.(\S+) import", re.M)


def rewrite(src: str) -> str:
    """The reference's source as the port copies it."""
    src = _IMPORT.sub(r"\1from ..\2 import", src)
    return re.sub(r"\brepro\.", "repro_torch.", src)


def _drift(rel: str) -> list:
    """(port line number, rewritten reference lines, port lines) of every
    run of lines where the two differ, unless the run replaces or adds
    lines that the repairs list (a run that drops lines and adds none is
    drift)."""
    want = rewrite((REF / rel).read_text()).splitlines()
    got = (PORT / rel).read_text().splitlines()
    listed = set(REPAIRS.get(rel, ()))
    out = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, want, got,
                                                       autojunk=False).get_opcodes():
        if tag != "equal" and (j1 == j2 or any(b not in listed for b in got[j1:j2])):
            out.append((j1 + 1, want[i1:i2], got[j1:j2]))
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_after_rewrite(rel):
    drift = _drift(rel)
    assert not drift, f"repro_torch/{rel} drifted from the reference:\n" + "\n".join(
        f"{n}: -{a!r}\n{n}: +{b!r}" for n, a, b in drift[:20])


@pytest.mark.parametrize("rel", sorted(REPAIRS))
def test_every_listed_repair_is_still_needed(rel):
    """A listed line is in the copy and not in the rewritten reference."""
    ref_lines = set(rewrite((REF / rel).read_text()).splitlines())
    port_lines = set((PORT / rel).read_text().splitlines())
    for line in REPAIRS[rel]:
        assert line in port_lines and line not in ref_lines, (rel, line)


_NO_REFERENCE = (
    "import runpy, sys\n"
    "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    rc = e.code or 0\n"
    "else:\n"
    "    rc = 0\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
    "print('LOADED', bad)\n"
    "sys.exit(rc if not bad else 3)\n"
)


@pytest.mark.parametrize("argv", [
    ("repro_torch.dist.remote_worker", "--help"),
    ("repro_torch.analysis.lint", "--help"),
    ("repro_torch.analysis.fuzz", "--quick"),
], ids=lambda a: a[0])
def test_cli_runs_without_the_reference(argv):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_REFERENCE, *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(PORT.parent), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    assert "python -m repro_torch." in proc.stdout or argv[1] == "--quick", proc.stdout
