"""Seeded random-interleaving schedule fuzzer (DESIGN.md §15).

A correct task graph produces the same results under *every* legal
execution order — that is what the dependency edges claim. This module
puts the claim on trial: it executes a graph serially many times, each
pass picking the next ready task from the frontier by a **stable keyed
draw** (the :mod:`repro_torch.core.chaos` pattern —
``blake2b(f"{seed}:{schedule}:{step}")``, never Python's per-process
``hash()`` or a shared ``random.Random`` stream), and asserts that every
schedule yields identical per-task results. A divergence means some pair
of bodies communicates outside the edges — exactly the class of bug the
static race detector (:mod:`~repro_torch.analysis.races`) hunts, witnessed
instead of inferred.

Full §10 semantics run in the loop (the same shared
:func:`~repro_torch.core.graph.select_branch` / ``splice_subflow`` protocol as
``SerialExecutor``): condition branches, weak-edge loops, and
runtime-spawned subflows all fuzz. Schedule 0 is executed **twice**
first — a graph whose results differ between identical schedules is
rerun-nondeterministic (stateful bodies, unseeded randomness), and
cross-schedule comparison would only report noise; pass ``reset=`` to
restore external state between runs.

CLI: ``python -m repro_torch.analysis.fuzz [--quick] [--seed N]`` fuzzes a
built-in corpus (diamond dataflow, condition loop, subflow fan-out,
wavefront) and exits non-zero on any divergence.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core.graph import Runtime, TaskGraph, _FinTask, select_branch, splice_subflow
from ..core.task import Task

from .lint import ERROR, Finding

__all__ = ["FuzzReport", "fuzz_schedules", "main"]


def _draw(seed: int, schedule: int, step: int) -> int:
    h = hashlib.blake2b(
        f"{seed}:{schedule}:{step}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big")


def _fingerprint(value: Any) -> Any:
    """Stable, comparable digest of a task result (arrays by content hash)."""
    if isinstance(value, BaseException):
        return ("exception", type(value).__name__, str(value))
    try:
        import numpy as np
    except ImportError:  # pragma: no cover - numpy is a test/bench dep
        np = None
    if np is not None and hasattr(value, "shape") and hasattr(value, "dtype"):
        try:
            arr = np.asarray(value)
            digest = hashlib.blake2b(
                arr.tobytes(), digest_size=8
            ).hexdigest()
            return ("ndarray", tuple(arr.shape), str(arr.dtype), digest)
        except Exception:  # noqa: BLE001 - fall through to repr
            pass
    try:
        return repr(value)
    except Exception:  # noqa: BLE001 - unreprable results still compare by type
        return ("unreprable", type(value).__name__)


@dataclass
class FuzzReport:
    """Outcome of one :func:`fuzz_schedules` campaign."""

    graph: str
    schedules: int
    rerun_deterministic: bool
    baseline: dict[str, Any] = field(default_factory=dict)
    findings: list[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.rerun_deterministic and not self.findings

    def __str__(self) -> str:
        verdict = "ok" if self.ok else f"{len(self.findings)} finding(s)"
        rerun = "" if self.rerun_deterministic else " (rerun-nondeterministic)"
        return (
            f"fuzz[{self.graph}]: {self.schedules} schedule(s), {verdict}{rerun}"
        )


def _run_schedule(graph: TaskGraph, seed: int, schedule: int) -> dict[str, Any]:
    """Execute one keyed-draw schedule serially; return result fingerprints."""
    tasks = list(graph.tasks)
    has_cond = graph.has_conditions
    for t in tasks:
        t.reset()
    frontier = [t for t in tasks if t.is_source]
    step = 0
    limit = 1000 * (len(tasks) + 1)
    while frontier:
        step += 1
        if step > limit:
            raise RuntimeError(
                f"schedule fuzzer: {limit} steps without draining "
                f"{graph.name!r} — non-terminating loop? (run the "
                "weak-loop-no-exit lint rule)"
            )
        t = frontier.pop(_draw(seed, schedule, step) % len(frontier))
        rt = Runtime(t) if t.takes_runtime else None
        try:
            t.run(rt)
        except BaseException as exc:  # noqa: BLE001 - pool contract: record, continue
            t.exception = exc
            t._done = True
        if t.on_done is not None:
            try:
                t.on_done(t)
            except BaseException:  # noqa: BLE001 - callback errors dropped (§8)
                pass
        if has_cond:
            t.rearm()  # single-threaded: re-arm unconditionally, like SerialExecutor
        if rt is not None and rt.sub.tasks and t.exception is None:
            sub, join = splice_subflow(t, rt.sub)  # shared join protocol
            t._spawned = sub
            roots = [s for s in sub if s.is_source]
            frontier.extend(roots if roots else [join])
            continue
        if t.kind == "condition":
            branch = select_branch(t)  # shared §10 selection rule
            if branch is not None:
                frontier.append(branch)
            continue
        for s in t.successors:
            if isinstance(s, _FinTask):
                continue  # as_future bookkeeping of some previous live run
            if s.decrement():
                frontier.append(s)
    out: dict[str, Any] = {}
    for i, t in enumerate(tasks):
        key = t.name or f"t{i}"
        out[key] = _fingerprint(t.exception if t.exception is not None else t.result)
    return out


def fuzz_schedules(
    graph: TaskGraph,
    *,
    schedules: int = 8,
    seed: int = 0,
    reset: Optional[Callable[[], None]] = None,
    max_findings: int = 8,
) -> FuzzReport:
    """Assert result identity across ``schedules`` seeded interleavings.

    Runs schedule 0 twice to separate rerun-nondeterminism from schedule
    dependence (module docs), then compares every further schedule's
    per-task result fingerprints against the baseline. ``reset`` (when
    given) runs before every schedule to restore state *outside* the
    graph — bodies mutating external accumulators are otherwise reported
    as rerun-nondeterministic rather than racy. The graph is left reset
    but unharmed: build once, fuzz, then run for real.
    """
    gname = graph.name or "<anonymous>"
    if reset is not None:
        reset()
    baseline = _run_schedule(graph, seed, 0)
    if reset is not None:
        reset()
    again = _run_schedule(graph, seed, 0)
    if again != baseline:
        diff = sorted(k for k in baseline if baseline[k] != again.get(k))[:max_findings]
        return FuzzReport(
            gname,
            2,
            False,
            baseline,
            [
                Finding(
                    "rerun-nondeterministic",
                    ERROR,
                    "two runs of the *same* schedule diverged — bodies carry "
                    f"state across runs (tasks: {', '.join(diff)}); pass "
                    "reset= if that state is external and restorable",
                    tuple(diff),
                    gname,
                )
            ],
        )
    findings: list[Finding] = []
    for k in range(1, schedules):
        if reset is not None:
            reset()
        snap = _run_schedule(graph, seed, k)
        if snap == baseline:
            continue
        for key in sorted(baseline):
            if len(findings) >= max_findings:
                break
            if baseline[key] != snap.get(key):
                findings.append(
                    Finding(
                        "schedule-dependent-result",
                        ERROR,
                        f"task {key!r} produced {baseline[key]!r} under schedule 0 "
                        f"but {snap.get(key)!r} under schedule {k} (seed {seed}) — "
                        "its value depends on execution order, not on its edges",
                        (key,),
                        gname,
                    )
                )
        if len(findings) >= max_findings:
            break
    return FuzzReport(gname, schedules + 1, True, baseline, findings)


# -- CLI corpus ----------------------------------------------------------------


def _corpus() -> list[tuple[TaskGraph, Optional[Callable[[], None]]]]:
    """Built-in graphs covering every §10 shape (each with a reset fn)."""
    out: list[tuple[TaskGraph, Optional[Callable[[], None]]]] = []

    diamond = TaskGraph("fuzz-diamond")
    a = diamond.add(lambda: 3, name="a")
    b = diamond.then(a, lambda x: x * 2, name="b")
    c = diamond.then(a, lambda x: x + 10, name="c")
    diamond.gather([b, c], fn=lambda x, y: x * y, name="join")
    out.append((diamond, None))

    loop = TaskGraph("fuzz-loop")
    state = {"i": 0}

    def bump() -> int:
        state["i"] += 1
        return state["i"]

    entry = loop.add(None, name="entry")
    body = loop.add(bump, name="body")
    body.after(entry)  # a weak-pred target is not a source: loops need an entry
    cond = loop.add(lambda: 0 if state["i"] < 5 else 9, kind="condition", name="more?")
    cond.after(body)
    cond.precede(body)  # branch 0: loop; 9 is out of range -> exit idiom
    out.append((loop, lambda: state.update(i=0)))

    sub = TaskGraph("fuzz-subflow")

    def spawn(rt: Runtime) -> Any:
        parts = [rt.add(lambda j=j: j * j, name=f"part{j}") for j in range(4)]
        return rt.gather(parts, fn=lambda *vs: sum(vs), name="sum")

    sp = sub.add(spawn, takes_runtime=True, name="spawn")
    sub.then(sp, lambda total: total + 1, name="after")
    out.append((sub, None))

    wave = TaskGraph("fuzz-wavefront")
    n = 4
    cells: dict[tuple[int, int], Task] = {}
    for i in range(n):
        for j in range(i + 1):
            r, c_ = i - j, j
            cells[(r, c_)] = wave.add(lambda r=r, c=c_: r * n + c, name=f"cell{r},{c_}")
            if r > 0:
                cells[(r, c_)].after(cells[(r - 1, c_)])
            if c_ > 0:
                cells[(r, c_)].after(cells[(r, c_ - 1)])
    out.append((wave, None))
    return out


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fuzz",
        description="Fuzz the built-in graph corpus across seeded schedules.",
    )
    parser.add_argument("--quick", action="store_true", help="4 schedules per graph")
    parser.add_argument("--schedules", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    schedules = 4 if opts.quick else opts.schedules

    failed = False
    for graph, reset in _corpus():
        report = fuzz_schedules(graph, schedules=schedules, seed=opts.seed, reset=reset)
        print(report, file=sys.stderr)
        if not report.ok:
            failed = True
            for f in report.findings:
                print(f"  {f}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI in CI
    raise SystemExit(main())
