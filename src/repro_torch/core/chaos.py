"""Deterministic fault injection for the §14 fault-tolerance layer.

:class:`FaultInjector` hooks the same backend seams ``ProcessPool`` uses
(DESIGN.md §11): it wraps the pool's ``_offload`` body-dispatch hook to
perturb body execution, and chains ``_wire_tasks`` so injection composes
with process-backend wiring. Faults are decided by a **stable keyed hash**
— ``blake2b(f"{seed}:{task.name}:{occurrence}")`` mapped to a uniform
float in [0, 1) — not by Python's per-process-salted ``hash()`` and not by
shared-stream ``random.Random`` draws, so the schedule of injected faults
for a given seed is identical across runs, across backends, and across
interleavings: the *k*-th execution of task ``"load:3"`` either always
faults or never does, no matter which worker runs it or in what order.

Three fault kinds, each gated by an independent rate:

* **fail** — raise :class:`ChaosError` at the dispatch seam, *before* the
  body runs (the body never partially executes, so injected failures are
  always safe to retry);
* **delay** — sleep ``delay_s`` at the seam, then run the body normally
  (exercises timeout deadlines and backoff-vs-progress interleavings);
* **kill** — on a ``ProcessPool``, kill the worker process about to run
  the body (the real broken-pipe → respawn → ``WorkerDiedError`` path);
  on thread/serial backends, raise a synthetic pre-start
  ``WorkerDiedError(started=False)`` so the same retry semantics are
  exercised without a process to kill.

The injector records every decision in :meth:`schedule` — chaos tests
assert that two runs with the same seed produce byte-identical schedules
— and doubles as a pool observer counting the retries/timeouts its faults
provoked. Use :meth:`install` / :meth:`uninstall` (or the context manager
form) around a run::

    inj = FaultInjector(seed=7, fail_rate=0.2)
    with inj.on(pool):
        pool.run(graph)
    assert inj.schedule() == expected
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Optional

from .task import Task

__all__ = ["ChaosError", "FaultInjector"]

_DENOM = float(1 << 64)


class ChaosError(RuntimeError):
    """An injected (synthetic) body failure from :class:`FaultInjector`."""


def _roll(seed: int, name: str, occ: int, salt: str) -> float:
    """Deterministic uniform [0,1) draw keyed on (seed, task, occurrence).

    Stable across processes and backends — unlike ``hash()`` (per-process
    salt) or a shared ``random.Random`` stream (interleaving-dependent).
    """
    h = hashlib.blake2b(
        f"{seed}:{salt}:{name}:{occ}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / _DENOM


class FaultInjector:
    """Seeded, deterministic fault injection through the §11 pool seams.

    Parameters
    ----------
    seed:
        Keys every fault decision; same seed ⇒ same schedule, everywhere.
    fail_rate, delay_rate, kill_rate:
        Independent per-body-execution probabilities (evaluated in that
        order; at most one fault fires per execution).
    delay_s:
        Sleep injected by a **delay** fault.
    match:
        Optional predicate ``fn(task) -> bool`` restricting injection
        (e.g. only ``name.startswith("flaky:")``). Control-flow bodies
        (conditions, spawners) are never injected — they drive the
        scheduler itself, and ``ProcessPool`` never offloads them either.
    """

    def __init__(
        self,
        seed: int,
        *,
        fail_rate: float = 0.0,
        delay_rate: float = 0.0,
        kill_rate: float = 0.0,
        delay_s: float = 0.005,
        match: Optional[Callable[[Task], bool]] = None,
    ) -> None:
        self.seed = seed
        self.fail_rate = fail_rate
        self.delay_rate = delay_rate
        self.kill_rate = kill_rate
        self.delay_s = delay_s
        self.match = match
        self._lock = threading.Lock()
        self._occ: dict[str, int] = {}
        self._log: list[tuple[str, int, str]] = []
        self._pool: Any = None
        self._inner: Any = None
        # observer side: §14 events provoked (or not) by the injection
        self.retries = 0
        self.timeouts = 0

    # -- install / uninstall --------------------------------------------------

    def install(self, pool: Any) -> None:
        """Wrap ``pool._offload`` (keeping any inner backend offload, e.g.
        ``ProcessPool._offload_body``) and attach as an observer."""
        if self._pool is not None:
            raise RuntimeError("FaultInjector is already installed on a pool")
        self._pool = pool
        self._inner = pool._offload
        pool._offload = self._offload
        pool.add_observer(self)

    def uninstall(self) -> None:
        """Restore the wrapped seams (no-op if not installed)."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        pool._offload = self._inner
        self._inner = None
        pool.remove_observer(self)

    class _On:
        def __init__(self, inj: "FaultInjector", pool: Any) -> None:
            self._inj, self._pool = inj, pool

        def __enter__(self) -> "FaultInjector":
            self._inj.install(self._pool)
            return self._inj

        def __exit__(self, *exc: object) -> None:
            self._inj.uninstall()

    def on(self, pool: Any) -> "FaultInjector._On":
        """Context-manager form: ``with inj.on(pool): ...``."""
        return self._On(self, pool)

    # -- the dispatch seam ----------------------------------------------------

    def _decide(self, name: str) -> tuple[Optional[str], int]:
        """One decision per body execution, keyed on the per-name
        occurrence counter (the only mutable state, under a lock)."""
        with self._lock:
            occ = self._occ.get(name, 0)
            self._occ[name] = occ + 1
        kind: Optional[str] = None
        if self.fail_rate and _roll(self.seed, name, occ, "fail") < self.fail_rate:
            kind = "fail"
        elif self.delay_rate and _roll(self.seed, name, occ, "delay") < self.delay_rate:
            kind = "delay"
        elif self.kill_rate and _roll(self.seed, name, occ, "kill") < self.kill_rate:
            kind = "kill"
        if kind is not None:
            with self._lock:
                self._log.append((name, occ, kind))
        return kind, occ

    def _offload(self, task: Task, index: int) -> None:
        inner = self._inner
        if task._slow and (task.is_condition or task.takes_runtime):
            # control-flow bodies are never injected (module docs)
            if inner is not None:
                inner(task, index)
            else:
                task.run()
            return
        if self.match is not None and not self.match(task):
            kind = None
        else:
            kind, _occ = self._decide(task.name or repr(task))
        if kind == "fail":
            raise ChaosError(f"injected failure in {task.name!r}")
        if kind == "delay":
            time.sleep(self.delay_s)
        elif kind == "kill":
            self._kill(task, index)
        if inner is not None:
            inner(task, index)
        else:
            task.run()

    def _kill(self, task: Task, index: int) -> None:
        """Worker loss: real process kill on the process/socket backends
        (the body's dispatch then hits a dead transport), synthetic
        pre-start ``WorkerDiedError`` elsewhere — including socket slots
        bound to *remote* workers (``_procs[index] is None``), where there
        is no local process to kill — same §14 retry semantics every way."""
        from ..dist.process_pool import WorkerDiedError  # lazy: no dist dep

        pool = self._pool
        procs = getattr(pool, "_procs", None)
        if (
            procs is not None
            and index is not None
            and 0 <= index < len(procs)
            and procs[index] is not None
        ):
            try:
                procs[index].kill()
                procs[index].join()  # transport dead before dispatch: the
                return  # offload below deterministically fails pre-start
            except ValueError:  # the pool retired this process under us
                pass
        raise WorkerDiedError(
            f"injected worker loss before {task.name!r} started", started=False
        )

    # -- observability --------------------------------------------------------

    def schedule(self) -> list[tuple[str, int, str]]:
        """The injected-fault log: ``(task name, occurrence, kind)``,
        sorted by (name, occurrence). The *decisions* are deterministic
        per (seed, name, occurrence); the order workers reach them is not
        — sorting makes the schedule comparable across runs, backends and
        interleavings."""
        with self._lock:
            return sorted(self._log)

    def counts(self) -> dict[str, int]:
        """Injected-fault totals by kind."""
        out = {"fail": 0, "delay": 0, "kill": 0}
        for _name, _occ, kind in self.schedule():
            out[kind] += 1
        return out

    # observer protocol (§8): count the fault handling we provoked
    def on_submit(self, task: Task) -> None:  # pragma: no cover - no-op
        pass

    def on_start(self, task: Task, worker: int) -> None:  # pragma: no cover
        pass

    def on_finish(self, task: Task, worker: int) -> None:  # pragma: no cover
        pass

    def on_steal(self, task: Task, thief: int, victim: int) -> None:  # pragma: no cover
        pass

    def on_retry(self, task: Task, attempt: int, worker: int) -> None:
        self.retries += 1

    def on_timeout(self, task: Task, worker: int) -> None:
        self.timeouts += 1
