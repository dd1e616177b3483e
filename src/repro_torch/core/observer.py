"""Observer layer for the thread pool (DESIGN.md §8).

Taskflow-style executor observation: the pool exposes four lifecycle hooks
and calls every attached observer at each of them —

    on_submit(task)                 task entered a queue (inbox or deque)
    on_start(task, worker)          a worker began executing the task
    on_finish(task, worker)         the task completed (ran, failed or was
                                    skipped as cancelled/poisoned)
    on_steal(task, thief, victim)   `thief` took the task from `victim`'s
                                    deque (inbox drains are not steals)
    on_retry(task, attempt, worker) a §14 retry: the failed attempt was
                                    re-armed and re-scheduled (`attempt`
                                    counts failed attempts so far, 1-based)
    on_timeout(task, worker)        an attempt exceeded its `timeout=`
                                    deadline (cooperative checkpoint raise,
                                    or a §11 hard worker kill)

Hooks run on the pool's worker threads (``on_submit`` on the submitting
thread), so implementations must be cheap and thread-safe; the pool
swallows observer exceptions rather than letting telemetry poison the
runtime. Inline continuations (paper §2.2) never re-enter a queue, so they
produce start/finish events but no submit event — exactly the property the
Chrome trace makes visible as back-to-back slices on one worker lane.

Observation is strictly opt-in on the scheduler hot path (DESIGN.md §9):
with no observers attached every event site is a single falsy-list check,
including the fused fan-out in ``_execute`` (which fires ``on_submit`` for
each successor it pushes, but never for the inline continuation). Park and
wakeup activity is deliberately *not* an observer event — it is aggregate
state, exported through the ``parked``/``wakeups`` counters in
``ThreadPool.stats()``.

Two implementations ship here:

* :class:`StatsObserver` — aggregate counters and per-task-name timing;
* :class:`ChromeTraceObserver` — a ``chrome://tracing`` / Perfetto trace
  exporter ("trace event format" JSON: one complete ``X`` event per task
  execution on the worker's lane, instant events for steals).

A third lives with the §15 verifier:
:class:`repro_torch.analysis.races.RaceObserver` assigns vector clocks from
graph edges at ``on_start``/``on_finish`` — the runtime happens-before
witness that cross-checks the static race detector's report on a real
schedule. It is an ordinary :class:`PoolObserver`; the hooks above are
its entire contract.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Optional

from .task import Task

__all__ = ["PoolObserver", "StatsObserver", "ChromeTraceObserver"]


class PoolObserver:
    """No-op base class; subclass and override the hooks you need.

    Any object with these four methods works (the protocol is duck-typed);
    inheriting just saves writing the empty ones.
    """

    def on_submit(self, task: Task) -> None:  # noqa: B027 - intentional no-op
        pass

    def on_start(self, task: Task, worker: int) -> None:  # noqa: B027
        pass

    def on_finish(self, task: Task, worker: int) -> None:  # noqa: B027
        pass

    def on_steal(self, task: Task, thief: int, victim: int) -> None:  # noqa: B027
        pass

    def on_retry(self, task: Task, attempt: int, worker: int) -> None:  # noqa: B027
        pass

    def on_timeout(self, task: Task, worker: int) -> None:  # noqa: B027
        pass


class StatsObserver(PoolObserver):
    """Aggregate execution statistics.

    Counts submissions/starts/finishes/steals and accumulates wall time per
    task name (the prefix before ``:`` — so ``prefill:7`` and ``prefill:9``
    aggregate as ``prefill``). ``summary()`` returns a plain dict suitable
    for logging or JSON.

    Attach at pool construction or any time via ``add_observer``::

        >>> from repro_torch.core import StatsObserver, ThreadPool
        >>> stats = StatsObserver()
        >>> with ThreadPool(2, observers=[stats]) as pool:
        ...     pool.run(lambda: None)
        >>> stats.summary()["finished"]
        1
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._starts: dict[int, float] = {}
        self.submitted = 0
        self.started = 0
        self.finished = 0
        self.stolen = 0
        self.errors = 0
        self.retried = 0
        self.timed_out = 0
        self.by_name: dict[str, list] = {}  # name -> [count, total_seconds]

    def on_submit(self, task: Task) -> None:
        with self._lock:
            self.submitted += 1

    def on_start(self, task: Task, worker: int) -> None:
        now = time.perf_counter()
        with self._lock:
            self.started += 1
            self._starts[id(task)] = now

    def on_finish(self, task: Task, worker: int) -> None:
        now = time.perf_counter()
        with self._lock:
            self.finished += 1
            if task.exception is not None:
                self.errors += 1
            t0 = self._starts.pop(id(task), None)
            if t0 is not None:
                key = (task.name or "<anon>").split(":")[0]
                cell = self.by_name.setdefault(key, [0, 0.0])
                cell[0] += 1
                cell[1] += now - t0

    def on_steal(self, task: Task, thief: int, victim: int) -> None:
        with self._lock:
            self.stolen += 1

    def on_retry(self, task: Task, attempt: int, worker: int) -> None:
        with self._lock:
            self.retried += 1

    def on_timeout(self, task: Task, worker: int) -> None:
        with self._lock:
            self.timed_out += 1

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "started": self.started,
                "finished": self.finished,
                "stolen": self.stolen,
                "errors": self.errors,
                "retried": self.retried,
                "timed_out": self.timed_out,
                "by_name": {
                    k: {"count": c, "total_s": s, "mean_us": (s / c * 1e6 if c else 0.0)}
                    for k, (c, s) in sorted(self.by_name.items())
                },
            }


class ChromeTraceObserver(PoolObserver):
    """Export pool execution as Chrome trace-event JSON.

    Open the saved file in ``chrome://tracing`` or https://ui.perfetto.dev:
    one lane (``tid``) per worker, one complete event per task execution,
    instant events marking steals. Timestamps are microseconds relative to
    observer construction (the format's expected unit).
    """

    def __init__(self, pid: int = 1) -> None:
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._starts: dict[int, float] = {}
        self._events: list[dict[str, Any]] = []
        self.pid = pid

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def on_start(self, task: Task, worker: int) -> None:
        with self._lock:
            self._starts[id(task)] = time.perf_counter()

    def on_finish(self, task: Task, worker: int) -> None:
        now = time.perf_counter()
        with self._lock:
            t0 = self._starts.pop(id(task), now)
            ev: dict[str, Any] = {
                "name": task.name or "task",
                "cat": "task",
                "ph": "X",
                "ts": self._us(t0),
                "dur": max(0.0, (now - t0) * 1e6),
                "pid": self.pid,
                "tid": worker,
            }
            args: dict[str, Any] = {}
            if task.priority:
                args["priority"] = task.priority
            if task.cancelled:
                args["cancelled"] = True
            elif task.exception is not None:
                args["error"] = repr(task.exception)
            if args:
                ev["args"] = args
            self._events.append(ev)

    def on_steal(self, task: Task, thief: int, victim: int) -> None:
        with self._lock:
            self._events.append(
                {
                    "name": f"steal:{task.name or 'task'}",
                    "cat": "steal",
                    "ph": "i",
                    "s": "t",
                    "ts": self._us(time.perf_counter()),
                    "pid": self.pid,
                    "tid": thief,
                    "args": {"victim": victim},
                }
            )

    def on_retry(self, task: Task, attempt: int, worker: int) -> None:
        # the failed attempt produced no finish slice (the task is not done
        # yet) — the instant event marks it on the worker's lane instead
        now = time.perf_counter()
        with self._lock:
            t0 = self._starts.pop(id(task), now)
            self._events.append(
                {
                    "name": f"retry:{task.name or 'task'}",
                    "cat": "fault",
                    "ph": "X",
                    "ts": self._us(t0),
                    "dur": max(0.0, (now - t0) * 1e6),
                    "pid": self.pid,
                    "tid": worker,
                    "args": {"attempt": attempt},
                }
            )

    def on_timeout(self, task: Task, worker: int) -> None:
        with self._lock:
            self._events.append(
                {
                    "name": f"timeout:{task.name or 'task'}",
                    "cat": "fault",
                    "ph": "i",
                    "s": "t",
                    "ts": self._us(time.perf_counter()),
                    "pid": self.pid,
                    "tid": worker,
                }
            )

    def to_trace(self, num_workers: Optional[int] = None) -> dict[str, Any]:
        """The trace as a dict (``{"traceEvents": [...]}`` container)."""
        with self._lock:
            events = list(self._events)
        meta = []
        if num_workers is not None:
            for i in range(num_workers):
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": self.pid,
                        "tid": i,
                        "args": {"name": f"worker-{i}"},
                    }
                )
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def to_json(self, num_workers: Optional[int] = None) -> str:
        return json.dumps(self.to_trace(num_workers))

    def save(self, path: Any, num_workers: Optional[int] = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(num_workers))
