"""Baseline executors the paper's design is compared against.

The paper benchmarks its work-stealing pool against Taskflow (C++). Taskflow
is not available here, so EXPERIMENTS.md compares against the designs the
paper positions itself against in §1–2:

* :class:`NaiveThreadPool` — the "typical" pre-work-stealing design: a single
  mutex-protected global FIFO queue shared by all workers. Same Task-graph
  semantics (dependency counting), but every push/pop contends on one lock
  and there is no continuation passing — newly-ready successors are always
  re-queued.

* ``SerialExecutor`` — runs a task graph topologically on the calling thread;
  the zero-overhead floor for scheduling-overhead measurements.
"""
from __future__ import annotations

import threading
import time
from collections import deque as _pydeque
from typing import Any, Callable, Iterable, Optional, Sequence, Union

from .task import CancelledError, Task, TaskTimeoutError, iter_graph

__all__ = ["NaiveThreadPool", "SerialExecutor", "SerialPool"]


class NaiveThreadPool:
    """Single locked global queue, no stealing, no continuation passing."""

    def __init__(self, num_threads: Optional[int] = None) -> None:
        import os

        n = num_threads if num_threads is not None else (os.cpu_count() or 1)
        self._q: _pydeque[Task] = _pydeque()
        self._cond = threading.Condition()
        self._unfinished = 0
        self._stop = False
        self._first_error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._worker, name=f"naive-{i}", daemon=True)
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    def submit(self, work: Union[Task, Callable[[], Any], Iterable[Task]]) -> None:
        if isinstance(work, Task):
            self._push(work)
        elif callable(work):
            self._push(Task(work))
        else:
            tasks = list(work)
            graph = iter_graph(tasks)
            for t in graph:
                t.reset()
            for t in graph:
                if t.is_source:
                    self._push(t)

    def run(self, work: Union[Task, Callable[[], Any], Iterable[Task]]) -> None:
        self.submit(work)
        self.wait_idle()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """True once idle, False on timeout (matching ``ThreadPool``)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._unfinished == 0, timeout):
                return False
            err, self._first_error = self._first_error, None
        if err is not None:
            raise err
        return True

    def close(self) -> None:
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()

    def __enter__(self) -> "NaiveThreadPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- internals ------------------------------------------------------------

    def _push(self, task: Task) -> None:
        with self._cond:
            self._unfinished += 1
            self._q.append(task)
            self._cond.notify()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                task = self._q.popleft()
            try:
                task.run()
            except BaseException as exc:  # noqa: BLE001
                task.exception = exc
                if task.propagate_errors:
                    with self._cond:
                        if self._first_error is None:
                            self._first_error = exc
            if task.on_done is not None:
                try:
                    task.on_done(task)
                except BaseException:  # noqa: BLE001 - observer errors dropped
                    pass
            ready = [s for s in task.successors if s.decrement()]
            with self._cond:
                for s in ready:
                    self._unfinished += 1
                    self._q.append(s)
                if ready:
                    self._cond.notify_all()
                self._unfinished -= 1
                if self._unfinished == 0:
                    self._cond.notify_all()


class SerialExecutor:
    """Topological execution on the calling thread (overhead floor).

    Supports the §10 task kinds too — condition branches/loops and
    runtime-spawned subflows — so the serial floor exists for every
    benchmark shape. ``NaiveThreadPool`` deliberately does not: it models
    the pre-work-stealing static design the paper argues against.
    """

    def run(self, work: Union[Task, Callable[[], Any], Iterable[Task]]) -> None:
        from .graph import (  # deferred: baseline stays below graph.py
            Runtime,
            select_branch,
            splice_subflow,
        )

        if isinstance(work, Task):
            tasks = iter_graph([work])
        elif callable(work):
            Task(work).run()
            return
        else:
            tasks = iter_graph(list(work))
        has_cond = False
        for t in tasks:
            t.reset()
            if t.kind == "condition":
                has_cond = True
        stack = [t for t in tasks if t.is_source]
        while stack:
            t = stack.pop()
            rt = Runtime(t) if t.takes_runtime else None
            t.run(rt)
            if t.on_done is not None:
                try:
                    t.on_done(t)
                except BaseException:  # noqa: BLE001 - observer errors dropped
                    pass
            if has_cond:
                t.rearm()  # single-threaded: re-arm unconditionally
            if rt is not None and rt.sub.tasks and t.exception is None:
                sub, join = splice_subflow(t, rt.sub)  # shared join protocol
                t._spawned = sub
                roots = [s for s in sub if s.is_source]
                stack.extend(roots if roots else [join])
                continue
            if t.kind == "condition":
                branch = select_branch(t)  # shared §10 selection rule
                if branch is not None:
                    stack.append(branch)
                continue
            for s in t.successors:
                if s.decrement():
                    stack.append(s)

    def close(self) -> None:  # interface parity
        pass

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        return True

    def __enter__(self) -> "SerialExecutor":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


class SerialPool:
    """Pool-*protocol* adapter over in-thread topological execution.

    :class:`SerialExecutor` runs a graph; ``SerialPool`` additionally
    speaks the full :class:`~repro_torch.core.ThreadPool` surface the rest of
    the runtime composes against — ``submit`` / ``submit_future`` /
    ``wait_idle`` / counted submission / observers — which is what lets
    ``Executor(backend="serial")`` drive every graph kind (DAGs, condition
    loops, subflows, ``as_future`` completion) with zero threads. Futures
    returned through this pool are resolved by the time the submitting
    call returns.

    Unlike :class:`SerialExecutor` (which lets a body's exception escape
    ``run``), failures here follow the pool contract: the exception is
    recorded on the task, poisons the run when ``propagate_errors`` is
    set (pending bodies are skipped with :class:`CancelledError`, exactly
    like a poisoned thread pool), and is re-raised by :meth:`wait_idle` or
    delivered through the attached future.

    §14 fault tolerance holds serially too: a retriable failure re-runs
    the body inline after sleeping the policy's backoff, ``timeout=``
    deadlines fire at ``checkpoint()`` calls, and ``stats()`` reports the
    same ``retries`` / ``timeouts`` counters as the thread backends.
    """

    # §14 body-dispatch seam (same shape as ``ThreadPool._offload``): a
    # FaultInjector wraps it; None means "call the body directly".
    _offload: Optional[Callable[[Task, int], None]] = None

    def __init__(self, observers: Any = ()) -> None:
        self._observers: list[Any] = list(observers)
        self._first_error: Optional[BaseException] = None
        self._executed = 0
        self._retries = 0
        self._timeouts = 0
        self._stop = False

    # -- pool protocol ---------------------------------------------------------

    @property
    def num_threads(self) -> int:
        return 1

    def add_observer(self, observer: Any) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Any) -> None:
        try:
            self._observers.remove(observer)
        except ValueError:
            pass

    def _notify(self, method: str, *args: Any) -> None:
        for obs in self._observers:
            try:
                getattr(obs, method)(*args)
            except BaseException:  # noqa: BLE001 - telemetry never poisons the run
                pass

    def submit(
        self,
        work: Union[Task, Callable[[], Any], Iterable[Task]],
        *,
        priority: Optional[float] = None,
    ) -> None:
        """Run ``work`` to completion on the calling thread (priorities are
        irrelevant in a serial schedule and ignored)."""
        if isinstance(work, Task):
            # single-task contract parity: ThreadPool._schedule runs exactly
            # the given task (wired predecessors or not), then its fan-out
            self._run_stack([work])
        elif callable(work):
            self._run_graph([Task(work)])
        else:
            notify = getattr(work, "_notify_submitted", None)
            if notify is not None:
                notify()
            self._run_graph(iter_graph(list(work)))

    def submit_future(self, fn: Callable[[], Any], *, priority: float = 0.0):
        from .pool import Future  # deferred: baseline stays below pool.py

        task = Task(fn)
        task.propagate_errors = False
        fut = Future(canceller=task.cancel)

        def _resolve(t: Task) -> None:
            if t.exception is not None:
                fut.set_exception(t.exception)
            else:
                fut.set_result(t.result)

        task.on_done = _resolve
        self._run_graph([task])
        return fut

    def _submit_with_context(self, tasks: Sequence[Task], ctx: Any) -> bool:
        """Counted-completion shim: the graph runs synchronously, then one
        +1/−1 pulse drains the context and fires its completion callback."""
        graph = iter_graph(list(tasks))
        if not graph:
            return False
        self._run_graph(graph)
        ctx.update(1)
        ctx.update(-1)
        return True

    def run(self, work: Union[Task, Callable[[], Any], Iterable[Task]]) -> None:
        self.submit(work)
        self.wait_idle()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        err, self._first_error = self._first_error, None
        if err is not None:
            raise err
        return True

    def stats(self) -> dict[str, int]:
        """`ThreadPool.stats` shape: ``executed`` counts real task
        executions; steals/parks/wakeups are structurally zero serially."""
        return {
            "executed": self._executed,
            "steals": 0,
            "parked": 0,
            "wakeups": 0,
            "retries": self._retries,
            "timeouts": self._timeouts,
        }

    def close(self) -> None:
        self._stop = True

    def __enter__(self) -> "SerialPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- execution ------------------------------------------------------------

    def _run_graph(self, tasks: list) -> None:
        """Graph-submission path: reset, arm condition members, run from
        the sources (mirrors ``ThreadPool.submit``'s iterable branch)."""
        has_cond = False
        for t in tasks:
            t.reset()
            if t.kind == "condition":
                has_cond = True
        if has_cond:
            for t in tasks:
                t.auto_rearm = True
        stack = [t for t in tasks if t.is_source]
        if not stack and tasks:
            raise ValueError("task graph has no sources (dependency cycle?)")
        self._run_stack(stack)

    def _run_stack(self, stack: list) -> None:
        from .graph import Runtime, select_branch, splice_subflow
        from .pool import _current  # §14 checkpoint state (deferred import)

        while stack:
            t = stack.pop()
            rt: Any = None
            while True:  # §14 retries happen inline — there is one thread
                if self._observers:
                    # §8 ledger parity with ThreadPool: one on_start per
                    # *attempt* (a retry re-dispatches there). on_submit
                    # stays structurally zero — it is a queue-push event,
                    # and the serial baseline has no queue (same rule as
                    # inline continuations on the thread backend).
                    self._notify("on_start", t, 0)
                _current.task = t
                _current.deadline = (
                    None if t.timeout is None else time.monotonic() + t.timeout
                )
                try:
                    if self._first_error is not None and t.propagate_errors:
                        t.exception = CancelledError("predecessor failed")
                        t._done = True  # noqa: SLF001 - pool-side protocol
                    elif t.takes_runtime:
                        rt = Runtime(t)  # fresh per attempt: no stale spawns
                        t._spawned = rt.sub.tasks
                        t.run(rt)
                    elif self._offload is not None:
                        self._offload(t, 0)
                    else:
                        t.run()
                except BaseException as exc:  # noqa: BLE001 - recorded, raised in wait
                    if isinstance(exc, TaskTimeoutError):
                        self._timeouts += 1
                        if self._observers:
                            self._notify("on_timeout", t, 0)
                    pol = t.retry_policy
                    if (
                        pol is not None
                        and pol.matches(exc)
                        and not (getattr(exc, "started", False) and not t.idempotent)
                        and t._attempt + 1 < pol.max_attempts
                    ):
                        t._attempt += 1
                        if exc.__context__ is None and t._last_exc is not None:
                            exc.__context__ = t._last_exc
                        t._last_exc = exc
                        t._claim[:] = (0,)
                        t._started = False
                        t._timed_out = False
                        t.exception = None
                        self._retries += 1
                        if self._observers:
                            self._notify("on_retry", t, t._attempt, 0)
                        delay = pol.delay(t._attempt)
                        if delay > 0:
                            time.sleep(delay)
                        continue
                    if (
                        t._last_exc is not None
                        and exc.__context__ is None
                        and exc is not t._last_exc
                    ):
                        exc.__context__ = t._last_exc
                    t.exception = exc
                    if t.propagate_errors and self._first_error is None:
                        self._first_error = exc
                break
            self._executed += 1
            if self._observers:
                self._notify("on_finish", t, 0)
            if t.on_done is not None:
                try:
                    t.on_done(t)
                except BaseException:  # noqa: BLE001 - callback errors dropped
                    pass
            if t.auto_rearm:
                t.rearm()
            if rt is not None and rt.sub.tasks and t.exception is None:
                sub, join = splice_subflow(t, rt.sub)
                if not t.propagate_errors:
                    for st in sub + [join]:
                        st.propagate_errors = False
                t._spawned = sub
                roots = [s for s in sub if s.is_source]
                stack.extend(roots if roots else [join])
                continue
            if t.kind == "condition":
                branch = select_branch(t)
                if branch is not None:
                    stack.append(branch)
                continue
            for s in t.successors:
                if s.decrement():
                    stack.append(s)
        # the serial pool borrows the *caller's* thread: leave no dangling
        # checkpoint state behind for code running after the submission
        _current.task = None
