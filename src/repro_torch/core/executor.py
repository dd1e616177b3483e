"""Executor facade: the one front door to the task-graph runtime.

DESIGN.md §10. The low-level surface (``ThreadPool`` / ``TaskGraph`` /
``Task``) stays available — and everything here is a thin composition of
it — but consumers should talk to :class:`Executor`:

    with Executor(4) as ex:
        fut = ex.run(graph)            # any graph: DAG, condition-cyclic,
        fut.result()                   # subflow-spawning — one entry point
        ex.run_until(graph, converged) # re-run until a predicate holds
        await ex.co_run(graph)         # same, from asyncio

What the facade buys over raw ``ThreadPool``:

* **one submission path** — ``run`` accepts a ``TaskGraph``, a ``Task``, a
  bare callable or an iterable of tasks, always returns a
  :class:`~repro_torch.core.Future`, and picks the right completion protocol
  (hidden-sink for DAGs, counted for condition graphs) automatically;
* **control-flow loops** — ``run_until`` is the Python-side companion to
  in-graph condition cycles: re-submit a (reset) graph until ``predicate``
  says done, for convergence loops whose check lives outside the graph;
* **asyncio interop** — ``co_run`` plus ``Future.__await__`` let async
  servers await pool work without blocking their event loop;
* **lifecycle** — context-manager close, observer attachment, and a
  ``wait_idle`` that reports timeout as a ``bool`` (the §10 satellite
  contract) instead of mixing it with task failure.

Migration from the old call sites is mechanical (see README):

    pool.run(g)                 ->  ex.run(g).result()
    g.as_future(pool)           ->  ex.run(g)
    pool.submit_future(fn)      ->  ex.submit(fn)
    pool.wait_idle(t) + except  ->  if not ex.wait_idle(t): ...
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Union

from .baseline import SerialPool
from .graph import Runtime, TaskGraph
from .pool import Future, ThreadPool
from .task import RetryPolicy, Task

__all__ = ["Executor", "Runtime"]


class Executor:
    """Facade over an execution backend running task graphs.

    Parameters
    ----------
    num_threads:
        Worker count for an owned pool (``os.cpu_count()`` default, as in
        the paper): worker *threads* for the thread backend, worker
        *processes* for the process backend. Ignored for ``serial`` and
        when ``pool`` is given.
    backend:
        Which execution backend to own (DESIGN.md §11):

        * ``"thread"`` (default) — the paper's work-stealing
          :class:`ThreadPool`; best for IO/GIL-releasing bodies and
          minimum per-task overhead.
        * ``"process"`` and ``"socket"`` — the reference package's
          multi-process backends. Not ported yet: the port raises
          ``NotImplementedError`` (the multi-device slice carries them).
        * ``"serial"`` — :class:`~repro_torch.core.SerialPool`: everything on
          the calling thread; the zero-overhead floor and a
          deterministic debugging backend.

        Every graph kind — DAGs, condition loops, subflows, ``run_until``,
        the asyncio bridge — behaves identically on all four (the
        backend-parametrized conformance suite in ``tests/dist``
        enforces it).
    pool:
        Adopt an existing (possibly shared) pool instead of owning one;
        ``close()`` then leaves it running. Mutually exclusive with
        ``backend``.
    observers, name, deque_cls:
        Forwarded to the owned pool (see ``ThreadPool``).
    verify:
        Pre-submission static verification (DESIGN.md §15). Only ``"off"``
        is ported: ``"warn"`` and ``"strict"`` raise ``NotImplementedError``
        until the analysis slice ports the verifier. The default comes
        from the ``REPRO_VERIFY`` environment variable when set.
    backend_kwargs:
        Extra keyword arguments for the owned pool's constructor (e.g.
        ``mp_context="spawn"`` or ``arena_threshold=...`` for the process
        backend).

    Doctest — the backend is a constructor switch, not an API change::

        >>> from repro_torch.core import Executor, TaskGraph
        >>> for backend in ("serial", "thread"):
        ...     g = TaskGraph()
        ...     total = g.gather([g.add(lambda i=i: i * i) for i in range(4)])
        ...     with Executor(2, backend=backend) as ex:
        ...         _ = ex.run(g).result(10)
        ...     print(backend, sum(total.result))
        serial 14
        thread 14
    """

    def __init__(
        self,
        num_threads: Optional[int] = None,
        *,
        backend: Optional[str] = None,
        pool: Optional[Any] = None,
        observers: Sequence[Any] = (),
        name: str = "repro-executor",
        deque_cls: Optional[type] = None,
        verify: Optional[str] = None,
        **backend_kwargs: Any,
    ) -> None:
        if verify is None:
            verify = os.environ.get("REPRO_VERIFY", "off")
        if verify not in ("off", "warn", "strict"):
            raise ValueError(
                f"unknown verify mode {verify!r}; expected 'off', 'warn' or 'strict'"
            )
        if verify != "off":
            raise NotImplementedError(
                f"verify={verify!r} needs the graph verifier, which the port "
                "does not carry yet (the analysis slice ports it)"
            )
        if pool is not None:
            if backend is not None:
                raise ValueError("pass either backend= or pool=, not both")
            self.pool = pool
            if isinstance(pool, SerialPool):
                self.backend = "serial"
            elif hasattr(pool, "_caches"):  # dist.SocketPool (also has _procs)
                self.backend = "socket"
            elif hasattr(pool, "_procs"):  # dist.ProcessPool
                self.backend = "process"
            else:
                self.backend = "thread"
            self._own_pool = False
            for obs in observers:
                pool.add_observer(obs)
            return
        backend = backend or "thread"
        self.backend = backend
        if backend == "serial":
            self.pool = SerialPool(observers=observers)
        elif backend in ("thread", "process", "socket"):
            kwargs: dict[str, Any] = {"name": name, "observers": observers}
            if deque_cls is not None:
                kwargs["deque_cls"] = deque_cls
            kwargs.update(backend_kwargs)
            if backend == "thread":
                self.pool = ThreadPool(num_threads, **kwargs)
            else:
                raise NotImplementedError(
                    f"backend={backend!r} is not ported yet (the multi-device "
                    "slice carries the process and socket backends)"
                )
        else:
            raise ValueError(
                f"unknown backend {backend!r}; expected 'thread', 'process', "
                "'socket' or 'serial'"
            )
        self._own_pool = True

    # -- submission ------------------------------------------------------------

    @property
    def num_threads(self) -> int:
        return self.pool.num_threads

    def run(
        self,
        work: Union[TaskGraph, Task, Callable[[], Any], Iterable[Task]],
        *,
        priority: Optional[float] = None,
        replay: bool = True,
        retry: Optional[RetryPolicy] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Future:
        """Submit ``work`` and return a :class:`Future` for its completion.

        * ``TaskGraph`` — the whole graph; resolves to ``None`` on success,
          to the first task failure otherwise. Condition graphs use
          counted completion; plain DAGs keep the hidden-sink fast path.
        * ``Task`` — a single (possibly pre-wired) task; resolves to its
          ``result``.
        * callable — like ``submit_future``; resolves to the return value.
        * iterable of tasks — wrapped in an anonymous ``TaskGraph``.

        ``priority`` (when given) follows the ``ThreadPool.submit``
        contract everywhere: for graphs and iterables it overrides every
        member task that never chose an explicit band of its own.

        ``replay`` (graphs only, DESIGN.md §12): re-running an unchanged
        graph dispatches from its captured :class:`~repro_torch.core.ReplayPlan`
        — the first pass runs live and records, later passes skip the
        per-task countdown walk. Any structural change, divergent
        condition branch or cancellation falls back to live dispatch
        transparently; pass ``replay=False`` to force live dispatch.

        ``retry`` / ``timeout`` / ``idempotent`` (DESIGN.md §14, callable
        submissions only) wrap the callable in a task carrying that fault
        policy; graphs and pre-built tasks declare theirs per task at
        construction (``TaskGraph.add(..., retry=..., timeout=...)``).
        """
        if retry is not None or timeout is not None or idempotent:
            if not callable(work) or isinstance(work, (Task, TaskGraph)):
                raise ValueError(
                    "retry=/timeout=/idempotent= apply to callable submissions; "
                    "graphs and tasks declare fault policy per task "
                    "(TaskGraph.add / Task constructor)"
                )
            task = Task(work, retry=retry, timeout=timeout, idempotent=idempotent)
            task.propagate_errors = False
            return self.run(task, priority=priority)
        if isinstance(work, TaskGraph):
            if priority is not None:
                self._apply_priority(work.tasks, priority)
            return work.as_future(self.pool, replay=replay)
        if isinstance(work, Task):
            task = work
            fut = Future(canceller=task.cancel)
            prev_cb = task.on_done
            if getattr(prev_cb, "_executor_resolver", False):
                # re-running the same Task through the facade: unwind our
                # previous wrapper instead of chaining (and leaking) one
                # Future + closure per round
                prev_cb = prev_cb._wrapped

            def _resolve(t: Task) -> None:
                if prev_cb is not None:
                    prev_cb(t)
                if t.exception is not None:
                    fut.set_exception(t.exception)
                else:
                    fut.set_result(t.result)

            _resolve._executor_resolver = True  # type: ignore[attr-defined]
            _resolve._wrapped = prev_cb  # type: ignore[attr-defined]
            task.on_done = _resolve
            self.pool.submit(task, priority=priority)
            return fut
        if callable(work):
            return self.pool.submit_future(work, priority=priority or 0.0)
        tasks = list(work)
        if priority is not None:
            self._apply_priority(tasks, priority)
        # Re-running the same iterable: if the tasks already share one graph
        # that contains exactly them (e.g. the anonymous wrapper a previous
        # run() adopted them into), reuse it — its tracked sink membership
        # is what makes build-once/run-N futures resolve correctly.
        g0 = tasks[0].graph if tasks else None
        if g0 is not None and len(g0) == len(tasks) and all(t.graph is g0 for t in tasks):
            return g0.as_future(self.pool)
        g = TaskGraph("executor-run")
        g.adopt(*tasks)
        return g.as_future(self.pool)

    @staticmethod
    def _apply_priority(tasks: Sequence[Task], priority: float) -> None:
        """Override the band of every task that never chose one explicitly
        (same propagation rule as ``ThreadPool.submit(task, priority=)``)."""
        for t in tasks:
            if not t._explicit_pr:
                t.priority = priority

    def submit(
        self,
        fn: Callable[[], Any],
        *,
        priority: float = 0.0,
        retry: Optional[RetryPolicy] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Future:
        """Fire-and-collect a callable (alias of ``submit_future``); the
        §14 fault-policy keywords match :meth:`run`."""
        if retry is not None or timeout is not None or idempotent:
            return self.run(
                fn, priority=priority, retry=retry, timeout=timeout, idempotent=idempotent
            )
        return self.pool.submit_future(fn, priority=priority)

    def run_until(
        self,
        graph: TaskGraph,
        predicate: Callable[[], bool],
        *,
        max_rounds: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> int:
        """Re-run ``graph`` (reset between rounds) until ``predicate()``
        holds; returns the number of rounds executed (≥ 1, do-while).

        The in-graph alternative — a condition task closing a weak cycle —
        keeps the loop on the workers with zero resubmission cost; this is
        for convergence checks that must run on the caller's side.
        Raises ``TimeoutError`` past ``timeout`` (seconds, whole call) and
        ``RuntimeError`` if ``max_rounds`` rounds leave the predicate
        false.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        rounds = 0
        while True:
            if rounds:
                graph.reset()
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"run_until: timed out after {rounds} rounds")
            self.run(graph).result(remaining)
            rounds += 1
            if predicate():
                return rounds
            if max_rounds is not None and rounds >= max_rounds:
                raise RuntimeError(
                    f"run_until: predicate still false after {rounds} rounds"
                )

    # -- asyncio bridge ---------------------------------------------------------

    async def co_run(
        self,
        work: Union[TaskGraph, Task, Callable[[], Any], Iterable[Task]],
        *,
        priority: Optional[float] = None,
        replay: bool = True,
    ) -> Any:
        """``await executor.co_run(graph)``: submit from an event loop and
        await the result without blocking the loop (``Future.__await__``
        transfers completion via ``call_soon_threadsafe``)."""
        return await self.run(work, priority=priority, replay=replay)

    # -- lifecycle --------------------------------------------------------------

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """True once the pool quiesced; False on timeout (§10 satellite
        contract — task failures still raise, timeouts never do)."""
        return self.pool.wait_idle(timeout)

    def add_observer(self, observer: Any) -> None:
        self.pool.add_observer(observer)

    def remove_observer(self, observer: Any) -> None:
        self.pool.remove_observer(observer)

    def stats(self) -> dict[str, int]:
        return self.pool.stats()

    def close(self) -> None:
        """Close the owned pool (no-op on an adopted shared pool)."""
        if self._own_pool:
            self.pool.close()

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        own = "own" if self._own_pool else "shared"
        return f"Executor({self.pool.num_threads} workers, {self.backend} backend, {own} pool)"
