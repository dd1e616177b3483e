"""Work-stealing thread pool capable of running task graphs (paper §2).

Faithful Python adaptation of the paper's C++ design:

* one work-stealing deque per worker thread (``deque.py``);
* the current worker's deque is found through a **thread-local** variable
  (the paper's replacement for thread-ID→index maps, §2.1);
* a task submitted *from* a worker thread is pushed to that worker's own
  deque (depth-first, cache-friendly); tasks submitted from outside land in a
  shared MPMC inbox (Chase-Lev deques are single-producer — see deque.py);
* idle workers first pop their own deque, then drain the inbox, then sweep
  the other workers' deques stealing from the top, then park;
* task-graph execution by dependency counting (§2.2): when a task body
  completes, every successor's pending-predecessor counter is decremented;
  **one** newly-ready successor is executed inline on the same worker
  (continuation passing), the others are pushed.

Beyond the paper (DESIGN.md §3): task **priorities** — own-deque pops, inbox
draining, steals and the inline-continuation pick are all priority-aware
(highest band first; LIFO within a band on the owner's side, FIFO on the
thief/inbox side), the same ready-key the schedule simulator uses — and
**cooperative cancellation** surfaced through :class:`Future` and
``TaskGraph.as_future``. Both exist for the serving engine: decode ticks run
at high priority, speculative prefills at low priority, and aborted requests
cancel their in-flight work.

Also beyond the paper (DESIGN.md §8): an **observer layer**. Attached
observers (``core/observer.py``) see submit/start/finish/steal lifecycle
events, which is how the aggregate-stats and Chrome-trace exporters watch a
run without the pool knowing about either.

**Hot-path discipline (DESIGN.md §9).** The task path takes no locks:

* *idle accounting* is GIL-atomic per-worker claimed/completed cells summed
  only when an idle check is actually needed — ``wait_idle`` waiters pay
  for quiescence detection, the task path pays one falsy flag check;
* *wakeups are targeted*: idle workers spin briefly then park on a
  per-worker event after registering in a parked-worker deque; a submitter
  pops **one** sleeper and sets its event (no condition-variable notify
  storm, no poll tax), woken workers chain further wakeups while surplus
  work remains, and ``close()`` sets every event so shutdown is prompt;
* *fan-out is allocation-free*: a fused decrement-and-pick loop over
  ``task.successors`` keeps the running max-priority successor as the
  inline continuation and pushes the rest directly onto the worker's own
  deque — no ready list, no ``max(..., key=...)``, one batch wakeup.

**Control flow (DESIGN.md §10).** Condition tasks, weak-edge cycles, and
runtime-spawned subflows dispatch through a *slow fan-out* path selected by
one per-task flag check (``task._slow``); plain DAG tasks keep the fused
§9 loop untouched. Slow-path tasks re-arm themselves **before** releasing
any successor (so a weak back-edge can legally re-trigger them), a
condition's integer result picks exactly one weak successor, a spawner's
subflow is spliced in behind a hidden join task that inherits the
spawner's successors, and a per-run :class:`RunContext` counts in-flight
tasks so graphs whose branches never run (or that loop) still terminate
their futures deterministically.

**Fault tolerance (DESIGN.md §14).** A task carrying a
:class:`~repro_torch.core.RetryPolicy` whose body fails with a matching exception
is re-armed and re-scheduled through the same §9 fast path — backoff is a
pool-timed deferred requeue on a lazy timer thread, so no worker ever
sleeps it off. Per-task ``timeout=`` deadlines are cooperative here
(bodies observe them at :func:`checkpoint`); ``ProcessPool`` escalates to
a hard worker kill. Retried-then-succeeded passes never poison the pool
(``_first_error``) or diverge a §12 replay plan — only the *final* failure
surfaces, carrying earlier attempts on its ``__context__`` chain.

Differences from the C++ original are documented in DESIGN.md §2.1.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque as _pydeque
from typing import Any, Callable, Iterable, Optional, Sequence, Union

from .deque import EMPTY, ChaseLevDeque, FastDeque, PriorityDeque
from .graph import Runtime, select_branch, splice_subflow
from .task import CancelledError, Task, TaskTimeoutError, iter_graph

__all__ = ["ThreadPool", "Future", "RunContext", "checkpoint"]

_SPIN_SWEEPS = 2  # extra full sweeps (with GIL yields) before parking
_PARK_BACKSTOP_S = 0.5  # safety net only; targeted wakeups are the fast path

# Cooperative checkpoint state: the executing worker publishes its current
# task (and the attempt's absolute deadline) here around every body call,
# on every backend. Two plain stores — no tuple allocation on the hot path.
_current = threading.local()


def checkpoint() -> None:
    """Cooperative cancellation / timeout checkpoint (DESIGN.md §14).

    Long-running task bodies call this periodically. It raises
    :class:`~repro_torch.core.CancelledError` if the task was cancelled after it
    started, and :class:`~repro_torch.core.TaskTimeoutError` once the attempt's
    ``timeout=`` deadline has passed. Outside a task body (or inside a
    ``ProcessPool`` worker process, where the parent-side deadline is not
    visible) it is a no-op — bodies stay portable across backends.
    """
    task = getattr(_current, "task", None)
    if task is None:
        return
    if task._cancel_req:
        raise CancelledError(f"task {task.name!r} cancelled at checkpoint")
    deadline = _current.deadline
    if deadline is not None and time.monotonic() >= deadline:
        task._timed_out = True
        raise TaskTimeoutError(
            f"task {task.name!r} exceeded its {task.timeout}s timeout"
        )


class _Retry(BaseException):
    """Internal §14 signal: a §12 segment member failed retriably; the
    segment has re-armed itself (``_resume_at`` set) and must be requeued
    after ``delay`` seconds. ``BaseException`` so body-level ``except
    Exception`` handlers can never swallow it."""

    __slots__ = ("delay",)

    def __init__(self, delay: float) -> None:
        self.delay = delay


class _Timer:
    """Lazy pool timer: one daemon thread draining a monotonic-deadline heap.

    Serves both §14 uses — deferred retry requeues (backoff without a
    sleeping worker) and hard-timeout watchdog callbacks (``ProcessPool``).
    Created on first use, so pools that never retry or time out pay
    nothing. Entries are ``(when, seq, fn)``; cancellation is lazy — an
    expired callback re-checks whether its target is still relevant.
    """

    def __init__(self, name: str) -> None:
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-timer", daemon=True
        )
        self._thread.start()

    def add(self, when: float, fn: Callable[[], None]) -> None:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (when, self._seq, fn))
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stop:
                    if self._heap:
                        delay = self._heap[0][0] - time.monotonic()
                        if delay <= 0:
                            break
                        self._cv.wait(delay)
                    else:
                        self._cv.wait()
                if self._stop:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except BaseException:  # noqa: BLE001 - timer callbacks never die
                pass


class RunContext:
    """Counted completion for one graph run (DESIGN.md §10).

    ``active`` is the number of scheduled-but-unfinished tasks of the run.
    A submitter counts every root *before* scheduling any of them; a worker
    finishing a task folds its whole fan-out into one ``update(delta)``
    with ``delta = successors_scheduled - 1`` — and crucially applies it
    *before* pushing those successors, so a successor completing on
    another worker can never observe a transiently-zero count. The caller
    that drains ``active`` to zero fires ``on_quiet`` exactly once.

    Only counted runs (condition graphs, executor-managed submissions) pay
    this lock; the plain DAG path never allocates a context.
    """

    __slots__ = ("_lock", "_active", "_on_quiet", "_fired")

    def __init__(self, on_quiet: Callable[[], None]) -> None:
        self._lock = threading.Lock()
        self._active = 0
        self._on_quiet = on_quiet
        self._fired = False

    def update(self, delta: int) -> None:
        with self._lock:
            self._active += delta
            fire = self._active == 0 and not self._fired
            if fire:
                self._fired = True
        if fire:
            try:
                self._on_quiet()
            except BaseException:  # noqa: BLE001 - completion cb never poisons a worker
                pass


class Future:
    """Completion handle: result/exception delivery plus cooperative cancel.

    ``canceller`` (when attached by ``submit_future`` / ``as_future``) is a
    nullary callable returning True if the underlying work was prevented
    from starting. A bare ``Future()`` has no producer to stop, so
    :meth:`cancel` simply resolves it with :class:`CancelledError`.
    Resolution is first-write-wins: a producer completing after a successful
    cancel is ignored.

    Futures bridge into ``asyncio``: ``await fut`` works inside any running
    event loop (:meth:`__await__` hands completion over via
    ``call_soon_threadsafe``), which is what ``Executor.co_run`` and
    ``ServeEngine.submit_async`` build on (DESIGN.md §10).

    Producer/consumer protocol in one glance::

        >>> from repro_torch.core import Future
        >>> fut = Future()
        >>> fut.done()
        False
        >>> fut.set_result("ready")    # producer side, first write wins
        >>> fut.set_result("ignored")
        >>> fut.result(timeout=0)      # consumer side
        'ready'
    """

    __slots__ = (
        "_event",
        "_result",
        "_exception",
        "_lock",
        "_canceller",
        "_cancelled",
        "_callbacks",
    )

    def __init__(self, canceller: Optional[Callable[[], bool]] = None) -> None:
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._canceller = canceller
        self._cancelled = False
        self._callbacks: list[Callable[["Future"], None]] = []

    def _drain_callbacks(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except BaseException:  # noqa: BLE001 - callback errors are dropped
                pass

    def add_done_callback(self, fn: Callable[["Future"], None]) -> None:
        """Run ``fn(self)`` once the future resolves (immediately if it
        already has). Callbacks fire on the resolving thread."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except BaseException:  # noqa: BLE001 - callback errors are dropped
            pass

    def set_result(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = value
            self._event.set()
        self._drain_callbacks()

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exception = exc
            self._event.set()
        self._drain_callbacks()

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Try to cancel. True iff the body was prevented from running.

        Already-completed futures and tasks that already started return
        False (cooperative semantics: a running body is never interrupted).
        The canceller's verdict is authoritative: if it won, this returns
        True even when the skipped task's completion callback resolved the
        future (with CancelledError) concurrently.
        """
        with self._lock:
            if self._event.is_set() and not self._cancelled:
                return False
        if self._canceller is not None:
            if not self._canceller():
                return False
            with self._lock:
                self._cancelled = True
                if not self._event.is_set():
                    self._exception = CancelledError("future cancelled")
                    self._event.set()
            self._drain_callbacks()
            return True
        with self._lock:
            if self._event.is_set():
                return self._cancelled
            self._cancelled = True
            self._exception = CancelledError("future cancelled")
            self._event.set()
        self._drain_callbacks()
        return True

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("future not completed within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result

    def __await__(self):
        """Awaitable bridge: ``await fut`` inside a running asyncio loop.

        Completion is transferred onto the loop with
        ``call_soon_threadsafe`` from whichever worker thread resolves the
        future — the event loop never blocks on the pool.
        """
        import asyncio  # deferred: the pool itself never needs asyncio

        if self._event.is_set():
            if self._exception is not None:
                raise self._exception
            return self._result
        loop = asyncio.get_running_loop()
        afut: "asyncio.Future" = loop.create_future()

        def _transfer(f: "Future") -> None:
            def _apply() -> None:
                if afut.done():
                    return
                if f._exception is not None:
                    afut.set_exception(f._exception)
                else:
                    afut.set_result(f._result)

            try:
                loop.call_soon_threadsafe(_apply)
            except RuntimeError:  # loop already closed; nothing to deliver to
                pass

        self.add_done_callback(_transfer)
        return (yield from afut)


class ThreadPool:
    """Work-stealing thread pool running async tasks and task graphs.

    Parameters
    ----------
    num_threads:
        Worker count; defaults to ``os.cpu_count()`` — the analogue of the
        paper's ``std::thread::hardware_concurrency()`` default.
    deque_cls:
        ``FastDeque`` (default, GIL-atomic / fence-free analogue) or
        ``ChaseLevDeque`` (faithful structural port; used in tests). Each
        worker's deque and the shared inbox are priority-banded instances
        of this class (``PriorityDeque``); with only priority 0.0 in play
        they stay on the single-band fast path (DESIGN.md §9).
    observers:
        Initial observers (``core/observer.py`` protocol: on_submit /
        on_start / on_finish / on_steal). With no observers attached the
        hot path pays one falsy-list check per event site.

    Concurrency notes (DESIGN.md §9): worker ``i`` is the only writer of
    cell ``i`` in every counter list; cell ``n`` (external threads) is
    guarded by ``_ext_lock``. ``_outstanding()`` reads the completed cells
    *before* the claimed cells, so a zero result proves quiescence — every
    completion counted implies its claim was counted too.

    The paper's usage shape — submit async work and graphs, wait, close::

        >>> from repro_torch.core import Task, ThreadPool
        >>> with ThreadPool(2) as pool:
        ...     fut = pool.submit_future(lambda: 6 * 7)
        ...     head = Task(lambda: 10)
        ...     tail = Task(lambda x: x + 1, takes_inputs=True).succeed(head)
        ...     pool.submit([head, tail])
        ...     _ = pool.wait_idle(10)
        >>> fut.result(10), tail.result
        (42, 11)
    """

    def __init__(
        self,
        num_threads: Optional[int] = None,
        *,
        deque_cls: type = FastDeque,
        name: str = "repro-pool",
        observers: Sequence[Any] = (),
    ) -> None:
        n = num_threads if num_threads is not None else (os.cpu_count() or 1)
        if n < 1:
            raise ValueError("num_threads must be >= 1")
        self._deques = [PriorityDeque(deque_cls) for _ in range(n)]
        self._inbox = PriorityDeque(FastDeque)  # MPMC under the GIL
        self._tls = threading.local()
        self._stop = False
        # -- idle accounting: per-worker cells, slot n for external threads.
        self._claimed = [0] * (n + 1)  # tasks claimed (queued or inlined)
        self._completed = [0] * (n + 1)  # tasks fully processed
        self._ext_lock = threading.Lock()  # serializes slot-n increments
        # -- quiescence protocol: waiters register; the worker that drives
        # the outstanding count to zero notifies. Zero cost with no waiters.
        self._idle_cond = threading.Condition()
        self._idle_waiters = 0
        # -- error funnel (cold path)
        self._err_lock = threading.Lock()
        self._first_error: Optional[BaseException] = None
        # -- parked-worker registry: indices of sleeping workers; a
        # submitter pops one and sets its event (targeted wakeup).
        self._parked: _pydeque[int] = _pydeque()
        self._events = [threading.Event() for _ in range(n)]
        # -- process-backend seams (DESIGN.md §11). Both stay None on a
        # plain ThreadPool, so the thread backend pays one falsy check per
        # submission (`_wire_tasks`) and per executed body (`_offload`).
        # ``ProcessPool`` (repro.dist) binds them: `_wire_tasks` serializes
        # eligible bodies at submit, `_offload` ships a wired body to a
        # worker process instead of calling it in-thread.
        self._wire_tasks: Optional[Callable[..., None]] = None
        self._offload: Optional[Callable[[Task, int], None]] = None
        # -- per-worker statistic cells (slot n: non-worker threads)
        self._executed = [0] * (n + 1)
        self._steals = [0] * (n + 1)
        self._parked_ct = [0] * (n + 1)
        self._wakeups = [0] * (n + 1)
        # -- §14 fault tolerance: retry/timeout cells plus the lazy timer
        # (deferred requeues + watchdog); ProcessPool binds `_hard_timeout`.
        self._retries = [0] * (n + 1)
        self._timeouts = [0] * (n + 1)
        self._timer: Optional[_Timer] = None
        self._name = name
        self._observers: list[Any] = list(observers)
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), name=f"{name}-{i}", daemon=True)
            for i in range(n)
        ]
        for t in self._threads:
            t.start()

    # -- public API -----------------------------------------------------------

    @property
    def num_threads(self) -> int:
        return len(self._deques)

    def add_observer(self, observer: Any) -> None:
        """Attach a lifecycle observer (``core/observer.py`` protocol).

        Attach/detach are not synchronized against in-flight events: an
        observer attached mid-run may miss events already dispatched, which
        is fine for telemetry.
        """
        self._observers.append(observer)

    def remove_observer(self, observer: Any) -> None:
        """Detach a previously attached observer (no-op if absent)."""
        try:
            self._observers.remove(observer)
        except ValueError:
            pass

    def _notify(self, method: str, *args: Any) -> None:
        for obs in self._observers:
            try:
                getattr(obs, method)(*args)
            except BaseException:  # noqa: BLE001 - telemetry never poisons the pool
                pass

    def submit(
        self,
        work: Union[Task, Callable[[], Any], Iterable[Task]],
        *,
        priority: Optional[float] = None,
    ) -> None:
        """Submit a callable, a single Task, or a task graph (iterable).

        Graph submission mirrors the paper: counters of every task reachable
        from the collection are re-armed, then all sources (tasks with no
        in-edges of either strength) are scheduled. ``priority`` (when
        given) overrides the priority of a callable/single-task submission
        *and* propagates to reachable continuation tasks that never chose
        an explicit priority of their own — a prioritized chain no longer
        silently falls back to band 0.0 past its first task. Graph
        (iterable) submissions keep per-task priorities.
        """
        if isinstance(work, Task):
            if priority is not None or self._wire_tasks is not None:
                graph = iter_graph([work])  # one traversal serves both steps
                if priority is not None:
                    for t in graph:
                        if t is work or not t._explicit_pr:
                            t.priority = priority
                if self._wire_tasks is not None:
                    self._wire_tasks(graph)
            self._schedule(work)
        elif callable(work):
            task = Task(work, priority=priority)
            if self._wire_tasks is not None:
                self._wire_tasks((task,))
            self._schedule(task)
        else:
            notify = getattr(work, "_notify_submitted", None)
            if notify is not None:  # a TaskGraph: run_count + §12 replay
                plan = work._usable_plan(self)
                if plan is not None:
                    # replay (DESIGN.md §12): plan re-arm folds reset() in,
                    # pre-bound roots replace source discovery; completion
                    # is wait_idle-observable exactly like live dispatch.
                    notify()
                    fin = work._fin
                    if fin is not None:
                        fin.on_done = None  # no future this round: stale
                        # as_future resolvers must not fire on old futures
                    plan.rearm()
                    plan.schedule(self)
                    return
                notify()
            tasks = list(work)
            graph = iter_graph(tasks)
            has_cond = False
            for t in graph:
                t.reset()
                if t._slow:  # recompute: a prior counted/condition run may linger
                    t.ctx = None
                    t.auto_rearm = False
                    t._slow = t.kind == "condition" or t.takes_runtime
                if t.kind == "condition":
                    has_cond = True
            if has_cond:
                # every member of a condition graph re-arms after running,
                # so weak back-edges can re-trigger it within this run
                for t in graph:
                    t.auto_rearm = True
                    t._slow = True
            if self._wire_tasks is not None:
                self._wire_tasks(graph)
            roots = [t for t in graph if t.is_source]
            if not roots and graph:
                raise ValueError("task graph has no sources (dependency cycle?)")
            for t in roots:
                self._schedule(t)

    # paper-style alias
    Submit = submit

    def submit_future(self, fn: Callable[[], Any], *, priority: float = 0.0) -> Future:
        """Submit a callable and get a :class:`Future` for its result.

        The future supports cooperative :meth:`Future.cancel`; exceptions
        from ``fn`` are delivered via the future only and do not poison the
        pool.
        """
        task = Task(fn, priority=priority)
        task.propagate_errors = False
        fut = Future(canceller=task.cancel)

        def _resolve(t: Task) -> None:
            if t.exception is not None:
                fut.set_exception(t.exception)
            else:
                fut.set_result(t.result)

        task.on_done = _resolve
        if self._wire_tasks is not None:
            self._wire_tasks((task,))
        self._schedule(task)
        return fut

    def _submit_with_context(self, tasks: Sequence[Task], ctx: RunContext) -> bool:
        """Submit a graph under counted completion (DESIGN.md §10).

        Every reachable task is reset, attached to ``ctx`` and routed
        through the slow fan-out; condition membership additionally arms
        the whole graph for weak re-triggering. All sources are counted
        into the context *before* the first one is scheduled, so an early
        completion can never drain the count to zero mid-submission.
        Returns False when there is nothing to schedule (the caller
        resolves the run itself).
        """
        graph = iter_graph(list(tasks))
        has_cond = False
        for t in graph:
            t.reset()
            t.ctx = ctx
            t._slow = True
            t.auto_rearm = False
            if t.kind == "condition":
                has_cond = True
        if has_cond:
            for t in graph:
                t.auto_rearm = True
        if self._wire_tasks is not None:
            self._wire_tasks(graph)
        roots = [t for t in graph if t.is_source]
        if not roots:
            if graph:
                raise ValueError("task graph has no sources (dependency cycle?)")
            return False
        ctx.update(len(roots))
        for t in roots:
            self._schedule(t)
        return True

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every claimed task has completed.

        Returns True once idle; **False on timeout** (the pool is still
        busy) — callers that must not proceed on a non-quiescent pool
        raise their own ``TimeoutError`` (``CheckpointManager.wait``,
        ``Executor.wait_idle`` callers). Pre-§10 this raised from here,
        which made "timed out" and "a task failed" the same control path;
        now only a genuine task failure raises: once idle, the first task
        exception (if any) is re-raised and cleared. On timeout the error
        marker is left in place for the eventual successful wait.

        Waiters register on ``_idle_cond`` so the task path can skip the
        quiescence check entirely while nobody is waiting (DESIGN.md §9).
        """
        with self._idle_cond:
            self._idle_waiters += 1
            try:
                if not self._idle_cond.wait_for(lambda: self._outstanding() == 0, timeout):
                    return False
            finally:
                self._idle_waiters -= 1
        with self._err_lock:
            err, self._first_error = self._first_error, None
        if err is not None:
            raise err
        return True

    def run(self, work: Union[Task, Callable[[], Any], Iterable[Task]]) -> None:
        """``submit`` + ``wait_idle`` convenience."""
        self.submit(work)
        self.wait_idle()

    def close(self) -> None:
        """Stop the workers (idempotent). Pending tasks are abandoned.

        Every parked worker is woken through its event, so close returns
        after at most the in-flight task bodies — no park-tick wait.
        """
        if self._stop:
            return
        self._stop = True
        for ev in self._events:
            ev.set()
        for t in self._threads:
            t.join()
        timer = self._timer
        if timer is not None:
            timer.close()

    def stats(self) -> dict[str, Any]:
        """Execution statistics, summed over the per-worker counters.

        Each worker increments only its own cell, so reads race at worst
        with a single in-flight increment per cell — the sum is exact for
        any quiesced pool and monotonically consistent for a live one.
        ``parked`` counts park events (a worker going to sleep); ``wakeups``
        counts targeted wakeups issued by submitters and the wake chain.
        ``band_depths`` sums the per-band queue depth across the inbox and
        every worker deque (DESIGN.md §13): on a prioritized workload it
        shows where waiting work sits — e.g. near-deadline prefills piling
        up in their promoted band while decode drains band 1.0 first.
        §14 adds ``retries`` (re-scheduled failed attempts, including §12
        segment members) and ``timeouts`` (attempts that exceeded their
        ``timeout=`` deadline).
        """
        depths: dict[float, int] = {}
        for dq in (self._inbox, *self._deques):
            for pr, n in dq.depths().items():
                depths[pr] = depths.get(pr, 0) + n
        return {
            "executed": sum(self._executed),
            "steals": sum(self._steals),
            "parked": sum(self._parked_ct),
            "wakeups": sum(self._wakeups),
            "retries": sum(self._retries),
            "timeouts": sum(self._timeouts),
            "band_depths": dict(sorted(depths.items(), reverse=True)),
        }

    def __enter__(self) -> "ThreadPool":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - interpreter shutdown path
        try:
            self.close()
        except Exception:
            pass

    # -- fault tolerance (DESIGN.md §14) ----------------------------------------

    # Hard-timeout escalation hook: None on thread/serial backends (the
    # deadline is cooperative — `checkpoint()`); ProcessPool overrides with
    # a kill-the-stuck-worker callback registered on the pool timer.
    _hard_timeout: Optional[Callable[..., None]] = None

    def _timer_get(self) -> _Timer:
        """The pool's lazy timer thread (created on first §14 use)."""
        timer = self._timer
        if timer is None:
            with self._ext_lock:
                timer = self._timer
                if timer is None:
                    timer = self._timer = _Timer(self._name)
        return timer

    def _retry_policy_for(self, task: Task, exc: BaseException) -> Any:
        """The policy governing this failure, or None (no retry).

        Base pools consult only the task's own :class:`RetryPolicy`;
        ``ProcessPool`` also supplies an implicit single retry for
        transport-level worker loss (DESIGN.md §11/§14).
        """
        pol = task.retry_policy
        if pol is not None and pol.matches(exc):
            return pol
        return None

    def _maybe_retry(self, task: Task, exc: BaseException, index: int) -> bool:
        """Re-arm and re-schedule a retriable failed attempt.

        Returns True when a retry was scheduled (the failure must not
        surface). The retry instance is *claimed before* the failed
        attempt's completion cell is bumped, so ``_outstanding()`` can
        never transiently hit zero while a backoff is pending — waiters
        stay blocked until the retried task truly completes.

        At-most-once gate: an exception flagged ``started=True`` (the body
        began executing and was lost — ``WorkerDiedError`` from a §11 hard
        kill) is retried only for ``idempotent`` tasks.
        """
        pol = self._retry_policy_for(task, exc)
        if pol is None:
            return False
        if getattr(exc, "started", False) and not task.idempotent:
            return False
        attempt = task._attempt + 1
        if attempt >= pol.max_attempts:
            return False
        task._attempt = attempt
        if exc.__context__ is None and task._last_exc is not None:
            exc.__context__ = task._last_exc  # chain attempt N-1 behind N
        task._last_exc = exc
        # re-arm just this task: claim refilled, started cleared so a
        # cancel() landing between attempts wins the refilled claim and
        # the requeued dispatch skips the body.
        task._claim[:] = (0,)
        task._started = False
        task._timed_out = False
        task.exception = None
        self._retries[index] += 1
        if self._observers:
            self._notify("on_retry", task.first if task._seg else task, attempt, index)
        self._requeue(task, pol.delay(attempt), index)
        return True

    def _requeue(self, task: Task, delay: float, index: int) -> None:
        """Schedule an already-claimed retry: now (own deque) or deferred
        through the pool timer — no worker sleeps off the backoff."""
        self._claimed[index] += 1
        if delay <= 0:
            if self._observers:
                self._notify("on_submit", task.first if task._seg else task)
            self._deques[index].push(task)
            if self._parked:
                self._wake_one(index)
        else:
            self._timer_get().add(
                time.monotonic() + delay, lambda: self._requeue_now(task)
            )

    def _requeue_now(self, task: Task) -> None:
        """Timer-thread side of a deferred requeue (claim already counted)."""
        if self._observers:
            self._notify("on_submit", task.first if task._seg else task)
        with self._ext_lock:
            self._inbox.push_external(task)
            if self._parked:
                self._wake_one(-1)

    # -- scheduling internals ---------------------------------------------------

    def _outstanding(self) -> int:
        """Claimed-but-not-completed task count.

        Completed cells are summed *first*: every completion counted here
        had its claim recorded earlier (program order under the GIL), so
        the later claimed-sum includes it and the difference never goes
        negative — and a zero difference proves the pool is quiet.
        """
        done = sum(self._completed)
        return sum(self._claimed) - done

    def _wake_one(self, slot: int) -> None:
        """Targeted wakeup: pop one parked worker, set its event, and
        attribute the wakeup to the caller's counter cell.

        Call sites guard with ``if self._parked`` so the saturated hot
        path (nobody parked) never pays the method call.
        """
        try:
            idx = self._parked.popleft()
        except IndexError:
            return
        self._events[idx].set()
        self._wakeups[slot] += 1

    def _schedule(self, task: Task) -> None:
        """Claim ``task`` (one per-cell increment) and enqueue it.

        From a worker thread: push to the worker's own deque, found through
        the thread-local variable (paper §2.1) — lock-free. Otherwise:
        shared inbox (priority-banded FIFO) with the slot-n claim guarded
        by ``_ext_lock``. Either way, at most one parked worker is woken.
        """
        if self._observers:
            # §12 replay meta nodes report as their head member, so queue
            # events always name real tasks (observer parity with live)
            self._notify("on_submit", task.first if task._seg else task)
        idx = getattr(self._tls, "index", None)
        if idx is not None:
            self._claimed[idx] += 1
            self._deques[idx].push(task)
            if self._parked:
                self._wake_one(idx)
        else:
            with self._ext_lock:
                self._claimed[-1] += 1
                self._inbox.push_external(task)
                if self._parked:
                    self._wake_one(-1)

    def _worker(self, index: int) -> None:
        self._tls.index = index
        own = self._deques[index]
        n = len(self._deques)
        ev = self._events[index]
        spins = 0
        while True:
            if self._stop:
                return
            task = self._next_task(index, own, n)
            if task is not EMPTY:
                spins = 0
                self._execute(task, index)
                continue
            if spins < _SPIN_SWEEPS:
                spins += 1
                time.sleep(0)  # yield the GIL so a producer can publish
                continue
            spins = 0
            # Park protocol: clear our event, *register*, then re-sweep.
            # Submitters push the task before scanning the registry, so any
            # push racing our failed sweep is re-observed here; any wakeup
            # aimed at us after registration leaves the event set, making
            # the wait below a no-op. One acquisition-free pass — the old
            # design's double condition-variable lock is gone.
            ev.clear()
            self._parked.append(index)
            self._parked_ct[index] += 1
            task = self._next_task(index, own, n)
            if task is not EMPTY:
                try:
                    self._parked.remove(index)
                except ValueError:
                    pass  # a submitter popped us; its wakeup is consumed below
                self._execute(task, index)
                continue
            if self._stop:  # close() may have raced our registration
                return
            ev.wait(_PARK_BACKSTOP_S)  # backstop only: wakeups are targeted
            try:
                self._parked.remove(index)
            except ValueError:
                pass

    def _next_task(self, index: int, own: Any, n: int) -> Any:
        # 1. own deque: highest priority band, LIFO (depth-first) within it
        task = own.pop()
        if task is not EMPTY:
            return task
        # 2. shared inbox (external submissions): highest band, FIFO within
        task = self._inbox.steal()
        if task is not EMPTY:
            # wake chain: surplus inbox work -> recruit one more sleeper
            if self._parked and len(self._inbox):
                self._wake_one(index)
            return task
        # 3. sweep victims, stealing from the top (highest band, FIFO)
        for k in range(1, n):
            victim = (index + k) % n
            vd = self._deques[victim]
            task = vd.steal()
            if task is not EMPTY:
                self._steals[index] += 1
                if self._parked and len(vd):
                    self._wake_one(index)
                if self._observers:
                    self._notify(
                        "on_steal", task.first if task._seg else task, index, victim
                    )
                return task
        return EMPTY

    def _execute(self, first: Task, index: int) -> None:
        """Run a task, then its ready successors via continuation passing.

        The fan-out (paper §2.2) is a fused decrement-and-pick loop: the
        running maximum-priority ready successor is kept as the inline
        continuation, every other ready successor is pushed straight onto
        this worker's own deque, and one batch wakeup recruits a sleeper.
        No intermediate ready list, no key-function allocation. Inline
        continuations are claimed *before* the finished task's completion
        cell is bumped, so the outstanding count never transiently hits
        zero mid-chain — the quiescence check runs only at chain end.
        """
        claimed = self._claimed
        own = self._deques[index]
        task: Optional[Task] = first
        while task is not None:
            if self._observers and not task._seg:
                # §12 segments fire per-member start/finish from their own
                # run loop; a seg-level pair would double-count
                self._notify("on_start", task, index)
            slow = task._slow
            rt: Optional[Runtime] = None
            # §14 cooperative checkpoint state: two plain stores per task
            _current.task = task
            _current.deadline = (
                None if task.timeout is None else time.monotonic() + task.timeout
            )
            try:
                if self._first_error is not None and task.propagate_errors:
                    # fail-fast: skip bodies once the graph is poisoned, but
                    # keep draining dependencies so waiters unblock.
                    task.exception = CancelledError("predecessor failed")
                    task._done = True  # noqa: SLF001 - internal protocol
                elif slow and task.takes_runtime:
                    rt = Runtime(task)
                    # publish the live (growing) subflow list before the body
                    # runs: a graph canceller sweeping mid-body sees tasks as
                    # they are spawned and can cancel them before they start
                    task._spawned = rt.sub.tasks
                    task.run(rt)
                elif self._offload is not None:
                    self._offload(task, index)
                else:
                    task.run()
            except _Retry as sig:
                # §14 via §12: a segment member failed retriably; the
                # segment re-armed itself (resume point saved) — requeue
                # it whole and end this dispatch without surfacing.
                self._requeue(task, sig.delay, index)
                self._executed[index] += 1
                self._completed[index] += 1
                task = None
                continue
            except BaseException as exc:  # noqa: BLE001 - recorded + re-raised in wait
                if isinstance(exc, TaskTimeoutError):
                    self._timeouts[index] += 1
                    if self._observers:
                        self._notify("on_timeout", task, index)
                if self._maybe_retry(task, exc, index):
                    self._executed[index] += 1
                    self._completed[index] += 1
                    task = None
                    continue
                if (
                    task._last_exc is not None
                    and exc.__context__ is None
                    and exc is not task._last_exc
                ):  # exhausted retries surface the whole attempt chain
                    exc.__context__ = task._last_exc
                task.exception = exc
                if task.propagate_errors:
                    with self._err_lock:
                        if self._first_error is None:
                            self._first_error = exc
            self._executed[index] += 1
            if self._observers and not task._seg:
                self._notify("on_finish", task, index)
            cb = task.on_done
            if cb is not None:
                try:
                    cb(task)
                except BaseException:  # noqa: BLE001 - callback errors are dropped
                    pass
            if slow:
                # conditions / subflows / re-armable loops / counted runs
                task = self._finish_slow(task, index, rt)
                self._completed[index] += 1
                continue
            # Fused fan-out: decrement successors, keep the max-priority
            # ready one inline, push the rest (claimed as they are pushed).
            inline: Optional[Task] = None
            inline_pr = 0.0
            pushed = 0
            for s in task.successors:
                if not s.decrement():
                    continue
                claimed[index] += 1
                if inline is None:
                    inline = s
                    inline_pr = s.priority
                elif s.priority > inline_pr:
                    if self._observers:
                        self._notify("on_submit", inline.first if inline._seg else inline)
                    own.push(inline)
                    pushed += 1
                    inline = s
                    inline_pr = s.priority
                else:
                    if self._observers:
                        self._notify("on_submit", s.first if s._seg else s)
                    own.push(s)
                    pushed += 1
            if pushed and self._parked:
                self._wake_one(index)  # the woken worker chains further
            self._completed[index] += 1
            task = inline
        # chain over: if anyone is waiting for quiescence, check and notify
        if self._idle_waiters and self._outstanding() == 0:
            with self._idle_cond:
                self._idle_cond.notify_all()

    def _finish_slow(
        self, task: Task, index: int, rt: Optional[Runtime]
    ) -> Optional[Task]:
        """Full-featured fan-out for §10 task kinds; returns the inline
        continuation (or None).

        Invariants this path maintains, in order:

        1. **Re-arm before release** (``auto_rearm``): the task refills its
           own countdown/claim *before* any successor becomes runnable, so
           a condition's weak back-edge — causally downstream of this
           task's own fan-out — always finds it armed. Re-triggering a
           task from a branch not downstream of it is a data race by
           construction (same rule as Taskflow) and unsupported.
        2. **Selection**: a subflow splices in behind a hidden join task
           that inherits the spawner's successors; a condition schedules
           exactly the branch its integer result names (weak edges carry
           no countdown, so nothing is decremented — also on failure,
           where no branch runs at all); plain tasks decrement strong
           successors as usual.
        3. **Count before publish**: the whole fan-out folds into one
           ``RunContext.update`` applied *before* any successor is pushed.
        """
        ctx = task.ctx
        if task.auto_rearm:
            task.rearm()
        scheduled: list[Task] = []
        if rt is not None and rt.sub.tasks and task.exception is None:
            # dynamic subflow: [sources ... sinks] -> join -> successors
            # (join wiring + unwrap + failure adoption live in graph.py,
            # shared with SerialExecutor)
            sub, join = splice_subflow(task, rt.sub)
            for st in sub + [join]:
                st.ctx = ctx
                st._slow = ctx is not None or st._slow
                if not task.propagate_errors:
                    st.propagate_errors = False
            if self._wire_tasks is not None:
                # runtime-spawned tasks are wired on the worker: a body
                # that cannot serialize surfaces when that task runs
                # (defer) instead of raising inside the scheduler loop
                self._wire_tasks(sub, defer=True)
            task._spawned = sub
            if task._seg:
                # §12 replay spawner proxy: the splice operated on the meta
                # (so the hidden join releases *meta* successors), but
                # results and failure adoption must land on the wrapped
                # member, where dataflow consumers and the graph resolver
                # read them — mirror the join's verdict back.
                inner = task.first
                inner._spawned = sub

                def _mirror(j, _fj=join.on_done, _meta=task, _inner=inner):
                    _fj(j)
                    _inner.result = _meta.result
                    _inner.exception = _meta.exception

                join.on_done = _mirror
            scheduled = [t for t in sub if t.is_source]
            if join.num_predecessors == 0:  # empty-sink degenerate case
                scheduled.append(join)
        elif task.kind == "condition":
            # weak fan-out: a failed/cancelled condition releases nothing
            # (weak edges contributed no countdown tokens — nothing drains)
            branch = select_branch(task)
            if branch is not None:
                scheduled.append(branch)
        else:
            for s in task.successors:
                if s.decrement():
                    scheduled.append(s)
        if ctx is not None:
            delta = len(scheduled) - 1
            if delta:
                ctx.update(delta)
        # publish: twin of the fused block in _execute (which interleaves the
        # decrement with the pick and must stay allocation-free — keep any
        # change to the inline-pick / push / wakeup policy in sync there)
        inline: Optional[Task] = None
        inline_pr = 0.0
        pushed = 0
        own = self._deques[index]
        for s in scheduled:
            self._claimed[index] += 1
            if inline is None:
                inline = s
                inline_pr = s.priority
            elif s.priority > inline_pr:
                if self._observers:
                    self._notify("on_submit", inline.first if inline._seg else inline)
                own.push(inline)
                pushed += 1
                inline = s
                inline_pr = s.priority
            else:
                if self._observers:
                    self._notify("on_submit", s.first if s._seg else s)
                own.push(s)
                pushed += 1
        if pushed and self._parked:
            self._wake_one(index)
        return inline
