"""Task-graph primitives (paper §2.2).

A :class:`Task` is a thin wrapper over a nullary callable. Each task stores
references to its *successor* tasks and a counter of uncompleted
*predecessor* tasks. When the thread pool finishes a task body it decrements
the counter of every successor; one successor whose counter hits zero is
executed inline on the same worker thread (continuation passing), and any
other newly-ready successors are submitted to the pool. That policy is
implemented in ``pool.py``; this module only defines the data structure and
the dependency-wiring API.

The public API mirrors the paper::

    tasks: list[Task] = []
    get_a = Task(lambda: ...)
    get_sum = Task(lambda: ...)
    get_sum.succeed(get_a, get_b)     # get_sum runs after get_a and get_b
    pool.submit(tasks)

``Succeed`` is kept as an alias for drop-in similarity with the C++ API.

Beyond the paper, tasks carry a ``priority`` (larger runs first among ready
tasks — the same key the schedule simulator uses, DESIGN.md §3) and support
*cooperative cancellation*: :meth:`cancel` marks a task so its body is
skipped if it has not started yet; a task already running completes
normally. Both are what the serving engine builds on (prefill at low
priority, decode ticks at high priority, request abortion).

**Value-passing (dataflow) edges — DESIGN.md §8.** Every :meth:`succeed`
call records the predecessor in an ordered ``inputs`` list — the edge's
argument slot. A task constructed with ``takes_inputs=True`` consumes those
slots: its body is called as ``fn(pred_a.result, pred_b.result, ...)`` in
``succeed`` order, so results flow along edges instead of through captured
closures. Nullary tasks (the paper's model, and the default) ignore their
slots entirely, so ordering-only graphs are unchanged. :meth:`after` wires
an ordering-only edge that records no slot, for mixing control dependencies
into dataflow pipelines. A dataflow task whose input failed (exception or
cancellation) skips its body and propagates the *first* failed input's
exception — failure flows along the same edges as data.

The C++ implementation uses ``std::atomic<int>`` for the predecessor counter.
CPython's ``x -= 1`` is three bytecodes (load/sub/store) and *not* atomic.
Instead of a per-task lock (the pre-§9 design), the countdown is a list of
``num_predecessors`` tokens and the decrement is a single ``list.pop()`` —
one GIL-atomic method call, the direct analogue of ``fetch_sub``. The list
is pre-filled with ``range(n)`` and popped from the end, so exactly one
caller observes the token ``0``: that caller released the last dependency
and owns the ready transition. The cancel-vs-start race is arbitrated the
same way: a one-token claim list popped by whichever of ``run``/``cancel``
gets there first (DESIGN.md §9).

**Control flow in the graph — DESIGN.md §10.** Two task kinds extend the
static model:

* **Condition tasks** (``kind="condition"``, the Taskflow idea): every
  out-edge of a condition task is *weak* — it contributes no token to the
  successor's countdown and records no argument slot. When a condition
  task finishes, its integer return value selects exactly one successor
  (by wiring order), which is scheduled *directly*, bypassing its strong
  countdown; every other branch stays un-run this pass. Because weak edges
  carry no countdown, a weak back-edge may legally close a cycle — the
  executor re-arms loop tasks after each pass (:meth:`rearm`), which is
  what makes iterative retry/convergence loops expressible in the graph.
  A non-``int`` or out-of-range return selects nothing (the loop's exit).

* **Runtime tasks** (``takes_runtime=True``): the body receives a
  ``Runtime`` handle (``graph.py``) as its first argument and may spawn a
  *subflow* — a subgraph built inside the worker, sized by data only seen
  at runtime. The executor joins the subflow before releasing the
  spawner's successors (DESIGN.md §10 join protocol).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

__all__ = ["Task", "CancelledError", "RetryPolicy", "TaskTimeoutError"]


class CancelledError(RuntimeError):
    """Raised for tasks skipped because a predecessor failed or the task
    (or its future) was cancelled before it started."""


class TaskTimeoutError(TimeoutError):
    """A task body exceeded its ``timeout=`` budget (DESIGN.md §14).

    On the thread/serial backends the deadline is *cooperative*: the body
    observes it at :func:`~repro_torch.core.pool.checkpoint` calls. On
    ``ProcessPool`` the watchdog hard-kills the worker process hosting the
    overdue body and the scheduler surfaces this error in its place.
    """


class RetryPolicy:
    """Declarative retry policy for a task body (DESIGN.md §14).

    A failed attempt whose exception matches ``retry_on`` is re-armed and
    re-scheduled through the §9 fast path, after a deterministic backoff
    delay of ``backoff * factor**(attempt-1)`` seconds (capped by
    ``max_backoff``). The delay is implemented as a pool-timed deferred
    requeue — no worker ever sleeps it off. When ``max_attempts`` is
    exhausted the final exception surfaces with the previous attempt's
    exception attached as its ``__context__`` chain.

    ``retry_on`` may be an exception type or a tuple of types; cancellation
    (:class:`CancelledError`) is never retried regardless.

        >>> from repro_torch.core import RetryPolicy
        >>> p = RetryPolicy(max_attempts=3, backoff=0.1, factor=2.0)
        >>> [p.delay(a) for a in (1, 2)]
        [0.1, 0.2]
    """

    __slots__ = ("max_attempts", "backoff", "factor", "max_backoff", "retry_on")

    def __init__(
        self,
        max_attempts: int = 3,
        backoff: float = 0.0,
        *,
        factor: float = 2.0,
        max_backoff: Optional[float] = None,
        retry_on: Any = Exception,
    ) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if backoff < 0:
            raise ValueError("backoff must be >= 0 seconds")
        self.max_attempts = max_attempts
        self.backoff = backoff
        self.factor = factor
        self.max_backoff = max_backoff
        self.retry_on = retry_on

    def matches(self, exc: BaseException) -> bool:
        """Whether ``exc`` is retriable under this policy."""
        if isinstance(exc, CancelledError):
            return False
        return isinstance(exc, self.retry_on)

    def delay(self, attempt: int) -> float:
        """Backoff before re-running after failed attempt ``attempt`` (1-based)."""
        d = self.backoff * (self.factor ** (attempt - 1))
        if self.max_backoff is not None and d > self.max_backoff:
            return self.max_backoff
        return d

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"RetryPolicy(max_attempts={self.max_attempts}, "
            f"backoff={self.backoff}, factor={self.factor})"
        )


class Task:
    """A unit of work plus its task-graph bookkeeping.

    Attributes
    ----------
    fn:
        The wrapped callable (no arguments; the return value is stored on
        ``task.result`` — use closures/captures for richer data flow, as in
        the paper).
    successors:
        Tasks that depend on this one.
    num_predecessors:
        Static in-degree, set up via :meth:`succeed` / :meth:`after`.
    inputs:
        Ordered argument slots: the predecessors wired via :meth:`succeed`,
        in wiring order. Consumed only when ``takes_inputs`` is True.
    takes_inputs:
        When True the body is called with the recorded inputs' results as
        positional arguments (dataflow mode); when False (default) the body
        is nullary, as in the paper.
    priority:
        Larger runs first among ready tasks (own-deque bands, inbox bands
        and the inline-continuation pick — see pool.py). Default 0.0. A
        priority that was never set explicitly (``None`` at construction)
        is *inheritable*: ``then()`` continuations copy their parent's
        priority, and ``ThreadPool.submit(task, priority=...)`` propagates
        the override to reachable successors that never chose their own.
    kind:
        ``"static"`` (default) or ``"condition"`` (module docs above).
    takes_runtime:
        When True the body receives a ``Runtime`` handle as its first
        positional argument (before any dataflow inputs) and may spawn a
        joined subflow (module docs above).
    propagate_errors:
        When False, an exception from ``fn`` is recorded on the task (and
        delivered through any attached future / ``on_done``) but does not
        poison the pool. ``submit_future`` uses this.
    on_done:
        Optional callback ``fn(task)`` invoked by the executor exactly once
        after the task completes — whether it ran, failed, or was skipped
        (cancelled / poisoned graph). This is how futures observe tasks.
    affinity:
        Where the *body* may execute under a multi-process backend
        (DESIGN.md §11): ``"any"`` (default — offloaded to a worker
        process when the body serializes, run in-parent otherwise),
        ``"local"`` (always in-parent), or ``"remote"`` (must offload; an
        unserializable body raises ``UnpicklableTaskError`` at submit).
        Thread and serial backends ignore the field entirely. Control-flow
        bodies — conditions, ``takes_runtime`` spawners — always run
        in-parent regardless, because they drive the scheduler itself.
    retry_policy:
        Optional :class:`RetryPolicy` (also the ``retry=`` constructor
        keyword): a matching body failure re-arms the task and re-schedules
        it after a deterministic backoff instead of surfacing (DESIGN.md
        §14). Exhausted retries surface the final exception with earlier
        attempts on its ``__context__`` chain.
    timeout:
        Optional per-attempt deadline in seconds. Cooperative on thread/
        serial backends (the body must call
        :func:`~repro_torch.core.pool.checkpoint`); enforced by a hard worker
        kill on ``ProcessPool``.
    idempotent:
        Declares the body safe to re-execute after it *started* and was
        lost (worker death / hard timeout kill on ``ProcessPool``). Bodies
        default to at-most-once: a started-but-lost non-idempotent body is
        never retried, even under a matching :class:`RetryPolicy`.

    The paper's ``(a+b)*(c+d)`` graph, wired exactly as in §2.2::

        >>> from repro_torch.core import SerialExecutor, Task
        >>> box = {}
        >>> get_a = Task(lambda: box.__setitem__("a", 1), name="a")
        >>> get_b = Task(lambda: box.__setitem__("b", 2), name="b")
        >>> get_sum = Task(lambda: box.__setitem__("s", box["a"] + box["b"]))
        >>> _ = get_sum.succeed(get_a, get_b)   # runs after both
        >>> SerialExecutor().run([get_a, get_b, get_sum])
        >>> box["s"]
        3

    or dataflow-style, results flowing along the edges (DESIGN.md §8)::

        >>> a, b = Task(lambda: 1), Task(lambda: 2)
        >>> s = Task(lambda x, y: x + y, takes_inputs=True).succeed(a, b)
        >>> SerialExecutor().run([a, b, s])
        >>> s.result
        3
    """

    # Class-level flag, overridden by the §12 replay layer's meta nodes
    # (``replay.py``): lets the pool route queue-side observer events to
    # member tasks with a single attribute check and zero per-instance cost.
    _seg = False

    __slots__ = (
        "fn",
        "name",
        "priority",
        "successors",
        "num_predecessors",
        "num_weak_predecessors",
        "inputs",
        "takes_inputs",
        "kind",
        "takes_runtime",
        "graph",
        "result",
        "propagate_errors",
        "on_done",
        "ctx",
        "auto_rearm",
        "affinity",
        "_wire",
        "_slow",
        "_explicit_pr",
        "_spawned",
        "_pending",
        "_claim",
        "_done",
        "_started",
        "_cancelled",
        "exception",
        "retry_policy",
        "timeout",
        "idempotent",
        "_attempt",
        "_last_exc",
        "_timed_out",
        "_cancel_req",
    )

    def __init__(
        self,
        fn: Optional[Callable[..., Any]] = None,
        name: str = "",
        *,
        priority: Optional[float] = None,
        takes_inputs: bool = False,
        kind: str = "static",
        takes_runtime: bool = False,
        affinity: str = "any",
        retry: Optional[RetryPolicy] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> None:
        if kind not in ("static", "condition"):
            raise ValueError(f"unknown task kind {kind!r}")
        if affinity not in ("any", "local", "remote"):
            raise ValueError(f"unknown task affinity {affinity!r}")
        if timeout is not None and timeout <= 0:
            raise ValueError("timeout must be positive seconds")
        if kind == "condition" and takes_runtime:
            # the subflow splice would take over the weak successor list and
            # strongly decrement edges that hold no countdown tokens — every
            # branch would be silently skipped. Spawn from a branch instead.
            raise ValueError("a condition task cannot also take a runtime handle")
        self.fn = fn
        self.name = name
        self.priority = 0.0 if priority is None else priority
        self._explicit_pr = priority is not None
        self.successors: list[Task] = []
        self.num_predecessors = 0
        self.num_weak_predecessors = 0  # in-edges from condition tasks
        self.inputs: list[Task] = []  # ordered argument slots (succeed order)
        self.takes_inputs = takes_inputs
        self.kind = kind
        self.takes_runtime = takes_runtime
        self.graph: Any = None  # back-ref set by TaskGraph.add (for .then())
        self.result: Any = None
        self.propagate_errors = True
        self.on_done: Optional[Callable[["Task"], None]] = None
        # Per-submission run context (executor-counted completion) and the
        # slow-dispatch flag: the pool's fast path checks `_slow` once per
        # task; conditions, runtime tasks, re-armable loop members and
        # counted runs all route through the full-featured fan-out.
        self.ctx: Any = None
        self.auto_rearm = False
        # Process-backend placement (DESIGN.md §11): `affinity` is the
        # user's constraint; `_wire` caches the serialized body for the
        # current submission (None = run in-parent). Thread/serial
        # backends never touch either.
        self.affinity = affinity
        self._wire: Any = None
        self._slow = kind == "condition" or takes_runtime
        self._spawned: Optional[list[Task]] = None  # last run's subflow
        # Runtime countdown: a token list popped once per completed
        # predecessor; the popper receiving token 0 owns the ready
        # transition. reset() re-arms it. Roots have an empty countdown.
        self._pending: list = []
        # run/cancel claim: one token, popped by whichever side wins.
        self._claim: list = [0]
        self._done = False
        self._started = False
        self._cancelled = False
        self.exception: Optional[BaseException] = None
        # Fault tolerance (DESIGN.md §14): `retry_policy` governs re-arming
        # after a matching body failure, `timeout` bounds one attempt,
        # `idempotent` declares that a started-but-lost body (worker death
        # mid-execution, ProcessPool) is safe to run again. `_attempt`
        # counts completed failed attempts this arming; `_last_exc` chains
        # them; `_timed_out` is the watchdog's hard-kill mark.
        self.retry_policy = retry
        self.timeout = timeout
        self.idempotent = idempotent
        self._attempt = 0
        self._last_exc: Optional[BaseException] = None
        self._timed_out = False
        self._cancel_req = False

    @property
    def is_condition(self) -> bool:
        return self.kind == "condition"

    @property
    def is_source(self) -> bool:
        """No in-edges of either strength — schedulable at submission."""
        return self.num_predecessors == 0 and self.num_weak_predecessors == 0

    # -- graph wiring ---------------------------------------------------------

    def succeed(self, *predecessors: "Task") -> "Task":
        """Declare that ``self`` runs after every task in ``predecessors``.

        Matches the paper's ``task.Succeed(&a, &b)``. Each predecessor is
        also recorded as the next argument slot: a ``takes_inputs`` task
        receives the predecessors' results as positional arguments in
        wiring order (nullary tasks ignore the slots). Returns ``self`` so
        calls can be chained.

        An edge whose *predecessor* is a condition task is **weak**: it
        contributes no countdown token and no argument slot — the branch
        the condition selects is scheduled directly (module docs). The
        position of ``self`` in the condition's successor list is its
        branch index.
        """
        g = self.graph
        if g is not None:
            g._epoch += 1  # §12 structure fingerprint: wiring mutates shape
        for p in predecessors:
            p.successors.append(self)
            if p.kind == "condition":
                self.num_weak_predecessors += 1
            else:
                self.num_predecessors += 1
                self.inputs.append(p)
            pg = p.graph
            if pg is not None and pg is not g:
                pg._epoch += 1
        self._pending[:] = range(self.num_predecessors)
        return self

    def after(self, *predecessors: "Task") -> "Task":
        """Ordering-only edge: run after ``predecessors`` without recording
        an argument slot. Use for control dependencies (e.g. "the directory
        must exist") feeding into dataflow tasks. An edge from a condition
        task is weak here too (see :meth:`succeed`)."""
        g = self.graph
        if g is not None:
            g._epoch += 1  # §12 structure fingerprint: wiring mutates shape
        for p in predecessors:
            p.successors.append(self)
            if p.kind == "condition":
                self.num_weak_predecessors += 1
            else:
                self.num_predecessors += 1
            pg = p.graph
            if pg is not None and pg is not g:
                pg._epoch += 1
        self._pending[:] = range(self.num_predecessors)
        return self

    def precede(self, *successors: "Task") -> "Task":
        """Inverse wiring convenience: ``self`` runs before ``successors``."""
        for s in successors:
            s.succeed(self)
        return self

    def then(
        self,
        fn: Callable[..., Any],
        *,
        name: str = "",
        priority: Optional[float] = None,
    ) -> "Task":
        """Dataflow combinator: a new task consuming this task's result.

        Requires the task to belong to a :class:`~repro_torch.core.TaskGraph`
        (``graph`` back-ref, set by ``TaskGraph.add``); the new task is
        added to the same graph. ``a.then(f).then(g)`` builds ``g(f(a()))``
        as a three-task pipeline. With no explicit ``priority`` the
        continuation inherits this task's priority band — a high-priority
        chain stays high-priority end to end.
        """
        if self.graph is None:
            raise ValueError("then() requires a task created via TaskGraph.add")
        t = self.graph.add(
            fn,
            name=name,
            priority=self.priority if priority is None else priority,
            takes_inputs=True,
        )
        t._explicit_pr = self._explicit_pr if priority is None else True
        t.succeed(self)
        return t

    # C++-style aliases
    Succeed = succeed
    Precede = precede

    # -- runtime ---------------------------------------------------------------

    def reset(self) -> None:
        """Re-arm the countdown so the same graph can be resubmitted.

        Clears the previous run's ``result``/``exception`` — results are
        per-run state, so a re-run can never observe a stale value through
        a dataflow edge. Both token lists are refilled in place (no fresh
        allocation on the re-run path).
        """
        self._pending[:] = range(self.num_predecessors)
        self._claim[:] = (0,)
        self._done = False
        self._started = False
        self._cancelled = False
        self.result = None
        self.exception = None
        self._spawned = None  # per-run record; a skipped spawner must not
        # surface a previous run's subflow to resolution or rendering
        self._attempt = 0
        self._last_exc = None
        self._timed_out = False
        self._cancel_req = False

    def rearm(self) -> None:
        """Re-arm for re-triggering *within* the same run (condition
        cycles, DESIGN.md §10).

        Unlike :meth:`reset`, the previous pass's ``result``/``exception``
        are kept — dataflow successors read them after the pass completes,
        and a condition loop's state legitimately persists across passes
        (the next pass overwrites it). A task cancelled mid-loop stays
        cancelled: its claim is left consumed, so every further trigger
        skips the body and the loop drains cooperatively.
        """
        self._pending[:] = range(self.num_predecessors)
        if not self._cancelled:
            self._claim[:] = (0,)
            self._started = False
        self._done = False
        if self._attempt:  # fresh retry budget per loop pass (rare branch)
            self._attempt = 0
            self._last_exc = None

    def decrement(self) -> bool:
        """Atomically decrement the pending count; True when it reaches zero.

        Analogue of ``fetch_sub(1) == 1`` in the C++ implementation: the
        single ``list.pop()`` bytecode is the atom, and the caller popping
        token ``0`` (the last element) wins the ready transition — exactly
        one winner per arming, with no lock on this per-edge hot path.
        """
        try:
            return self._pending.pop() == 0
        except IndexError:  # over-decrement: already released (defensive)
            return False

    def cancel(self) -> bool:
        """Cooperatively cancel: skip the body if it has not started yet.

        Returns True if the cancellation won the race (the body will never
        run); False if the task already started or finished. Dependency
        bookkeeping is unaffected either way — a cancelled task still
        completes (with :class:`CancelledError`) and releases successors.
        A body already running can observe the request cooperatively via
        :func:`~repro_torch.core.pool.checkpoint` (DESIGN.md §14).
        """
        self._cancel_req = True  # visible to checkpoint() even once started
        if self._started or self._done:
            return False
        try:
            self._claim.pop()  # the run/cancel race atom
        except IndexError:
            # Claim already taken: by run() (cancel lost -> False) or by an
            # earlier cancel (repeat cancel stays True until the skipped
            # body completes — idempotent, as the Future contract requires).
            return self._cancelled
        self._cancelled = True
        return True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def started(self) -> bool:
        return self._started

    @property
    def is_ready(self) -> bool:
        return not self._pending and not self._done

    @property
    def done(self) -> bool:
        return self._done

    def run(self, runtime: Any = None, invoke: Optional[Callable[..., Any]] = None) -> None:
        """Execute the wrapped callable (exceptions handled by the pool).

        A task cancelled before this point records :class:`CancelledError`
        and completes without calling ``fn``. A ``takes_inputs`` task whose
        input failed (or was cancelled) skips its body and adopts the first
        failed input's exception, so failure propagates along dataflow
        edges without poisoning the pool when ``propagate_errors`` is off.
        ``runtime`` (supplied by the executor for ``takes_runtime`` tasks)
        is passed to the body as its first positional argument.

        ``invoke`` is the process-backend dispatch seam (DESIGN.md §11):
        when given, the body call is delegated as ``invoke(fn, args)`` —
        every other piece of the protocol (claim race, cancellation,
        input-failure adoption, done transition) still runs here, on the
        scheduler side, so a remote body changes *where* ``fn`` executes
        and nothing else.
        """
        try:
            self._claim.pop()  # the run/cancel race atom
        except IndexError:  # cancel() claimed it first
            if self.exception is None:
                self.exception = CancelledError("task cancelled")
            self._done = True
            return
        self._started = True
        self.exception = None  # a re-armed loop pass must not report stale failures
        if self.takes_inputs:
            for p in self.inputs:
                if p.exception is not None:
                    self.exception = p.exception
                    self._done = True
                    return
            if self.fn is not None:
                args = tuple(p.result for p in self.inputs)
                if runtime is not None:
                    self.result = self.fn(runtime, *args)
                elif invoke is not None:
                    self.result = invoke(self.fn, args)
                else:
                    self.result = self.fn(*args)
        elif self.fn is not None:
            if runtime is not None:
                self.result = self.fn(runtime)
            elif invoke is not None:
                self.result = invoke(self.fn, ())
            else:
                self.result = self.fn()
        self._done = True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        nm = self.name or (getattr(self.fn, "__name__", "") if self.fn else "")
        return f"Task({nm!r}, preds={self.num_predecessors}, succs={len(self.successors)})"


def iter_graph(tasks: Iterable[Task]) -> list[Task]:
    """All tasks reachable from ``tasks`` through successor edges."""
    seen: dict[int, Task] = {}
    stack = list(tasks)
    while stack:
        t = stack.pop()
        if id(t) in seen:
            continue
        seen[id(t)] = t
        stack.extend(t.successors)
    return list(seen.values())
