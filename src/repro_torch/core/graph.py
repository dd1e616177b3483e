"""TaskGraph convenience container on top of ``task.py``.

The paper's API works on any iterable of ``Task`` objects;
:class:`TaskGraph` adds the bookkeeping a framework wants: named task
creation, cycle validation (Kahn), root discovery, DOT export, and
helpers to build common shapes (map/reduce, wavefronts) used by the data
pipeline, checkpointing and benchmarks.

Beyond the container (DESIGN.md §8), a ``TaskGraph`` is the unit of the
*dataflow runtime*:

* **value-passing pipelines** via :meth:`then` / :meth:`gather` — results
  flow along edges as ordered arguments instead of through captured
  closures (``task.py`` docs);
* **composition** via :meth:`compose` — a whole subgraph embeds as a
  module behind source/sink boundary tasks, with the sink gathering the
  subgraph's sink results as a list;
* **re-runnable lifecycle** — results are per-run state; :meth:`reset`
  re-arms every task (counters, results, cancellation), ``run_count``
  tracks submissions, and each :meth:`as_future` call returns a fresh
  future for that run. Build once, run N times.

Control flow (DESIGN.md §10) rides on the same container: condition tasks
(``add(fn, kind="condition")``) branch and may close cycles through weak
back-edges — :meth:`validate` permits exactly those cycles — and
``takes_runtime`` tasks receive a :class:`Runtime` handle to spawn joined
subflows sized by runtime data. ``as_future`` switches to counted
completion for graphs containing condition tasks (a hidden sink task
cannot terminate a graph whose branches legitimately never run).
"""
from __future__ import annotations

from collections import deque as _pydeque
from typing import Any, Callable, Iterator, Optional, Sequence

from .task import CancelledError, RetryPolicy, Task

__all__ = ["TaskGraph", "Module", "Runtime", "CycleError"]


class CycleError(ValueError):
    """The task graph contains a dependency cycle."""


class _FinTask(Task):
    """Hidden ``as_future`` completion task.

    A distinct type (not just a name convention) so sink detection,
    ``validate`` and external-task adoption can recognize *any* graph's
    completion task — including a stale one left wired by a previous
    anonymous wrapper graph — and never mistake it for a real successor.
    """

    __slots__ = ()


class Module:
    """Handle to a composed subgraph (see :meth:`TaskGraph.compose`).

    ``source`` runs before every root of the subgraph; ``sink`` runs after
    every sink of the subgraph and its *result* is the list of the
    subgraph sinks' results (in ``sub.tasks`` order). Wire the module into
    the outer graph through these two boundary tasks::

        m = outer.compose(sub)
        m.source.after(prepare)          # sub starts after `prepare`
        commit = outer.then(m.sink, fn)  # fn receives the gathered results
    """

    __slots__ = ("source", "sink", "sub")

    def __init__(self, source: Task, sink: Task, sub: "TaskGraph") -> None:
        self.source = source
        self.sink = sink
        self.sub = sub

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Module({self.sub.name!r}, tasks={len(self.sub)})"


class Runtime:
    """Handle passed to a ``takes_runtime`` task's body (DESIGN.md §10).

    The body builds a *subflow* through this handle — a fresh subgraph
    sized by data only known at execution time::

        def shard(rt: Runtime):
            writers = [rt.add(lambda p=p: write(p)) for p in discover()]
            return rt.gather(writers)   # spawner's value = gathered results

    After the body returns, the executor splices the subflow in: the
    subflow runs, a hidden join task waits on its sinks, and only then are
    the spawning task's successors released (**join-before-successor**).
    The first subflow failure is adopted as the spawner's exception, and a
    body returning one of its own subflow tasks is *unwrapped* — the
    spawner's dataflow value becomes that task's result, so downstream
    consumers receive plain values. The graph-building API mirrors
    :class:`TaskGraph`; tasks default to the spawner's priority band so a
    prioritized parent doesn't fan out at band 0.
    """

    __slots__ = ("task", "sub")

    def __init__(self, task: Task) -> None:
        self.task = task
        self.sub = TaskGraph(f"{task.name or 'task'}::subflow")

    def add(
        self,
        fn: Optional[Callable[..., Any]] = None,
        *,
        name: str = "",
        priority: Optional[float] = None,
        takes_inputs: bool = False,
        kind: str = "static",
        takes_runtime: bool = False,
        affinity: str = "any",
        retry: Optional[RetryPolicy] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Task:
        """Spawn one subflow task. Nested ``takes_runtime`` spawners are
        supported, as is ``kind="condition"`` with two constraints: acyclic
        branching only (subflow tasks are not re-armed, so weak *cycles*
        must live in the outer graph), and branches must re-converge before
        the subflow's sinks (the hidden join waits on every sink — a sink
        reachable only through an untaken branch would never release it).
        ``retry``/``timeout``/``idempotent`` attach §14 fault-tolerance
        policy exactly as on :meth:`TaskGraph.add`."""
        t = self.sub.add(
            fn,
            name=name,
            priority=self.task.priority if priority is None else priority,
            takes_inputs=takes_inputs,
            kind=kind,
            takes_runtime=takes_runtime,
            affinity=affinity,
            retry=retry,
            timeout=timeout,
            idempotent=idempotent,
        )
        t._explicit_pr = self.task._explicit_pr if priority is None else True
        return t

    def then(self, predecessor: Task, fn: Callable[..., Any], *, name: str = "") -> Task:
        t = self.add(fn, name=name, takes_inputs=True)
        t.succeed(predecessor)
        return t

    def gather(
        self,
        predecessors: Sequence[Task],
        fn: Optional[Callable[..., Any]] = None,
        *,
        name: str = "gather",
    ) -> Task:
        collect = fn if fn is not None else (lambda *vs: list(vs))
        t = self.add(collect, name=name, takes_inputs=True)
        t.succeed(*predecessors)
        return t

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Runtime({self.task.name!r}, spawned={len(self.sub)})"


def select_branch(task: Task) -> Optional[Task]:
    """The §10 condition-selection rule (shared by ``ThreadPool`` and
    ``SerialExecutor``): a finished condition task releases the successor
    its integer result names, or nothing — on a failed/cancelled pass, a
    non-``int`` result, or an out-of-range index (the loop-exit idiom)."""
    sel = task.result if task.exception is None else None
    if isinstance(sel, bool):
        sel = int(sel)
    if isinstance(sel, int) and 0 <= sel < len(task.successors):
        return task.successors[sel]
    return None


def splice_subflow(spawner: Task, sub: "TaskGraph") -> tuple[list[Task], Task]:
    """Wire a spawned subflow's hidden join (shared by ``ThreadPool`` and
    ``SerialExecutor`` — the join-before-successor protocol lives here
    exactly once). Returns ``(subflow_tasks, join)``.

    The join takes over the spawner's successor list and waits strongly on
    every subflow sink; its completion callback *unwraps* a body that
    returned one of its own subflow tasks (the spawner's dataflow value
    becomes that task's result) and adopts the first subflow failure as
    the spawner's exception. The caller schedules the subflow's sources
    (or the join itself when there are none) and attaches any
    executor-specific state (run context, priority dispatch flags).
    """
    tasks = list(sub.tasks)
    join = Task(
        name=f"{spawner.name or 'task'}::join",
        priority=spawner.priority if spawner._explicit_pr else None,
    )
    join.propagate_errors = False
    join.successors = list(spawner.successors)
    join.after(*[t for t in tasks if not t.successors])

    def _finish_join(_j: Task) -> None:
        res = spawner.result
        if isinstance(res, Task) and res.graph is sub:
            spawner.result = res.result
        if spawner.exception is not None:
            return
        first_cancel: Optional[BaseException] = None
        for st in tasks:
            if st.exception is None:
                continue
            if not isinstance(st.exception, CancelledError):
                spawner.exception = st.exception
                return
            first_cancel = first_cancel or st.exception
        spawner.exception = first_cancel

    join.on_done = _finish_join
    return tasks, join


class TaskGraph:
    """Named container of :class:`Task` objects plus the dataflow runtime
    (module docs above).

    Build once, run N times — through an :class:`~repro_torch.core.Executor`
    (any backend), a :class:`~repro_torch.core.ThreadPool`, or serially::

        >>> from repro_torch.core import Executor, TaskGraph
        >>> g = TaskGraph("pipeline")
        >>> a = g.add(lambda: 2, name="a")
        >>> b = g.add(lambda: 3, name="b")
        >>> total = g.gather([a, b], fn=lambda x, y: x + y, name="sum")
        >>> with Executor(backend="serial") as ex:
        ...     _ = ex.run(g).result(10)
        >>> total.result
        5

    Parameters
    ----------
    name:
        Label used in DOT exports, trace events and error messages.
    """

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.tasks: list[Task] = []
        self._fin: Optional[Task] = None  # hidden as_future completion task
        self._sinks: dict[int, Task] = {}  # tasks currently wired into _fin
        self._run_count = 0
        self._num_conditions = 0
        # -- §12 capture & replay bookkeeping (replay.py). `_epoch` is the
        # structure fingerprint: every add/adopt/succeed/after bumps it.
        # `_settled_epoch` records the epoch as of the last completed live
        # submission — compilation waits for structure to settle so a plan
        # never captures a graph whose sink reconciliation hasn't run.
        self._epoch = 0
        self._settled_epoch = -1
        self._plan: Any = None
        # epoch as of the last `Executor(verify=...)` pass over this graph
        # (analysis/verify.py) — re-verification happens only on mutation
        self._verified_epoch: Optional[int] = None

    # -- construction -----------------------------------------------------------

    def add(
        self,
        fn: Optional[Callable[..., Any]] = None,
        *,
        name: str = "",
        priority: Optional[float] = None,
        takes_inputs: bool = False,
        kind: str = "static",
        takes_runtime: bool = False,
        affinity: str = "any",
        retry: Optional[RetryPolicy] = None,
        timeout: Optional[float] = None,
        idempotent: bool = False,
    ) -> Task:
        """Create a :class:`Task` owned by this graph and return it.

        Parameters mirror the ``Task`` constructor (``fn`` body, wiring
        happens afterwards via :meth:`Task.succeed` / :meth:`Task.after`):
        ``takes_inputs`` turns on dataflow argument delivery,
        ``kind="condition"`` makes a §10 branching task, ``takes_runtime``
        hands the body a :class:`Runtime` for subflow spawning, and
        ``affinity`` constrains §11 process-backend placement
        (``"any"`` / ``"local"`` / ``"remote"``). ``retry`` attaches a §14
        :class:`~repro_torch.core.RetryPolicy`, ``timeout`` a per-attempt
        deadline, and ``idempotent`` marks the body safe to re-run after a
        started-but-lost §11 attempt. An omitted ``name`` defaults to
        ``t<index>``; an omitted ``priority`` is inheritable (see
        ``Task.priority``). Raises ``ValueError`` for an unknown
        ``kind``/``affinity`` or a condition task that takes a runtime.
        """
        t = Task(
            fn,
            name=name or f"t{len(self.tasks)}",
            priority=priority,
            takes_inputs=takes_inputs,
            kind=kind,
            takes_runtime=takes_runtime,
            affinity=affinity,
            retry=retry,
            timeout=timeout,
            idempotent=idempotent,
        )
        t.graph = self
        self.tasks.append(t)
        self._epoch += 1
        if t.is_condition:
            self._num_conditions += 1
        return t

    @property
    def has_conditions(self) -> bool:
        return self._num_conditions > 0

    def emplace_back(self, fn: Optional[Callable[[], Any]] = None) -> Task:
        """Paper-style alias (``tasks.emplace_back([...])``)."""
        return self.add(fn)

    def adopt(self, *tasks: Task) -> None:
        """Explicitly take ownership of externally-created tasks."""
        for t in tasks:
            if t.graph is not self:
                t.graph = self
            self.tasks.append(t)
            self._epoch += 1
            if t.is_condition:
                self._num_conditions += 1

    def map_reduce(
        self,
        map_fns: Sequence[Callable[[], Any]],
        reduce_fn: Callable[[], Any],
        *,
        name: str = "reduce",
    ) -> Task:
        """Fan-out/fan-in: ``reduce_fn`` runs after every mapped task."""
        mapped = [self.add(fn, name=f"map{i}") for i, fn in enumerate(map_fns)]
        red = self.add(reduce_fn, name=name)
        red.succeed(*mapped)
        return red

    def chain(self, fns: Sequence[Callable[[], Any]], *, name: str = "chain") -> list[Task]:
        """Sequential chain of tasks."""
        out: list[Task] = []
        for i, fn in enumerate(fns):
            t = self.add(fn, name=f"{name}{i}")
            if out:
                t.succeed(out[-1])
            out.append(t)
        return out

    # -- dataflow combinators ------------------------------------------------------

    def then(
        self,
        predecessor: Task,
        fn: Callable[..., Any],
        *,
        name: str = "",
        priority: Optional[float] = None,
    ) -> Task:
        """A new task receiving ``predecessor``'s result as its argument.

        Inherits ``predecessor``'s priority band unless one is given —
        the fix for continuations silently falling back to band 0.0.
        """
        t = self.add(
            fn,
            name=name,
            priority=predecessor.priority if priority is None else priority,
            takes_inputs=True,
        )
        t._explicit_pr = predecessor._explicit_pr if priority is None else True
        t.succeed(predecessor)
        return t

    def gather(
        self,
        predecessors: Sequence[Task],
        fn: Optional[Callable[..., Any]] = None,
        *,
        name: str = "gather",
        priority: Optional[float] = None,
    ) -> Task:
        """Join: a task receiving every predecessor's result, in order.

        With no ``fn`` the task simply collects the results into a list —
        the dataflow analogue of ``asyncio.gather``. With no explicit
        ``priority`` the join inherits the highest predecessor band (a
        join must not demote a prioritized fan-in).
        """
        collect = fn if fn is not None else (lambda *vs: list(vs))
        if priority is None:
            pr = max((p.priority for p in predecessors), default=0.0)
            explicit = any(p._explicit_pr for p in predecessors)
        else:
            pr, explicit = priority, True
        t = self.add(collect, name=name, priority=pr, takes_inputs=True)
        t._explicit_pr = explicit
        t.succeed(*predecessors)
        return t

    def compose(self, sub: "TaskGraph", *, name: str = "") -> Module:
        """Embed ``sub`` as a module with source/sink boundary tasks.

        The subgraph's tasks are adopted into this graph (they run, reset
        and cancel with it — do not submit ``sub`` separately afterwards).
        The boundary source precedes every root of ``sub`` with an
        ordering-only edge; the boundary sink gathers the results of every
        sink of ``sub`` as a list, so a composed module participates in
        value-passing like a single task.
        """
        label = name or sub.name or "sub"
        src = self.add(None, name=f"{label}::src")
        roots = sub.roots()
        sinks = [t for t in sub.tasks if not t.successors]
        for r in roots:
            r.after(src)
        self.adopt(*sub.tasks)
        snk = self.gather(sinks, name=f"{label}::sink")
        # sink > source even when `sub` is empty, so downstream consumers
        # can never overtake the module's upstream ordering edges
        snk.after(src)
        return Module(src, snk, sub)

    # -- execution ----------------------------------------------------------------

    @property
    def run_count(self) -> int:
        """How many times this graph has been submitted (``as_future`` or
        ``ThreadPool.submit``)."""
        return self._run_count

    def reset(self) -> None:
        """Re-arm every task (and the hidden completion task) for a fresh
        run: counters, per-run results/exceptions and cancellation flags.

        ``ThreadPool.submit`` re-arms counters itself; explicit ``reset``
        exists so a partially-cancelled or failed graph can be returned to
        a clean slate before resubmission.
        """
        for t in self.tasks:
            t.reset()
        if self._fin is not None:
            self._fin.reset()

    def _notify_submitted(self) -> None:
        """Called by ``ThreadPool.submit`` when the graph is submitted."""
        self._run_count += 1

    # -- §12 capture & replay ------------------------------------------------------

    @property
    def replay_plan(self):
        """The compiled §12 :class:`~repro_torch.core.ReplayPlan`, or ``None``
        when the graph has not yet settled (or was invalidated)."""
        return self._plan

    def invalidate_plan(self) -> None:
        """Drop the compiled replay plan explicitly.

        The next submission dispatches live and a fresh plan compiles once
        the structure settles again. Needed only for mutations the epoch
        fingerprint cannot see — e.g. rebinding ``task.fn`` on a §11
        process backend wants re-wiring semantics decided here (plan
        re-arm does refresh wires every pass, so plain ``fn`` rebinding is
        already safe; use this as the explicit escape hatch for anything
        else out-of-band).
        """
        self._plan = None

    def _mark_plan_diverged(self) -> None:
        p = self._plan
        if p is not None:
            p.diverged = True

    def _usable_plan(self, pool):
        """Return a plan ready to replay on ``pool``, compiling one when
        the structure has settled; an invalidated plan (mutated graph,
        divergence, different pool) is dropped so the caller takes the
        live path — whose full per-task reset clears any stale state —
        and the next settled submission recompiles."""
        plan = self._plan
        if plan is not None:
            if plan.usable(pool, self._epoch):
                return plan
            self._plan = None
            return None
        if self._run_count >= 1 and self._epoch == self._settled_epoch:
            from .replay import compile_plan, replay_eligible

            if replay_eligible(pool):
                self._plan = compile_plan(self, pool)
                return self._plan
        return None

    def as_future(self, pool, *, replay: bool = True) -> "Future":  # noqa: F821
        """Submit the whole graph and return a :class:`~repro_torch.core.Future`.

        The future resolves to ``None`` when every task has completed, or to
        the first task exception if the graph failed. ``future.cancel()``
        cooperatively cancels every task that has not started yet (running
        bodies finish; dependencies still drain so the pool stays clean).

        One hidden completion task is kept per graph; sink membership is
        *tracked* across calls — a task that gains a real successor after a
        previous round is unwired from the completion task, and new sinks
        are wired in — so build-once / ``as_future``-per-round submission
        neither accumulates bookkeeping nor retires on stale edges. Rounds
        must be sequential (task state is shared across submissions, as
        with plain ``submit``).

        A graph containing **condition tasks** switches to counted
        completion (DESIGN.md §10): branches legitimately never run and
        weak cycles re-run tasks, so "every sink finished" is not a
        termination signal — instead the run resolves when its in-flight
        task count drains to zero.

        **Replay (DESIGN.md §12)** is on by default: once the graph's
        structure has settled over one live run, subsequent calls dispatch
        from the compiled :class:`~repro_torch.core.ReplayPlan` — skipping the
        per-task reset walk, sink reconciliation and live fan-out. Any
        divergence (mutation, cancellation, a failed pass, a different
        pool) transparently falls back to live dispatch and recompiles on
        the next settled run. ``replay=False`` forces live dispatch for
        one call without dropping the plan.
        """
        from .pool import Future  # local import: graph.py must not cycle

        if self._num_conditions:
            return self._as_future_counted(pool, replay=replay)
        plan = self._usable_plan(pool) if replay else None
        if plan is not None:
            return self._replay_dag(pool, plan)
        if self._fin is None:
            # Priority 0.0, deliberately: the completion task is only ever
            # ready once every sink has finished, so boosting it buys
            # nothing — while any non-zero priority would permanently
            # promote the pool's deques to banded mode and forfeit the
            # single-band fast path (DESIGN.md §9) for priority-free
            # dataflow graphs. When it is the lone newly-ready successor
            # the fused fan-out runs it inline regardless.
            self._fin = _FinTask(name=f"{self.name or 'graph'}::done")
            self._fin.propagate_errors = False
        fin = self._fin
        # Reconcile tracked sink membership with the current topology. A
        # completion task of ANY graph (type check, not identity) is never
        # a real successor — a stale one from a previous wrapper graph
        # must not hide a sink (it would resolve the future at submit).
        current = {
            id(t): t
            for t in self.tasks
            if not any(not isinstance(s, _FinTask) for s in t.successors)
        }
        # Fin edges are submission bookkeeping, not user structure: wiring
        # them must not move the §12/§15 epoch fingerprint (a first-run
        # bump would force one spurious re-verify and re-settle per graph).
        epoch0 = self._epoch
        for tid, t in list(self._sinks.items()):
            if tid not in current:  # gained a real successor since last round
                t.successors.remove(fin)
                fin.num_predecessors -= 1
                del self._sinks[tid]
        for tid, t in current.items():
            if tid not in self._sinks:
                fin.after(t)
                self._sinks[tid] = t
        self._epoch = epoch0
        graph_tasks = list(self.tasks)

        def _canceller() -> bool:
            # cancellation consumes claims mid-run: any compiled plan is
            # state-divergent now and must fall back to live dispatch
            self._mark_plan_diverged()
            won = fin.cancel()
            for t in graph_tasks:
                t.cancel()
                for st in t._spawned or ():  # in-flight subflow tasks too
                    st.cancel()
            return won

        fut = Future(canceller=_canceller)

        def _resolve(_t: Task) -> None:
            cancelled_exc: Optional[BaseException] = None
            for t in graph_tasks:
                if t.exception is not None:
                    if not isinstance(t.exception, CancelledError):
                        fut.set_exception(t.exception)
                        return
                    # Explicit cancel OR a body skipped because the pool was
                    # poisoned by an unrelated failure — either way the graph
                    # did not run; never report success.
                    cancelled_exc = t.exception
            if cancelled_exc is not None or any(t.cancelled for t in graph_tasks):
                fut.set_exception(cancelled_exc or CancelledError("task graph cancelled"))
                return
            fut.set_result(None)

        fin.on_done = _resolve
        pool.submit(list(self.tasks) + [fin])
        self._run_count += 1
        self._settled_epoch = self._epoch  # structure settled: §12 may compile
        return fut

    def _replay_dag(self, pool, plan) -> "Future":  # noqa: F821 - forward ref
        """Replay submission for plain-DAG graphs (DESIGN.md §12): fresh
        future + resolver, plan re-arm instead of the O(n) reset walk,
        pre-bound roots instead of source discovery. Topology is unchanged
        by fingerprint, so sink reconciliation is skipped entirely."""
        from .pool import Future  # local import: graph.py must not cycle

        fin = self._fin
        graph_tasks = plan.scan_tasks

        def _canceller() -> bool:
            plan.diverged = True  # claims consumed mid-run: next pass is live
            won = fin.cancel()
            for t in graph_tasks:
                t.cancel()
                for st in t._spawned or ():
                    st.cancel()
            return won

        fut = Future(canceller=_canceller)

        def _resolve(_t: Task) -> None:
            cancelled_exc: Optional[BaseException] = None
            for t in graph_tasks:
                if t.exception is not None:
                    if not isinstance(t.exception, CancelledError):
                        plan.diverged = True
                        fut.set_exception(t.exception)
                        return
                    cancelled_exc = t.exception
            if cancelled_exc is not None or any(t.cancelled for t in graph_tasks):
                plan.diverged = True
                fut.set_exception(cancelled_exc or CancelledError("task graph cancelled"))
                return
            fut.set_result(None)

        fin.on_done = _resolve
        plan.rearm()
        self._run_count += 1
        plan.schedule(pool)
        return fut

    def _as_future_counted(self, pool, *, replay: bool = True) -> "Future":  # noqa: F821
        """Counted-completion submission (condition graphs, DESIGN.md §10).

        A :class:`~repro_torch.core.pool.RunContext` counts scheduled-but-
        unfinished tasks of this run; the worker that drains the count to
        zero resolves the future. Subflow tasks spawned during the run are
        counted (and cancelled) through the same context.

        Replay (§12) composes: condition branch targets are pre-bound weak
        meta-edges, so a loop that branches *differently* between passes
        (serve ticks, prefetch lanes) keeps one plan — the context simply
        counts meta nodes instead of member tasks, and loop members
        self-re-arm inside their segment.
        """
        from .pool import Future, RunContext  # local import: no cycle

        plan = self._usable_plan(pool) if replay else None
        if plan is not None:
            graph_tasks = plan.scan_tasks

            def _plan_canceller() -> bool:
                plan.diverged = True  # claims consumed mid-run: next pass live
                won = False
                for t in graph_tasks:
                    if t.cancel():
                        won = True
                    for st in t._spawned or ():
                        if st.cancel():
                            won = True
                return won

            fut = Future(canceller=_plan_canceller)

            def _resolve_replayed() -> None:
                cancelled_exc: Optional[BaseException] = None
                saw_cancel = False
                for t in graph_tasks:
                    spawned = t._spawned or ()
                    for x in (t, *spawned):
                        if x.exception is not None:
                            if not isinstance(x.exception, CancelledError):
                                plan.diverged = True
                                fut.set_exception(x.exception)
                                return
                            cancelled_exc = x.exception
                        saw_cancel = saw_cancel or x.cancelled
                if cancelled_exc is not None or saw_cancel:
                    plan.diverged = True
                    fut.set_exception(
                        cancelled_exc or CancelledError("task graph cancelled")
                    )
                    return
                fut.set_result(None)

            ctx = RunContext(_resolve_replayed)
            plan.rearm()
            self._run_count += 1
            ctx.update(len(plan.roots))
            plan.schedule(pool, ctx)
            return fut

        graph_tasks = list(self.tasks)

        def _canceller() -> bool:
            self._mark_plan_diverged()  # claims consumed: plan is stale now
            won = False
            for t in graph_tasks:
                if t.cancel():
                    won = True
                for st in t._spawned or ():
                    if st.cancel():
                        won = True
            return won

        fut = Future(canceller=_canceller)

        def _resolve_counted() -> None:
            cancelled_exc: Optional[BaseException] = None
            saw_cancel = False
            for t in graph_tasks:
                spawned = t._spawned or ()
                for x in (t, *spawned):
                    if x.exception is not None:
                        if not isinstance(x.exception, CancelledError):
                            fut.set_exception(x.exception)
                            return
                        cancelled_exc = x.exception
                    saw_cancel = saw_cancel or x.cancelled
            if cancelled_exc is not None or saw_cancel:
                fut.set_exception(cancelled_exc or CancelledError("task graph cancelled"))
                return
            fut.set_result(None)

        ctx = RunContext(_resolve_counted)
        self._run_count += 1
        submitted = pool._submit_with_context(graph_tasks, ctx)
        self._settled_epoch = self._epoch  # structure settled: §12 may compile
        if not submitted:
            _resolve_counted()  # nothing to run: resolve immediately
        return fut

    # -- inspection ---------------------------------------------------------------

    def roots(self) -> list[Task]:
        """Source tasks: no in-edges of either strength (weak in-edges
        are excluded too — a weak-only target is released by its condition
        at runtime, never at submission)."""
        return [t for t in self.tasks if t.is_source]

    def edges(self) -> list[tuple[Task, Task, bool]]:
        """Every edge as ``(pred, succ, strong)`` in declaration order.

        The strength column encodes the §10 rule the scheduler itself
        uses: *all* out-edges of a condition task are weak (no countdown
        token; successor position is the branch index), all out-edges of
        any other task are strong. Edges to another graph's hidden
        completion task are omitted — bookkeeping, not structure. This is
        the introspection surface the :mod:`repro.analysis` verifier walks
        so lint rules never reimplement edge-strength semantics.
        """
        out: list[tuple[Task, Task, bool]] = []
        for t in self.tasks:
            strong = not t.is_condition
            for s in t.successors:
                if isinstance(s, _FinTask):
                    continue
                out.append((t, s, strong))
        return out

    def find_strong_cycle(self) -> Optional[list[Task]]:
        """Return one cycle of **strong** edges as a task path (first task
        repeated at the end), or ``None`` when every cycle is closed only
        by weak condition branches.

        This is the analysis companion to :meth:`validate`: the same
        Kahn-on-strong-in-degrees walk, but instead of a count it names
        the offending tasks. The cycle found is walked from an arbitrary
        unfinished task along strong successors, so for tangled graphs it
        is *a* witness cycle, not necessarily the only one.
        """
        indeg = {id(t): t.num_predecessors for t in self.tasks}
        q = _pydeque(t for t in self.tasks if t.num_predecessors == 0)
        remaining = {id(t): t for t in self.tasks}
        while q:
            t = q.popleft()
            remaining.pop(id(t), None)
            if t.is_condition:
                continue  # weak out-edges never contributed to in-degrees
            for s in t.successors:
                if id(s) not in indeg:
                    continue
                indeg[id(s)] -= 1
                if indeg[id(s)] == 0:
                    q.append(s)
        # Every task left has an unfinished strong predecessor, so following
        # strong in-edges inside `remaining` must revisit a node: a cycle.
        for start in remaining.values():
            path: list[Task] = []
            seen: dict[int, int] = {}
            t: Optional[Task] = start
            while t is not None and id(t) not in seen:
                seen[id(t)] = len(path)
                path.append(t)
                t = next(
                    (
                        p
                        for p in remaining.values()
                        if not p.is_condition and t in p.successors
                    ),
                    None,
                )
            if t is not None:  # closed a strong cycle
                cyc = path[seen[id(t)] :]
                cyc.reverse()  # we walked in-edges; report in edge direction
                # rotate to start at the earliest-declared member, so the
                # reported path is deterministic for a given build order
                order = {id(x): i for i, x in enumerate(self.tasks)}
                k = min(range(len(cyc)), key=lambda i: order[id(cyc[i])])
                cyc = cyc[k:] + cyc[:k]
                return cyc + [cyc[0]]
        return None

    def validate(self) -> None:
        """Raise :class:`CycleError` unless every cycle is condition-closed.

        Tasks reachable through successor edges but missing from the
        container are first collected, then adopted explicitly via
        :meth:`adopt` *before* the Kahn walk — validation never mutates
        ``self.tasks`` mid-iteration (the hidden ``as_future`` completion
        task is exempt: it is bookkeeping, not part of the user's graph).

        The Kahn walk counts **strong** in-degrees only; a condition
        task's out-edges are weak (no countdown contribution), so a cycle
        closed by a weak back-edge — the §10 retry/convergence loop — is
        legal, while a cycle of strong edges still fails.
        """
        known = {id(t) for t in self.tasks}
        externals: list[Task] = []
        stack = list(self.tasks)
        while stack:
            t = stack.pop()
            for s in t.successors:
                if isinstance(s, _FinTask) or id(s) in known:
                    continue
                known.add(id(s))
                externals.append(s)
                stack.append(s)
        if externals:
            self.adopt(*externals)
        indeg = {id(t): t.num_predecessors for t in self.tasks}
        q = _pydeque(t for t in self.tasks if t.num_predecessors == 0)
        visited = 0
        while q:
            t = q.popleft()
            visited += 1
            if t.is_condition:
                continue  # weak out-edges never contributed to in-degrees
            for s in t.successors:
                if id(s) not in indeg:  # hidden completion task
                    continue
                indeg[id(s)] -= 1
                if indeg[id(s)] == 0:
                    q.append(s)
        if visited != len(self.tasks):
            cycle = self.find_strong_cycle()
            path = (
                " -> ".join(t.name or f"t{i}" for i, t in enumerate(cycle))
                if cycle
                else "<no witness cycle found>"
            )
            raise CycleError(
                f"task graph {self.name!r}: {len(self.tasks) - visited} task(s) "
                f"unreachable from roots — strong dependency cycle: {path}"
            )

    def critical_path(self, cost: Callable[[Task], float] = lambda _t: 1.0) -> float:
        """Length of the longest dependency chain (lower bound on makespan)."""
        self.validate()
        order = self._topo_order()
        dist = {id(t): cost(t) for t in order}
        for t in order:
            for s in t.successors:
                if id(s) in dist:
                    dist[id(s)] = max(dist[id(s)], dist[id(t)] + cost(s))
        return max(dist.values(), default=0.0)

    def _topo_order(self) -> list[Task]:
        indeg = {id(t): t.num_predecessors for t in self.tasks}
        q = _pydeque(t for t in self.tasks if t.num_predecessors == 0)
        order: list[Task] = []
        while q:
            t = q.popleft()
            order.append(t)
            if t.is_condition:
                continue  # weak edges carry no in-degree
            for s in t.successors:
                if id(s) not in indeg:
                    continue
                indeg[id(s)] -= 1
                if indeg[id(s)] == 0:
                    q.append(s)
        return order

    def to_dot(self) -> str:
        """DOT export. Condition tasks render as diamonds with **dashed**
        branch edges (labelled by branch index); each ``takes_runtime``
        task's last-observed subflow renders as a ``cluster`` subgraph
        hanging off its spawner by a dotted edge — so a trace of a
        branching, dynamically-fanned run stays readable."""
        lines = [f'digraph "{self.name or "taskgraph"}" {{']
        idx = {id(t): i for i, t in enumerate(self.tasks)}
        next_id = len(self.tasks)
        clusters: list[tuple[Task, list[Task]]] = []
        for t in self.tasks:
            shape = ', shape=diamond' if t.is_condition else ""
            lines.append(f'  n{idx[id(t)]} [label="{t.name}"{shape}];')
            if t._spawned:
                clusters.append((t, t._spawned))
        for spawner, spawned in clusters:
            lines.append(f'  subgraph "cluster_{idx[id(spawner)]}" {{')
            lines.append(f'    label="{spawner.name}::subflow"; style=dashed;')
            for st in spawned:
                if id(st) not in idx:
                    idx[id(st)] = next_id
                    next_id += 1
                lines.append(f'    n{idx[id(st)]} [label="{st.name}"];')
            lines.append("  }")
            for st in spawned:
                if st.is_source:
                    lines.append(
                        f"  n{idx[id(spawner)]} -> n{idx[id(st)]} [style=dotted];"
                    )
        for t in list(self.tasks) + [st for _, sp in clusters for st in sp]:
            style = ' [style=dashed, label="{}"]' if t.is_condition else ""
            for branch, s in enumerate(t.successors):
                if id(s) not in idx:
                    continue
                attr = style.format(branch) if style else ""
                lines.append(f"  n{idx[id(t)]} -> n{idx[id(s)]}{attr};")
        lines.append("}")
        return "\n".join(lines)

    # -- protocol ------------------------------------------------------------------

    def __iter__(self) -> Iterator[Task]:
        return iter(self.tasks)

    def __len__(self) -> int:
        return len(self.tasks)
