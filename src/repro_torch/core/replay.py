"""Graph capture & replay: compiled steady-state dispatch (DESIGN.md §12).

The §9 scheduler pays full dependency-counting dispatch on every pass —
per-task claim, fan-out decrement, inline pick, idle check — yet the
dominant workloads (serve decode ticks, prefetch lanes, checkpoint shards,
training steps) re-run the *same* graph shape thousands of times. This
module compiles a settled :class:`~repro_torch.core.TaskGraph` into a
:class:`ReplayPlan`: a **shadow meta-graph** of :class:`_SegTask` nodes,
each wrapping a maximal fused chain of member tasks, wired among
themselves with the ordinary countdown machinery. Replaying a pass then
dispatches O(#segments) scheduler events instead of O(#tasks) — a
chain(8192) collapses to a single meta node whose body is one tight
member loop.

Design rules (the ones that make this safe, in order of importance):

* **User tasks are never rewired.** The plan wraps; it does not mutate
  ``successors``/``inputs``/``num_predecessors`` of any member. Live
  dispatch of the same graph therefore stays valid at all times — a
  dropped plan falls back to ``ThreadPool.submit``'s ordinary walk with
  zero repair work, and plan compilation may even overlap a running pass
  (it only reads structure).

* **Fusion is structural, not trace-based.** Member ``v`` fuses behind
  ``u`` iff ``u`` is static, not a spawner, and has exactly one successor
  ``v`` whose only in-edge is that one (no weak in-edges), with equal
  ``priority`` and ``propagate_errors``. A condition task may terminate a
  segment (the meta node becomes ``kind="condition"`` and copies the
  tail's integer verdict, so ``select_branch`` picks among *pre-bound*
  weak meta-edges); ``takes_runtime`` spawners are forced singletons.
  Because branch targets are ordinary meta successors, a condition that
  **branches differently** between passes replays natively — the branch
  table subsumes outcome matching, which is what lets the serve tick and
  prefetch lanes (whose loop counts change every pass) keep one plan.

* **The countdown flattens.** Interior members (in-degree 1 by the fusion
  rule) are never decremented under replay; only meta nodes carry live
  countdowns, re-armed from per-plan prototype tuples. Plan re-arm —
  the replacement for ``TaskGraph.reset()``'s O(n) walk plus per-task
  ``reset()`` at submit — is a slim slice-assign loop: members get claim
  + flags only (``run()`` clears stale results/exceptions itself), metas
  get the prototype refill.

* **Segments run through the ordinary pool.** ``_SegTask`` goes through
  ``_schedule``/``_execute``/``_finish_slow`` unchanged; its ``run()``
  override executes the member protocol inline: claim race, poison
  check, §11 ``_offload`` per member, observer ``on_start``/``on_finish``
  per member, ``on_done`` callbacks, loop-mode ``rearm()``. Observer
  streams therefore stay truthful per *member* (the pool routes queue
  events to ``seg.first`` and suppresses seg-level start/finish).

* **Divergence falls back, then self-heals.** The fingerprint is the
  graph's ``_epoch`` counter (bumped by every ``add``/``adopt``/
  ``succeed``/``after``) plus pool identity plus a divergence flag set by
  cancellation or a failed pass. An unusable plan is dropped at
  submission: that pass dispatches live (whose full reset clears stale
  exceptions/claims), and the next settled pass recompiles.

* **§11 composition.** On a process backend, plan re-arm refreshes the
  members' body wires through the pool's ``_wire_tasks`` seam every pass
  — identical placement semantics to live submission (rebinding
  ``task.fn`` between passes stays correct on both backends). Spawner
  members replay as live singleton islands: the meta proxies the member
  body, the subflow splices fresh each pass (runtime-sized shape changes
  are absorbed, not invalidated), and the hidden join releases the
  spawner's *meta* successors.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from .pool import ThreadPool, _current, _Retry
from .task import CancelledError, Task, TaskTimeoutError, iter_graph

__all__ = ["ReplayPlan", "compile_plan", "replay_eligible"]

_CLAIM = (0,)


class _SegTask(Task):
    """One replay meta node: a fused run of 1..k member tasks.

    Scheduled and fanned out by the ordinary pool machinery; ``run()``
    executes every member inline (module docs). ``first`` is the head
    member — the pool substitutes it in queue-side observer events so
    traces and counters name real tasks, never plan internals.
    """

    __slots__ = ("steps", "first", "_pool", "_rearm_members", "_resume_at")

    _seg = True

    def __init__(self, steps: list, pool: "ThreadPool", *, loop_mode: bool) -> None:
        head, tail = steps[0], steps[-1]
        super().__init__(
            None,
            name=f"replay:{head.name or 'seg'}",
            priority=head.priority,
            kind="condition" if tail.kind == "condition" else "static",
            takes_runtime=head.takes_runtime,
        )
        self._explicit_pr = head._explicit_pr
        self.propagate_errors = head.propagate_errors
        self.steps = steps
        self.first = head
        self._pool = pool
        # loop mode (counted/condition graphs): members self-rearm after
        # each pass so a weak meta back-edge finds them armed, and the meta
        # re-arms through the ordinary auto_rearm protocol in _finish_slow.
        self._rearm_members = loop_mode
        self.auto_rearm = loop_mode
        if loop_mode:
            self._slow = True
        # §14: after a retriable member failure the segment requeues itself
        # and resumes at the failed member — earlier members never re-run.
        self._resume_at = 0

    def run(self, runtime: Any = None, invoke: Any = None) -> None:
        if runtime is not None:
            # spawner proxy (singleton segment): the wrapped member runs
            # with the Runtime so results/exceptions/_spawned land where
            # dataflow consumers and the graph resolver read them; the
            # verdict is mirrored onto the meta because _finish_slow's
            # splice guard and the hidden join's unwrap operate on the
            # dispatched task (this node).
            inner = self.first
            inner._spawned = runtime.sub.tasks
            try:
                inner.run(runtime)
            except BaseException as exc:
                if inner.exception is None:
                    inner.exception = exc
                raise
            finally:
                self.result = inner.result
                self.exception = inner.exception
            return
        try:
            self._claim.pop()
        except IndexError:  # defensive: mirrors Task.run's cancel arm
            self.exception = CancelledError("task cancelled")
            self._done = True
            return
        self._started = True
        self.exception = None
        pool = self._pool
        index = pool._tls.index
        off = pool._offload
        observers = pool._observers
        rearm = self._rearm_members
        steps = self.steps
        start = self._resume_at
        if start:  # resuming a §14 retried pass mid-segment
            self._resume_at = 0
            steps_iter = steps[start:]
        else:
            steps_iter = steps
        for t in steps_iter:
            if observers:
                pool._notify("on_start", t, index)
            if t.timeout is not None:  # §14 member deadline (rare branch)
                _current.task = t
                _current.deadline = time.monotonic() + t.timeout
            try:
                if pool._first_error is not None and t.propagate_errors:
                    # fail-fast parity with _execute: skip bodies once the
                    # graph is poisoned, keep draining so waiters unblock
                    t.exception = CancelledError("predecessor failed")
                    t._done = True
                elif off is not None:
                    off(t, index)  # §11 seam: per-member placement
                else:
                    t.run()
            except BaseException as exc:  # noqa: BLE001 - recorded, pool-funneled
                if isinstance(exc, TaskTimeoutError):
                    pool._timeouts[index] += 1
                    if observers:
                        pool._notify("on_timeout", t, index)
                pol = pool._retry_policy_for(t, exc)
                if (
                    pol is not None
                    and not (getattr(exc, "started", False) and not t.idempotent)
                    and t._attempt + 1 < pol.max_attempts
                ):
                    # §14 member retry: re-arm the member and the segment,
                    # record the resume point, and signal _execute to
                    # requeue this node whole. Members before `t` stay
                    # completed; a retried-to-success pass leaves no trace
                    # (the plan stays valid, no divergence).
                    t._attempt += 1
                    if exc.__context__ is None and t._last_exc is not None:
                        exc.__context__ = t._last_exc
                    t._last_exc = exc
                    t._claim[:] = _CLAIM
                    t._started = False
                    t._timed_out = False
                    t.exception = None
                    self._resume_at = steps.index(t)
                    self._claim[:] = _CLAIM
                    self._started = False
                    pool._retries[index] += 1
                    if observers:
                        pool._notify("on_retry", t, t._attempt, index)
                    pool._executed[index] += steps.index(t) - start
                    raise _Retry(pol.delay(t._attempt)) from None
                if (
                    t._last_exc is not None
                    and exc.__context__ is None
                    and exc is not t._last_exc
                ):  # exhausted retries surface the whole attempt chain
                    exc.__context__ = t._last_exc
                t.exception = exc
                if t.propagate_errors:
                    with pool._err_lock:
                        if pool._first_error is None:
                            pool._first_error = exc
            if observers:
                pool._notify("on_finish", t, index)
            cb = t.on_done
            if cb is not None:
                try:
                    cb(t)
                except BaseException:  # noqa: BLE001 - callback errors dropped
                    pass
            if rearm:
                t.rearm()
        # the pool's _execute adds 1 for this node; members make up the rest
        pool._executed[index] += len(steps_iter) - 1
        if self.kind == "condition":
            # select_branch reads the dispatched task: surface the tail's
            # integer verdict (None on a failed/cancelled pass — no branch)
            tail = steps[-1]
            self.result = None if tail.exception is not None else tail.result
        self._done = True


class ReplayPlan:
    """Compiled replay schedule for one (graph, pool) pairing.

    ``usable`` gates every submission: same pool, same structure epoch,
    never diverged. ``rearm`` + ``schedule`` replace the live path's
    O(n) reset walk and source discovery. ``replays`` counts completed
    arm/schedule cycles — tests and consumers use it to *demonstrate*
    that a pass replayed (or fell back).
    """

    __slots__ = (
        "pool",
        "epoch",
        "metas",
        "roots",
        "members",
        "scan_tasks",
        "counted",
        "diverged",
        "replays",
        "_arm",
    )

    def __init__(
        self,
        pool: "ThreadPool",
        epoch: int,
        metas: list,
        roots: list,
        members: list,
        scan_tasks: list,
        counted: bool,
    ) -> None:
        self.pool = pool
        self.epoch = epoch
        self.metas = metas
        self.roots = roots
        self.members = members  # every live task the plan re-arms (incl. fin)
        self.scan_tasks = scan_tasks  # resolver scan set (= graph.tasks snapshot)
        self.counted = counted
        self.diverged = False
        self.replays = 0
        self._arm = [(m, tuple(range(m.num_predecessors))) for m in metas]

    @property
    def segments(self) -> int:
        return len(self.metas)

    @property
    def fused(self) -> int:
        """Members that cost no scheduler dispatch under replay."""
        return len(self.members) - len(self.metas)

    def usable(self, pool: Any, epoch: int) -> bool:
        return not self.diverged and pool is self.pool and epoch == self.epoch

    def rearm(self) -> None:
        """Re-arm every member and meta for the next pass (module docs).

        Members get claim + flags only — ``run()`` clears stale
        results/exceptions at body start, and interior countdowns are
        never popped under replay. On a §11 backend the members' body
        wires are refreshed first, so replay keeps live submission's
        placement semantics exactly.
        """
        wire = self.pool._wire_tasks
        if wire is not None:
            wire(self.members)
        for t in self.members:
            t._claim[:] = _CLAIM
            t._done = False
            t._started = False
            t._cancelled = False
            if t._attempt:  # §14: fresh retry budget per pass (rare branch)
                t._attempt = 0
                t._last_exc = None
        for m, proto in self._arm:
            m._pending[:] = proto
            m._claim[:] = _CLAIM
            m._done = False
            m._started = False
            m._resume_at = 0  # §14 invariant: consumed by pass end; defensive

    def schedule(self, pool: "ThreadPool", ctx: Any = None) -> None:
        """Dispatch the pre-bound roots (counted runs bind ``ctx`` to the
        metas first; the caller has already counted the roots in)."""
        self.replays += 1
        if ctx is not None:
            for m in self.metas:
                m.ctx = ctx
        for r in self.roots:
            pool._schedule(r)


def replay_eligible(pool: Any) -> bool:
    """Plans dispatch through the §9 worker protocol: any ``ThreadPool``
    (the §11 ``ProcessPool`` included), never the serial baselines."""
    return isinstance(pool, ThreadPool) and not pool._stop


def compile_plan(graph: Any, pool: "ThreadPool") -> Optional[ReplayPlan]:
    """Compile ``graph``'s settled structure into a :class:`ReplayPlan`.

    Works over the same reachable closure live submission walks (the
    hidden ``as_future`` completion task included), so plan and live
    dispatch agree on exactly which tasks a pass runs. Returns ``None``
    for shapes that cannot replay (empty graph, wiring that escapes the
    closure, no sources).
    """
    nodes = iter_graph(list(graph.tasks))
    if not nodes:
        return None
    loop_mode = graph._num_conditions > 0
    node_ids = {id(t) for t in nodes}

    # -- chain contraction: mark every fusable edge u -> v ------------------
    absorbed: set = set()
    fused_next: dict = {}
    for u in nodes:
        if u.kind != "static" or u.takes_runtime or len(u.successors) != 1:
            continue
        v = u.successors[0]
        if (
            v is u
            or id(v) not in node_ids
            or v.takes_runtime
            or v.num_predecessors != 1
            or v.num_weak_predecessors != 0
            or v.propagate_errors != u.propagate_errors
            or v.priority != u.priority
        ):
            continue
        absorbed.add(id(v))
        fused_next[id(u)] = v

    # -- build segments from every unabsorbed head --------------------------
    head_meta: dict = {}
    metas: list = []
    for t in nodes:
        if id(t) in absorbed:
            continue
        steps = [t]
        cur = t
        while True:
            nxt = fused_next.get(id(cur))
            if nxt is None:
                break
            steps.append(nxt)
            cur = nxt
        m = _SegTask(steps, pool, loop_mode=loop_mode)
        head_meta[id(t)] = m
        metas.append(m)

    # -- wire the shadow graph: every tail out-edge targets a head ----------
    # (an interior member's single out-edge is its own fusion edge, so a
    # tail's successors are heads by construction; edge multiplicity and
    # branch-index order are preserved verbatim)
    for m in metas:
        tail = m.steps[-1]
        weak = m.kind == "condition"
        for s in tail.successors:
            n = head_meta.get(id(s))
            if n is None:
                return None  # wiring escapes the captured closure
            m.successors.append(n)
            if weak:
                n.num_weak_predecessors += 1
            else:
                n.num_predecessors += 1

    roots = [m for m in metas if m.is_source]
    if not roots:
        return None
    return ReplayPlan(
        pool=pool,
        epoch=graph._epoch,
        metas=metas,
        roots=roots,
        members=nodes,
        scan_tasks=list(graph.tasks),
        counted=loop_mode,
    )
