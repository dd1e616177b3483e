"""ThreadPool-driven input pipeline: the dataflow runtime in production.

Ported from the reference's ``repro/data/pipeline.py`` onto the port's own
``core`` copy. The one change is the transform: where the reference's
default is a jax device put, the port's moves each numpy batch to a torch
device given explicitly (``device=``; ``cuda:0`` unless the caller passes
another, raising without a GPU). It is a plain blocking copy on the
device's default stream, so the consumer's kernels, queued on the same
stream, are ordered after it. On the process and socket backends the
transform runs in a worker process, which must not touch the device (a
process forked from one that holds a CUDA context cannot use CUDA): there
the caller passes a numpy-level ``put_fn`` and moves the delivered batches
to the device itself, as the reference asks for a numpy-level transform.

Each prefetch lane is one **condition-looped dataflow graph**
(DESIGN.md §10)

    entry -> produce (CPU, numpy) -> transform (device_put) -> deliver
               ^                                                  |
               '---------------- more? (condition) <--------------'

built once per lane and submitted through the :class:`Executor` facade.
The condition task closes the cycle with a weak back-edge: while steps are
assigned to the lane it returns branch 0 (loop — the next produce starts
*inside the pool*, no Python-side resubmission, no submit syscall per
step), and when the lane's queue is empty it returns an out-of-range index
and the run drains. The host batch flows produce→transform→deliver along
value edges as before; each pass of the deliver task resolves that step's
future from its completion callback. A lane is only re-*submitted* when a
step arrives after its loop exited — under a steady consumer the graph
loops in the workers indefinitely.

Lane graphs are built once and never mutated, so every re-submission
after the first replays the lane's captured
:class:`~repro_torch.core.ReplayPlan` (DESIGN.md §12): restarting an idle lane
is a plan re-arm — no per-task reset walk, no re-wiring beyond the §11
placement refresh — and the produce→transform→deliver loop runs as fused
replay segments.

``depth`` lanes run concurrently on the work-stealing pool, so host-side
data work overlaps device steps (the GIL-releasing regime the pool
targets — DESIGN.md §2). The pipeline cursor is just the step index:
checkpointable and restorable with no draining protocol. Straggler
mitigation falls out of work stealing, and ``depth`` bounds how far ahead
we buffer.

Cancellation (``close``) became *queue-side*: cancelling a step's future
removes it from its lane's queue before the source ever sees it; the pass
already producing is drained cooperatively and each exited loop winds down
through its condition task, so a shared pool comes back clean.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Optional

import torch

from ..core import Executor, Future, RetryPolicy, Task, TaskGraph, ThreadPool
from ..models.common import resolve_device


def to_device(batch: dict, device) -> dict:
    """Each numpy array of ``batch`` as a tensor on ``device``: a blocking
    copy on the device's default stream."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _SkipSentinel:
    """Sentinel batch for a pass whose step was cancelled away.

    Pickles back to the module singleton so identity checks (``b is
    _SKIP``) survive the process backend's worker boundary."""

    def __reduce__(self):
        return (_get_skip, ())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<_SKIP>"


def _get_skip() -> "_SkipSentinel":
    return _SKIP


_SKIP = _SkipSentinel()


class _Lane:
    """One condition-looped produce→transform→deliver graph.

    A lane owns a queue of assigned steps. Passes are serialized by the
    graph's own cycle (produce k+depth cannot start before the condition
    task of pass k chose to loop), so the mutable ``_current`` cell and
    the per-step future map are guarded only against the assigning
    consumer thread.
    """

    __slots__ = (
        "graph",
        "produce",
        "transform",
        "deliver",
        "cond",
        "_exec",
        "_source",
        "_lk",
        "_pending",
        "_futures",
        "_running",
        "_run_future",
        "_current",
    )

    def __init__(
        self,
        index: int,
        source: Any,
        put_fn: Callable[[dict], Any],
        executor: Executor,
        transform_retry: Optional[RetryPolicy] = None,
    ) -> None:
        self._exec = executor
        self._source = source
        self._lk = threading.Lock()
        self._pending: deque[int] = deque()
        self._futures: dict[int, Future] = {}
        self._running = False
        self._run_future: Optional[Future] = None
        self._current: Optional[int] = None
        g = TaskGraph(f"prefetch-lane{index}")
        entry = g.add(None, name=f"entry:{index}")
        # produce is pinned in-parent BY CONTRACT, not by the accident of
        # its bound method failing to pickle: it mutates lane state under
        # _lk and pulls from the user's source, and pickling would walk
        # the whole source object graph at submit just to fail on the lock
        self.produce = g.add(self._produce, name=f"produce:{index}", affinity="local")
        self.produce.after(entry)
        # transform is the lane's only remote-eligible body: on the process
        # backend the CPU-bound batch transform escapes the GIL while
        # produce (stateful bound method) and deliver (identity — a round
        # trip would ship the batch twice for nothing) stay in-parent
        self.transform = g.then(
            self.produce,
            lambda b: b if b is _SKIP else put_fn(b),
            name=f"transform:{index}",
        )
        if transform_retry is not None:
            # §14: the transform is the lane's only stateless body (pure
            # batch -> batch), so it alone may carry a retry policy —
            # produce mutates lane state and must stay exactly-once
            self.transform.retry_policy = transform_retry
            self.transform.idempotent = True
        self.deliver = self.transform.then(lambda b: b, name=f"deliver:{index}")
        self.deliver.affinity = "local"
        self.cond = g.add(self._more, kind="condition", name=f"more:{index}")
        self.cond.after(self.deliver)
        self.cond.precede(self.produce)  # branch 0: weak back-edge, loop
        for t in g.tasks:
            t.propagate_errors = False  # lane errors go to step futures only
        self.deliver.on_done = self._resolve
        self.graph = g

    # -- pool-side (worker threads) -------------------------------------------

    def _produce(self) -> Any:
        with self._lk:
            if not self._pending:  # every queued step was cancelled away
                self._current = None
                return _SKIP
            self._current = self._pending.popleft()
        return self._source.batch(self._current)

    def _more(self) -> int:
        """Condition body: loop while steps are queued, else exit."""
        with self._lk:
            if self._pending:
                return 0  # branch 0 -> produce (weak back-edge)
            self._running = False
            return 1  # out of range -> the run drains

    def _resolve(self, task: Task) -> None:
        with self._lk:
            fut = self._futures.pop(self._current, None)
        if fut is None:  # _SKIP pass, or the step's future was cancelled
            return
        if task.exception is not None:
            fut.set_exception(task.exception)
        else:
            fut.set_result(task.result)

    # -- consumer-side ---------------------------------------------------------

    def assign(self, step: int) -> Future:
        """Queue ``step`` on this lane; restart the loop if it had exited.

        The restart waits out the previous run's drain first — resetting a
        graph whose condition task is still completing would race its
        fan-out (§10: rounds are sequential per graph).
        """
        fut = Future(canceller=lambda: self._cancel_step(step))
        with self._lk:
            self._pending.append(step)
            self._futures[step] = fut
            start = not self._running
            if start:
                self._running = True
        if start:
            rf = self._run_future
            if rf is not None:
                try:
                    rf.result(60)
                except BaseException:  # noqa: BLE001 - old run's verdict is per-step
                    if not rf.done():
                        # the drain timed out: the old run still owns the
                        # graph's task state — resubmitting now would race
                        # its fan-out. Roll the step back out of the lane
                        # (no orphaned queue entry for a run that never
                        # started) and deliver the failure through the
                        # step's own future, where the consumer reads it.
                        with self._lk:
                            try:
                                self._pending.remove(step)
                            except ValueError:
                                pass
                            self._futures.pop(step, None)
                            self._running = False
                        fut.set_exception(
                            TimeoutError(
                                "prefetch lane restart: previous loop still draining"
                            )
                        )
                        return fut
            self._run_future = self._exec.run(self.graph)  # counted submission re-arms
        return fut

    def _cancel_step(self, step: int) -> bool:
        """True iff the step was still queued — the source never sees it."""
        with self._lk:
            try:
                self._pending.remove(step)
            except ValueError:
                return False  # already producing (or done): cooperative drain
            self._futures.pop(step, None)
            return True

    def drain(self, timeout: float) -> None:
        if self._run_future is not None:
            try:
                self._run_future.result(timeout)
            except BaseException:  # noqa: BLE001 - drain only; verdicts are per-step
                pass


class Prefetcher:
    """Ordered prefetching over condition-looped lane graphs (module docs).

    ``backend`` selects the execution backend for an *owned* pool (the
    same ``"thread"`` / ``"process"`` / ``"socket"`` / ``"serial"``
    switch as :class:`~repro_torch.core.Executor`; ignored when ``pool`` is
    given). With ``backend="process"`` (or ``"socket"``) each lane's
    transform body runs in a worker process — CPU-bound transforms
    (tokenization, augmentation, numpy-side preprocessing) overlap truly
    in parallel. Pass a numpy-level ``put_fn`` in that case: the default
    transform moves every array to ``device`` (:func:`to_device`), which
    must happen in this process, so it belongs on the thread backend.
    """

    def __init__(
        self,
        source: Any,  # .batch(step) -> dict of np arrays
        *,
        pool: Optional[ThreadPool] = None,
        backend: Optional[str] = None,
        depth: int = 2,
        start_step: int = 0,
        put_fn: Optional[Callable[[dict], Any]] = None,
        transform_retry: Optional[RetryPolicy] = None,  # §14: retry flaky transforms
        device=None,  # where the default put_fn sends each batch
    ) -> None:
        self.source = source
        if pool is not None and backend is not None:
            # same contract as Executor: a silently ignored backend= would
            # leave CPU-bound transforms GIL-serialized with no signal
            raise ValueError("pass either backend= or pool=, not both")
        if pool is not None:
            self.pool = pool
            self._own_pool = False
            self._exec = Executor(pool=self.pool)
        else:
            self._exec = Executor(2, backend=backend, name="prefetch")
            self.pool = self._exec.pool
            self._own_pool = True
        if self._exec.backend in ("process", "socket") and put_fn is None:
            # checked against the *resolved* backend (a ProcessPool or
            # SocketPool handed in via pool= must not bypass it): the
            # default transform puts each batch on a torch device, which a
            # worker forked from this process must not touch. Fail loudly
            # instead of falling back to another backend.
            if self._own_pool:
                self._exec.close()
            raise ValueError(
                f'Prefetcher on a {self._exec.backend} backend requires an '
                "explicit numpy-level put_fn: the default device transform "
                "belongs on the thread backend (DESIGN.md §11). "
                'Pass put_fn=<numpy transform>, or use backend="thread".'
            )
        if put_fn is None:
            try:
                dev = resolve_device(device)
            except BaseException:
                if self._own_pool:
                    self._exec.close()
                raise
            put_fn = lambda b: to_device(b, dev)  # noqa: E731
        self.depth = max(1, depth)
        self.put_fn = put_fn
        self._lanes = [
            _Lane(i, source, self.put_fn, self._exec, transform_retry)
            for i in range(self.depth)
        ]
        self._inflight: dict[int, Future] = {}
        self._next_submit = start_step
        self._next_read = start_step
        for _ in range(self.depth):
            self._submit_one()

    # -- internals ------------------------------------------------------------

    def _submit_one(self) -> None:
        step = self._next_submit
        self._next_submit += 1
        lane = self._lanes[step % self.depth]
        self._inflight[step] = lane.assign(step)

    # -- public ------------------------------------------------------------------

    def get(self, timeout: float = 120.0) -> Any:
        """Next batch, in order; refills the prefetch window."""
        step = self._next_read
        self._next_read += 1
        fut = self._inflight.pop(step)
        batch = fut.result(timeout)
        self._submit_one()
        return batch

    @property
    def cursor(self) -> int:
        """Checkpointable resume point (first unconsumed step)."""
        return self._next_read

    def close(self, timeout: float = 30.0) -> None:
        """Cancel or drain every in-flight step, then release the pool.

        Steps still queued on their lane are cancelled (the source never
        sees them); the pass already producing is drained — abandoning it
        would leave ``batch()`` racing a closed pool, and on a shared pool
        it would leak tasks into the next user. Each lane's condition loop
        then drains itself, so the pool comes back quiescent.
        """
        # cancel pass first (stops everything not yet started), then drain
        # the stragglers — cancelling before draining minimizes wasted work
        running = [fut for fut in self._inflight.values() if not fut.cancel()]
        for fut in running:
            try:
                fut.result(timeout)
            except BaseException:  # noqa: BLE001 - drain only; result unused
                pass
        self._inflight.clear()
        for lane in self._lanes:
            lane.drain(timeout)
        if self._own_pool:
            self.pool.close()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
