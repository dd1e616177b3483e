"""Process-pool execution backend: scheduler in the parent, bodies in
worker processes (DESIGN.md §11).

The GIL caps the thread backend at one CPU-bound *body* at a time; this
backend removes the cap without forking the scheduler. :class:`ProcessPool`
**is** a :class:`~repro_torch.core.ThreadPool` — countdown tokens, condition
branches, subflow splices, counted completion, priorities, observers and
idle accounting all run unchanged in the parent — whose dispatcher threads
act as proxies: executing a *wired* task means sending ``(job_id, fn_wire,
args_wire)`` down a dedicated pipe to a paired worker process and blocking
(GIL released) on the reply. Everything the §9/§10 scheduler guarantees
holds verbatim, because the scheduler never moved.

Placement (DESIGN.md §11): conditions, ``takes_runtime`` spawners and
``fn=None`` bookkeeping tasks always run in-parent (they drive the
scheduler); ``affinity="local"`` pins a body in-parent; the default
``affinity="any"`` offloads when the body serializes and quietly runs
in-parent when it does not; ``affinity="remote"`` demands offload and
raises :class:`~repro_torch.dist.wire.UnpicklableTaskError` **at submit** when
the body cannot ship. Remote bodies see a snapshot of their closures —
mutations do not travel back; results, exceptions and dataflow edge
values do (large arrays via the shared-memory arena).

Fault model (DESIGN.md §14): a worker that dies fails **that task** with
:class:`WorkerDiedError` — the dispatcher thread observes the broken
pipe, respawns a fresh worker, and the failure takes the normal §8 route
(dataflow adoption / future delivery / ``wait_idle`` raise). The pool
never hangs on a dead worker and never loses capacity. The error's
``started`` flag records *when* the worker died: ``False`` means the job
never left the parent (send hit a closed pipe — always safe to retry, and
the pool's implicit transport-loss :class:`~repro_torch.core.RetryPolicy`
resubmits it once through the normal §14 machinery), ``True`` means the
body may have partially run. Started bodies are at-most-once by default —
retried only for tasks declared ``idempotent=True`` (and then only under
a matching policy, implicit or task-supplied). Tasks with ``timeout=``
get a hard watchdog: a timer kills the stuck worker process, the
dispatcher's blocked ``recv`` sees EOF, and the task fails with
:class:`~repro_torch.core.TaskTimeoutError` instead.

Replay (DESIGN.md §12) composes through the two §11 seams rather than
around them: a captured :class:`~repro_torch.core.ReplayPlan` re-arm calls
``_wire_tasks`` over the *member* tasks every pass, so placement decisions
(and any ``fn`` rebinding a consumer did between passes) are re-evaluated
exactly as a live submission would, and the replay run loop offloads each
wired member through ``_offload`` — fused segments ship their bodies one
by one, they are never serialized as a unit.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
from typing import Any, Optional, Sequence

from ..core.pool import ThreadPool
from ..core.task import RetryPolicy, Task, TaskTimeoutError

from .shm_arena import DEFAULT_THRESHOLD, ShmArena
from .wire import (
    UnpicklableTaskError,
    dumps_args,
    dumps_fn,
    loads_exception,
    loads_value,
    shm_refs,
)
from .worker import worker_main

__all__ = ["ProcessPool", "WorkerDiedError"]


class WorkerDiedError(RuntimeError):
    """The worker process assigned a task body died before replying.

    ``started`` gates the §14 retry decision: ``False`` means the job never
    reached the worker (the send hit a closed pipe) so a retry cannot
    double-execute anything; ``True`` means the body may have partially run
    — the pool retries it only for ``idempotent=True`` tasks. Either way
    the worker is respawned and the pool keeps serving.
    """

    def __init__(self, message: str, *, started: bool = False) -> None:
        super().__init__(message)
        self.started = started


# Transport loss is the pool's fault, not the body's: one implicit retry
# (DESIGN.md §14) replaces the old hardcoded "retry the send once" path,
# so send failures flow through the same observable machinery (on_retry,
# stats()["retries"]) as user-declared policies.
_TRANSPORT_RETRY = RetryPolicy(max_attempts=2, backoff=0.0, retry_on=WorkerDiedError)


class _WireError:
    """Deferred submit-time wiring failure for runtime-spawned tasks.

    Spawned tasks are wired inside the scheduler loop, where raising would
    poison the worker — instead the error is parked on ``task._wire`` and
    raised when the task body runs, taking the normal failure route.
    """

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc

    def raise_(self, _fn: Any, _args: tuple) -> None:
        raise self.exc


class ProcessPool(ThreadPool):
    """Work-stealing scheduler whose task bodies run in worker processes.

    Drop-in for :class:`~repro_torch.core.ThreadPool` (same submit / wait_idle /
    observer / stats surface — ``Executor(backend="process")`` is the
    usual front door). One worker process and one dispatcher thread per
    slot; jobs and small values cross per-worker pipes, large arrays cross
    the shared-memory arena.

    Parameters
    ----------
    num_workers:
        Worker-process count (default ``os.cpu_count()``). Also the
        dispatcher-thread count in the parent.
    arena_threshold:
        Minimum array size (bytes) to route through shared memory instead
        of pickle (``repro_torch.dist.shm_arena.DEFAULT_THRESHOLD`` = 32 KiB).
    arena_max_pooled:
        Cap on pooled arena segments (``None`` = unbounded). At the cap,
        oversize argument arrays degrade to one-shot ephemeral segments
        instead of growing the pool — see :meth:`ShmArena.stats
        <repro_torch.dist.shm_arena.ShmArena.stats>`.
    mp_context:
        ``"fork"`` (default where available — cheap, inherits imported
        modules so lambdas defined anywhere resolve) or ``"spawn"``
        (slower, but immune to fork-with-threads hazards; bodies must live
        in importable modules).
    name, observers, deque_cls:
        Forwarded to :class:`~repro_torch.core.ThreadPool`.

    Same pool surface, bodies in other processes::

        >>> from repro_torch.dist import ProcessPool
        >>> with ProcessPool(2) as pool:
        ...     fut = pool.submit_future(lambda: sum(i * i for i in range(100)))
        ...     fut.result(30)
        328350
    """

    def __init__(
        self,
        num_workers: Optional[int] = None,
        *,
        arena_threshold: int = DEFAULT_THRESHOLD,
        arena_max_pooled: Optional[int] = None,
        mp_context: Optional[str] = None,
        name: str = "repro-procpool",
        observers: Sequence[Any] = (),
        **pool_kwargs: Any,
    ) -> None:
        n = num_workers if num_workers is not None else (os.cpu_count() or 1)
        if n < 1:
            raise ValueError("num_workers must be >= 1")
        ctx_name = mp_context or (
            "fork" if "fork" in mp.get_all_start_methods() else "spawn"
        )
        self._mp = mp.get_context(ctx_name)
        self._arena = ShmArena(arena_threshold, max_pooled=arena_max_pooled)
        self._worker_name = name
        self._conns: list[Any] = [None] * n
        self._procs: list[Any] = [None] * n
        self._job_seq = [0] * n  # per-worker job ids (one in flight each)
        self._remote_jobs = [0] * n
        self._restarts = [0] * n
        self._worker_kills = [0] * n  # watchdog SIGKILLs (§14 hard timeout)
        self._current_remote: list[Any] = [None] * n  # in-flight task per slot
        self._proc_lock = threading.Lock()  # serializes respawn bookkeeping
        # workers first (before any parent thread exists — fork safety),
        # then the scheduler, then the dispatch hooks
        for i in range(n):
            self._start_worker(i)
        super().__init__(n, name=name, observers=observers, **pool_kwargs)
        self._wire_tasks = self._wire_graph
        self._offload = self._offload_body

    # -- wiring (submit-time) ---------------------------------------------------

    def _wire_graph(self, tasks: Any, *, defer: bool = False) -> None:
        """Serialize every eligible body in ``tasks`` (the §11 placement
        rule); called by the base pool at each submission entry point and,
        with ``defer=True``, for runtime-spawned subflows."""
        for t in tasks:
            t._wire = self._wire_for(t, defer)

    @staticmethod
    def _wire_for(t: Task, defer: bool) -> Any:
        if (
            t.fn is None
            or t.takes_runtime
            or t.kind == "condition"
            or t.affinity == "local"
        ):
            return None  # scheduler-side by rule
        try:
            return dumps_fn(t.fn)
        except UnpicklableTaskError as exc:
            if t.affinity == "remote":
                err = UnpicklableTaskError(
                    f"task {t.name or t.fn!r} has affinity='remote' but its "
                    f"body cannot be shipped to a worker process: {exc}"
                )
                if defer:
                    return _WireError(err)
                raise err from exc
            return None  # affinity="any": quiet in-parent fallback

    # -- dispatch (worker-thread side) ------------------------------------------

    def _offload_body(self, task: Task, index: int) -> None:
        """Body-execution seam bound into ``ThreadPool._execute``."""
        wire = task._wire
        if wire is None:
            task.run()
        elif type(wire) is _WireError:
            task.run(invoke=wire.raise_)
        else:
            task.run(
                invoke=lambda fn, args: self._remote_call(index, wire, args, fn, task)
            )

    def _remote_call(
        self, index: int, fn_wire: tuple, args: tuple, fn: Any, task: Task
    ) -> Any:
        """Ship one job to worker ``index`` and block for its verdict."""
        self._job_seq[index] += 1
        job_id = self._job_seq[index]
        try:
            args_wire = dumps_args(args, self._arena)
        except Exception as exc:
            # the §11 "any" fallback extends to edge values: a dataflow
            # input that cannot cross the boundary runs the body in-parent
            # (thread/serial parity) — affinity="remote" keeps the clear
            # contract error instead of a raw pickle TypeError
            if task.affinity == "remote":
                raise UnpicklableTaskError(
                    f"task {task.name or fn!r} has affinity='remote' but a "
                    "dataflow input cannot be shipped to a worker process: "
                    f"{exc}"
                ) from exc
            return fn(*args)
        refs = shm_refs(args_wire)
        watched = task.timeout is not None
        if watched:
            # arm the §14 watchdog: remote bodies cannot reach the parent's
            # cooperative checkpoint, so the deadline escalates to a kill
            task._timed_out = False  # a prior kill may have raced the reply
            self._current_remote[index] = task
            self._timer_get().add(
                time.monotonic() + task.timeout,
                lambda a=task._attempt: self._hard_timeout(task, index, a),
            )
        try:
            conn = self._conns[index]
            try:
                conn.send((job_id, fn_wire, args_wire))
            except (BrokenPipeError, OSError):
                # worker died while idle: the job never left the parent —
                # respawn, then let the implicit transport-loss RetryPolicy
                # resubmit through the normal §14 scheduler path
                self._respawn(index)
                raise WorkerDiedError(
                    f"worker process {index} died before accepting a job",
                    started=False,
                ) from None
            try:
                reply = conn.recv()
            except (EOFError, OSError):
                # died mid-job: restore capacity, then fail the task —
                # TaskTimeoutError when the watchdog pulled the trigger,
                # WorkerDiedError(started=True) (at-most-once unless the
                # task declared itself idempotent) otherwise
                self._respawn(index)
                if task._timed_out:
                    raise TaskTimeoutError(
                        f"task {task.name!r} exceeded its {task.timeout}s "
                        f"timeout (worker process {index} killed)"
                    ) from None
                raise WorkerDiedError(
                    f"worker process {index} died while executing a task body",
                    started=True,
                ) from None
        finally:
            if watched:
                with self._proc_lock:  # fences the watchdog's is-check
                    self._current_remote[index] = None
            for ref in refs:
                self._arena.recycle(ref)
        jid, ok, payload = reply
        if jid != job_id:  # can only happen after a half-delivered respawn
            self._respawn(index)
            raise WorkerDiedError(f"worker {index} protocol desync (job {jid}!={job_id})")
        self._remote_jobs[index] += 1
        if ok:
            return loads_value(payload, self._arena)
        raise loads_exception(payload)

    # -- fault tolerance (DESIGN.md §14) -----------------------------------------

    def _retry_policy_for(self, task: Task, exc: BaseException) -> Any:
        """Task policy first (base rule); otherwise the implicit one-shot
        transport-loss retry for :class:`WorkerDiedError`. The base pool's
        at-most-once gate still blocks ``started=True`` losses for
        non-idempotent tasks regardless of which policy matched."""
        pol = super()._retry_policy_for(task, exc)
        if pol is None and isinstance(exc, WorkerDiedError):
            return _TRANSPORT_RETRY
        return pol

    def _hard_timeout(self, task: Task, index: int, attempt: int) -> None:
        """Timer-thread callback: SIGKILL the worker still running ``task``.

        The (task, attempt) pair guards against firing late — if the slot
        has moved on, or this very task was already retried onto a new
        attempt, the deadline belonged to an execution that no longer
        exists and the callback is a no-op.
        """
        with self._proc_lock:
            if self._current_remote[index] is not task or task._attempt != attempt:
                return
            task._timed_out = True
            self._worker_kills[index] += 1
            proc = self._procs[index]
        if proc is not None:
            proc.kill()  # dispatcher's recv sees EOF -> TaskTimeoutError

    # -- worker lifecycle --------------------------------------------------------

    def _start_worker(self, index: int) -> None:
        import warnings

        parent_conn, child_conn = self._mp.Pipe()
        proc = self._mp.Process(
            target=worker_main,
            args=(child_conn, self._arena.threshold),
            name=f"{self._worker_name}-w{index}",
            daemon=True,
        )
        with warnings.catch_warnings():
            # jax warns that fork + its internal threads can deadlock; the
            # worker loop never touches jax (device work stays on the
            # thread backend — DESIGN.md §11) and imports nothing new
            # post-fork. mp_context="spawn" exists for the cautious.
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning
            )
            proc.start()
        child_conn.close()  # parent keeps one end; EOF now means worker death
        self._conns[index] = parent_conn
        self._procs[index] = proc

    def _respawn(self, index: int) -> None:
        with self._proc_lock:
            self._restarts[index] += 1
            old_conn, old_proc = self._conns[index], self._procs[index]
            try:
                old_conn.close()
            except Exception:
                pass
            if old_proc is not None:
                old_proc.join(timeout=0.1)
                if old_proc.is_alive():  # pipe broke but process wedged
                    old_proc.terminate()
                    old_proc.join(timeout=1.0)
                try:
                    # release the dead worker's sentinel + pipe FDs *now* —
                    # parking them on the GC leaks FDs for the life of a
                    # draining pool (kill/respawn churn under chaos)
                    old_proc.close()
                except Exception:
                    pass
            self._start_worker(index)

    # -- lifecycle / stats -------------------------------------------------------

    def stats(self) -> dict[str, int]:
        """Base pool counters plus ``remote_jobs`` (bodies executed in
        worker processes), ``worker_restarts`` (respawns after death),
        ``worker_kills`` (§14 watchdog SIGKILLs of timed-out workers) and
        the nested ``arena`` segment-recycling counters (see
        :meth:`ShmArena.stats <repro_torch.dist.shm_arena.ShmArena.stats>`)."""
        out = super().stats()
        out["remote_jobs"] = sum(self._remote_jobs)
        out["worker_restarts"] = sum(self._restarts)
        out["worker_kills"] = sum(self._worker_kills)
        out["arena"] = self._arena.stats()
        return out

    def close(self) -> None:
        """Stop dispatcher threads, then shut workers down and release the
        arena. In-flight bodies finish (their replies drain the pipes);
        queued-but-unstarted tasks are abandoned, as in the base pool."""
        if self._stop:
            return
        super().close()  # joins dispatcher threads; replies drain first
        for conn in self._conns:
            try:
                conn.send(None)  # shutdown sentinel
            except Exception:
                pass
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=5.0)
            if proc.is_alive():  # pragma: no cover - wedged worker safety net
                proc.terminate()
                proc.join(timeout=1.0)
            try:
                proc.close()  # release sentinel FDs with the pool, not the GC
            except Exception:
                pass
        for conn in self._conns:
            try:
                conn.close()
            except Exception:
                pass
        self._arena.close()
