"""Socket-pool execution backend: scheduler in the parent, bodies on
TCP-connected worker processes — same host or a fleet (DESIGN.md §16).

:class:`SocketPool` is the §11 process backend with the pipe swapped for
a socket. It **is** a :class:`~repro_torch.core.ThreadPool` — countdown tokens,
condition branches, subflow splices, counted completion, priorities,
observers and replay all run unchanged in the parent — whose dispatcher
threads proxy wired bodies over one duplex TCP connection per worker
slot, using the exact same two seams (``_wire_tasks`` / ``_offload``)
and the exact same placement rule as :class:`~repro_torch.dist.ProcessPool`.
The transport details (framing, handshake, job protocol, heartbeats)
live in :mod:`repro_torch.dist.remote_worker`, which both ends share.

Workers join in two ways:

* ``spawn_local=True`` (default): the pool forks ``num_workers`` local
  workers that connect back — a drop-in multi-process backend with a
  socket transport (what the conformance suite runs);
* ``spawn_local=False``: the pool just listens on ``(host, port)`` and
  workers anywhere run ``python -m repro_torch.dist.remote_worker --connect
  host:port``; :attr:`SocketPool.address` is the bound address to hand
  out. Slots fill in connection order; a task dispatched to an empty
  slot waits ``connect_timeout`` for a worker to arrive.

Every connection — local or remote — must pass a mutual HMAC-SHA256
challenge over raw frames before the first pickled byte is read in
either direction (task bodies are code, so the wire protocol is
code-execution-by-design; the :attr:`authkey` is the admission control).
Loopback pools key themselves; a non-loopback bind demands an explicit
``authkey=``. The trust model is documented in
:mod:`repro_torch.dist.remote_worker`.

Fault model (DESIGN.md §14 extended across hosts): every worker loss —
socket EOF, a severed link, a heartbeat lapse — fails *that task* with
:class:`~repro_torch.dist.process_pool.WorkerDiedError`, the slot is respawned
(local) or re-opened for the next connecting worker (remote), and the
failure takes the normal §8 route. ``started=False`` (the job never left
the parent) is always safe to retry and the implicit transport-loss
policy resubmits it once; ``started=True`` (the body may have partially
run) is at-most-once unless the task declared ``idempotent=True``.
Workers pulse a heartbeat frame every ``heartbeat_s`` even while a body
runs, so a silent peer is declared dead after ``liveness_s`` without a
frame — a hang can never outlive the liveness window. ``timeout=`` tasks
get the §14 hard watchdog: local workers are SIGKILLed, remote workers
have their connection severed, and the task fails with
:class:`~repro_torch.core.TaskTimeoutError` either way.

Large arrays ride the per-connection content-hashed
:class:`~repro_torch.dist.shm_arena.TransferCache` instead of the (single-host)
shared-memory arena: a given array's bytes cross each connection once,
repeats ship as 16-byte digests. Each (re)connection gets a fresh cache
on both ends, so a respawn can never resolve a digest its peer lost.
"""
from __future__ import annotations

import ipaddress
import os
import secrets
import socket
import threading
import time
from typing import Any, Optional, Sequence

from ..core.pool import ThreadPool
from ..core.task import Task, TaskTimeoutError

from .process_pool import _TRANSPORT_RETRY, ProcessPool, WorkerDiedError, _WireError
from .remote_worker import (
    DEFAULT_HEARTBEAT_S,
    MAGIC,
    PROTOCOL_VERSION,
    AuthenticationError,
    FramedConn,
    answer_challenge,
    deliver_challenge,
    spawn_workers,
)
from .shm_arena import DEFAULT_THRESHOLD, TransferCache
from .wire import UnpicklableTaskError, dumps_args, loads_exception, loads_value

__all__ = ["SocketPool"]

# a slot claimed by a half-done handshake: reserved, but not dispatchable
_PENDING = object()


def _is_loopback(host: str) -> bool:
    if host in ("localhost", ""):
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class SocketPool(ThreadPool):
    """Work-stealing scheduler whose task bodies run on socket-connected
    worker processes (same host or remote — DESIGN.md §16).

    Drop-in for :class:`~repro_torch.core.ThreadPool` (same submit / wait_idle /
    observer / stats surface — ``Executor(backend="socket")`` is the usual
    front door). One worker connection and one dispatcher thread per slot;
    jobs cross as length-prefixed pickle frames, large arrays ride the
    per-connection transfer cache.

    Parameters
    ----------
    num_workers:
        Worker-slot count (default ``os.cpu_count()``); also the
        dispatcher-thread count in the parent. ``workers=`` is an alias
        (``Executor(backend="socket", workers=4)`` reads naturally).
    host, port:
        Listening address. The default ``("127.0.0.1", 0)`` binds an
        ephemeral localhost port — read :attr:`address` for the actual
        one. Bind ``"0.0.0.0"`` to accept workers from other hosts —
        this *requires* an explicit ``authkey``.
    authkey:
        Shared secret gating every connection: both ends must answer an
        HMAC-SHA256 challenge over raw frames before the first pickled
        byte is accepted (unpickling unauthenticated network data would
        be remote code execution). On a loopback bind the default is a
        fresh random key per pool — read :attr:`authkey` and hand it to
        out-of-band workers (``REPRO_DIST_AUTHKEY=<hex>`` for the CLI).
        A non-loopback bind refuses to start without an explicit key.
        The transport authenticates but does not encrypt; see the trust
        model in :mod:`repro_torch.dist.remote_worker`.
    spawn_local:
        Fork-and-connect ``num_workers`` local workers (default). With
        ``False`` the pool only listens; start workers yourself with
        ``python -m repro_torch.dist.remote_worker --connect host:port``.
    arena_threshold:
        Minimum array size (bytes) to route through the content-hashed
        transfer cache instead of inline pickling
        (``repro_torch.dist.shm_arena.DEFAULT_THRESHOLD`` = 32 KiB).
    heartbeat_s:
        Worker liveness-pulse period (seconds).
    liveness_s:
        Declare a worker dead after this long without any frame
        (default ``max(2.0, 10 * heartbeat_s)``). Must comfortably
        exceed ``heartbeat_s``.
    connect_timeout:
        How long a dispatcher waits for a worker to occupy its slot
        (startup wait with ``spawn_local=True`` uses it too).
    mp_context:
        ``"fork"`` / ``"spawn"`` for locally spawned workers (same
        trade-off as :class:`~repro_torch.dist.ProcessPool`).
    name, observers, deque_cls:
        Forwarded to :class:`~repro_torch.core.ThreadPool`.

    Same pool surface, bodies across a socket::

        >>> from repro_torch.dist import SocketPool
        >>> with SocketPool(2) as pool:
        ...     fut = pool.submit_future(lambda: sum(i * i for i in range(100)))
        ...     fut.result(30)
        328350
    """

    #: bound listening address ``(host, port)`` — hand this to remote
    #: workers (per-instance; the ephemeral default port is resolved at
    #: construction)
    address: tuple = ()

    #: the pool's shared auth secret (bytes) — treat like a password;
    #: remote workers need it (``REPRO_DIST_AUTHKEY=<authkey.hex()>``)
    authkey: bytes = b""

    def __init__(
        self,
        num_workers: Optional[int] = None,
        *,
        workers: Optional[int] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        authkey: Optional[bytes] = None,
        spawn_local: bool = True,
        arena_threshold: int = DEFAULT_THRESHOLD,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        liveness_s: Optional[float] = None,
        connect_timeout: float = 20.0,
        mp_context: Optional[str] = None,
        name: str = "repro-sockpool",
        observers: Sequence[Any] = (),
        **pool_kwargs: Any,
    ) -> None:
        if workers is not None:
            num_workers = workers
        n = num_workers if num_workers is not None else (os.cpu_count() or 1)
        if n < 1:
            raise ValueError("num_workers must be >= 1")
        if heartbeat_s <= 0:
            raise ValueError("heartbeat_s must be > 0")
        self._n_slots = n
        self._threshold = arena_threshold
        self._hb_s = heartbeat_s
        self._liveness_s = (
            liveness_s if liveness_s is not None else max(2.0, 10.0 * heartbeat_s)
        )
        if self._liveness_s <= heartbeat_s:
            raise ValueError("liveness_s must exceed heartbeat_s")
        self._connect_timeout = connect_timeout
        self._spawn_local = spawn_local
        self._mp_context = mp_context
        self._worker_name = name
        if authkey is None:
            if not _is_loopback(host):
                raise ValueError(
                    f"binding {host!r} exposes the pool beyond this machine: "
                    "pass an explicit authkey= (a non-loopback listener "
                    "without one would let any peer on the network attempt "
                    "the handshake; see the trust model in "
                    "repro_torch.dist.remote_worker)"
                )
            authkey = secrets.token_bytes(32)
        elif isinstance(authkey, str):
            authkey = authkey.encode("utf-8")
        if not authkey:
            raise ValueError("authkey must be non-empty")
        self.authkey: bytes = bytes(authkey)

        self._conns: list[Any] = [None] * n  # FramedConn | _PENDING | None
        self._caches: list[Any] = [None] * n  # TransferCache per live conn
        self._procs: list[Any] = [None] * n  # local Process, None for remote
        self._caps: list[Any] = [None] * n  # handshake capability records
        self._io_locks = [threading.Lock() for _ in range(n)]  # one reader per conn
        self._slot_ready = [threading.Event() for _ in range(n)]
        self._last_seen = [0.0] * n
        self._job_seq = [0] * n
        self._remote_jobs = [0] * n
        self._restarts = [0] * n
        self._worker_kills = [0] * n  # §14 hard-timeout kills
        self._hb_lapses = [0] * n  # liveness-window expiries
        self._rejected = 0  # handshakes turned away (post-auth)
        self._auth_failures = 0  # peers dropped before any unpickling
        self._pending_respawns = 0  # spawned workers replaced pre-connect
        self._empty_slot_timeouts = 0  # dispatches that found no worker
        # set when the idle monitor retires a slot's worker: the next job
        # dispatched there fails started=False exactly as ProcessPool's
        # next send into a dead pipe would — keeps the §14 failure
        # schedule deterministic no matter who discovers a death first
        self._transport_fault = [False] * n
        self._current_remote: list[Any] = [None] * n
        self._pending_procs: list[Any] = []  # spawned, not yet slot-bound
        self._proc_lock = threading.Lock()
        self._net_stop = threading.Event()

        # listener first, workers second (fork before any parent thread
        # exists — same fork-safety discipline as ProcessPool), threads last:
        # the TCP backlog parks early connections until the acceptor runs
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(n + 8)
        self._listener = listener
        self.address: tuple = listener.getsockname()[:2]
        if spawn_local:
            self._pending_procs = spawn_workers(
                n, self.address, authkey=self.authkey,
                mp_context=mp_context, name=name,
            )
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{name}-accept", daemon=True
        )
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name=f"{name}-monitor", daemon=True
        )
        self._monitor_thread.start()
        try:
            super().__init__(n, name=name, observers=observers, **pool_kwargs)
        except BaseException:
            self._teardown_net()
            raise
        self._wire_tasks = self._wire_graph
        self._offload = self._offload_body
        if spawn_local:
            # crisp startup failures: every forked worker must arrive
            deadline = time.monotonic() + connect_timeout
            for ev in self._slot_ready:
                if not ev.wait(max(0.0, deadline - time.monotonic())):
                    self.close()
                    raise RuntimeError(
                        f"socket pool startup: {n} local workers did not all "
                        f"connect within {connect_timeout}s"
                    )

    # -- wiring (submit-time): identical placement rule to the §11 backend ------

    _wire_graph = ProcessPool._wire_graph
    _wire_for = staticmethod(ProcessPool._wire_for)

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

    def _endpoint(self, index: int) -> tuple:
        """The slot's live connection + cache, waiting ``connect_timeout``
        for a worker to arrive (remote mode fills slots in join order)."""
        deadline = time.monotonic() + self._connect_timeout
        while True:
            with self._proc_lock:
                conn, cache, proc = (
                    self._conns[index],
                    self._caches[index],
                    self._procs[index],
                )
            if isinstance(conn, FramedConn):
                return conn, cache, proc
            if self._net_stop.is_set():
                raise WorkerDiedError(
                    f"socket pool is closing; slot {index} abandoned its job",
                    started=False,
                )
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                with self._proc_lock:
                    self._empty_slot_timeouts += 1
                raise WorkerDiedError(
                    f"no worker connected to slot {index} within "
                    f"{self._connect_timeout}s",
                    started=False,
                )
            self._slot_ready[index].wait(min(remaining, 0.1))

    def _remote_call(
        self, index: int, fn_wire: tuple, args: tuple, fn: Any, task: Task
    ) -> Any:
        """Ship one job to the worker on slot ``index``, block for its
        verdict, treating heartbeat frames as liveness (not replies)."""
        with self._io_locks[index]:  # sole reader of this connection
            conn, cache, proc = self._endpoint(index)
            with self._proc_lock:
                fault, self._transport_fault[index] = (
                    self._transport_fault[index],
                    False,
                )
            if fault:
                # the idle monitor already retired a dead worker here: the
                # next job still observes the loss (ProcessPool's next
                # send into a dead pipe would), then capacity is restored
                raise WorkerDiedError(
                    f"worker on slot {index} died while idle "
                    "(connection lost between jobs)",
                    started=False,
                )
            if proc is not None and proc.exitcode is not None:
                # local worker died while idle: fail fast *before* the
                # send (TCP buffers would happily swallow it) — the job
                # never left the parent, so started=False and the
                # implicit transport-loss retry resubmits it
                self._respawn(index, conn)
                raise WorkerDiedError(
                    f"worker process on slot {index} died before accepting a job",
                    started=False,
                )
            self._job_seq[index] += 1
            job_id = self._job_seq[index]
            try:
                args_wire = dumps_args(args, cache)
            except Exception as exc:
                # §11 "any" fallback extends to edge values (thread parity);
                # affinity="remote" keeps the clear contract error
                if task.affinity == "remote":
                    raise UnpicklableTaskError(
                        f"task {task.name or fn!r} has affinity='remote' but a "
                        f"dataflow input cannot be shipped to a worker: {exc}"
                    ) from exc
                return fn(*args)
            watched = task.timeout is not None
            if watched:
                task._timed_out = False  # a prior kill may have raced the reply
                self._current_remote[index] = task
                self._timer_get().add(
                    time.monotonic() + task.timeout,
                    lambda a=task._attempt: self._hard_timeout(task, index, a),
                )
            try:
                try:
                    conn.send(("job", job_id, fn_wire, args_wire))
                except OSError:
                    self._respawn(index, conn)
                    raise WorkerDiedError(
                        f"worker on slot {index} died before accepting a job",
                        started=False,
                    ) from None
                while True:
                    try:
                        msg = conn.recv(timeout=self._liveness_s)
                    except TimeoutError:
                        # not even a heartbeat within the window: the peer
                        # is wedged or the link is half-open — declare it
                        self._hb_lapses[index] += 1
                        self._respawn(index, conn)
                        raise WorkerDiedError(
                            f"worker on slot {index} missed the "
                            f"{self._liveness_s}s liveness window while "
                            "executing a task body",
                            started=True,
                        ) from None
                    except (EOFError, OSError):
                        self._respawn(index, conn)
                        if task._timed_out:
                            raise TaskTimeoutError(
                                f"task {task.name!r} exceeded its "
                                f"{task.timeout}s timeout (worker on slot "
                                f"{index} killed)"
                            ) from None
                        raise WorkerDiedError(
                            f"worker on slot {index} died while executing "
                            "a task body",
                            started=True,
                        ) from None
                    if msg and msg[0] == "hb":
                        self._last_seen[index] = time.monotonic()
                        continue
                    break
            finally:
                if watched:
                    with self._proc_lock:  # fences the watchdog's is-check
                        self._current_remote[index] = None
        _kind, jid, ok, payload = msg
        self._last_seen[index] = time.monotonic()
        if jid != job_id:  # can only happen after a half-delivered respawn
            self._respawn(index, conn)
            raise WorkerDiedError(
                f"worker on slot {index} protocol desync (job {jid} != {job_id})"
            )
        self._remote_jobs[index] += 1
        if ok:
            return loads_value(payload, cache)
        raise loads_exception(payload)

    # -- fault tolerance (DESIGN.md §14 across hosts) ---------------------------

    def _retry_policy_for(self, task: Task, exc: BaseException) -> Any:
        """Task policy first (base rule); otherwise the implicit one-shot
        transport-loss retry — the base pool's at-most-once gate still
        blocks ``started=True`` losses for non-idempotent tasks."""
        pol = super()._retry_policy_for(task, exc)
        if pol is None and isinstance(exc, WorkerDiedError):
            return _TRANSPORT_RETRY
        return pol

    def _hard_timeout(self, task: Task, index: int, attempt: int) -> None:
        """Timer-thread callback for ``timeout=`` tasks: SIGKILL a local
        worker, sever a remote one's connection. The (task, attempt) pair
        guards against firing for an execution that no longer exists."""
        with self._proc_lock:
            if self._current_remote[index] is not task or task._attempt != attempt:
                return
            task._timed_out = True
            self._worker_kills[index] += 1
            proc, conn = self._procs[index], self._conns[index]
        if proc is not None:
            proc.kill()  # dispatcher's recv sees EOF -> TaskTimeoutError
        elif isinstance(conn, FramedConn):
            conn.kill()  # remote worker: cut the link instead

    # -- connection lifecycle ---------------------------------------------------

    def _accept_loop(self) -> None:
        """Acceptor thread: authenticate, then handshake, every connecting
        worker and bind it to a free slot (or turn it away)."""
        while not self._net_stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:  # listener closed: pool is shutting down
                return
            conn = FramedConn(sock)
            try:
                # mutual HMAC challenge over raw frames — nothing from
                # this peer is unpickled until it proves it holds the
                # authkey (pickle.loads on attacker bytes is RCE)
                deliver_challenge(conn, self.authkey, timeout=5.0)
                answer_challenge(conn, self.authkey, timeout=5.0)
            except Exception:  # wrong key, garbage, timeout, vanished peer
                self._auth_failures += 1
                conn.close()
                continue
            try:
                hello = conn.recv(timeout=5.0)
            except Exception:  # garbage frame, timeout, or a vanished peer
                conn.close()
                continue
            if not (
                isinstance(hello, dict)
                and hello.get("magic") == MAGIC
                and hello.get("version") == PROTOCOL_VERSION
            ):
                # garbage on the port, or a version-skewed worker: reject
                # before it ever reaches a scheduler slot
                self._rejected += 1
                try:
                    conn.send(
                        {"ok": False, "error": "protocol mismatch",
                         "version": PROTOCOL_VERSION}
                    )
                except OSError:
                    pass
                conn.close()
                continue
            caps = hello.get("caps") or {}
            with self._proc_lock:
                slot = next(
                    (i for i in range(self._n_slots) if self._conns[i] is None), None
                )
                if slot is not None:
                    self._conns[slot] = _PENDING  # reserve until the ack lands
            if slot is None:
                self._rejected += 1
                try:
                    conn.send({"ok": False, "error": "no free worker slot"})
                except OSError:
                    pass
                conn.close()
                continue
            try:
                conn.send(
                    {"ok": True, "version": PROTOCOL_VERSION,
                     "threshold": self._threshold, "heartbeat_s": self._hb_s}
                )
            except OSError:
                with self._proc_lock:
                    self._conns[slot] = None
                conn.close()
                continue
            # ack sent before the slot goes live: the wire order ack-then-job
            # is what the worker's handshake relies on
            with self._proc_lock:
                proc = None
                # bind by the per-spawn nonce, never by pid: pids recycle
                # and collide across hosts, and a mis-bound Process would
                # aim liveness probes and watchdog SIGKILLs at a stranger
                nonce = caps.get("nonce")
                if nonce is not None:
                    for p in self._pending_procs:
                        if getattr(p, "spawn_nonce", None) == nonce:
                            proc = p
                            self._pending_procs.remove(p)
                            break
                self._conns[slot] = conn
                self._caches[slot] = TransferCache(self._threshold)
                self._procs[slot] = proc
                self._caps[slot] = caps
                self._last_seen[slot] = time.monotonic()
            self._slot_ready[slot].set()

    def _monitor_loop(self) -> None:
        """Idle-liveness thread: drain heartbeats from slots whose
        dispatcher is not mid-job, respawn silently-dead workers so a
        loss is usually discovered *before* the next dispatch, and
        replace spawned workers that died before ever connecting."""
        while not self._net_stop.wait(self._hb_s):
            self._refill_pending()
            now = time.monotonic()
            for i in range(self._n_slots):
                io = self._io_locks[i]
                if not io.acquire(blocking=False):
                    continue  # dispatcher owns the socket; it enforces liveness
                try:
                    with self._proc_lock:
                        conn = self._conns[i]
                    if not isinstance(conn, FramedConn):
                        continue
                    try:
                        while conn.poll():
                            # poll() guarantees one readable *byte*, not a
                            # whole frame: allow the full liveness window
                            # for the rest to arrive, or WAN jitter would
                            # read as a death mid-heartbeat
                            conn.recv(timeout=self._liveness_s)
                            self._last_seen[i] = now
                    except (EOFError, OSError, TimeoutError):
                        if self._respawn(i, conn):
                            with self._proc_lock:
                                self._transport_fault[i] = True
                        continue
                    if now - self._last_seen[i] > self._liveness_s:
                        self._hb_lapses[i] += 1
                        if self._respawn(i, conn):
                            with self._proc_lock:
                                self._transport_fault[i] = True
                finally:
                    io.release()

    def _refill_pending(self) -> None:
        """Replace locally spawned workers that exited before occupying a
        slot (an import failure in the child, an OOM kill during startup):
        without this the slot would sit empty for the pool's lifetime,
        burning ``connect_timeout`` on every task routed there."""
        if not self._spawn_local:
            return
        with self._proc_lock:
            dead = [p for p in self._pending_procs if p.exitcode is not None]
            for p in dead:
                self._pending_procs.remove(p)
            empty = sum(1 for c in self._conns if c is None)
            live_pending = len(self._pending_procs)
        for p in dead:
            p.join(timeout=0.1)
            try:
                p.close()
            except Exception:
                pass
        need = min(len(dead), max(0, empty - live_pending))
        if need and not self._net_stop.is_set():
            self._pending_respawns += need
            replacement = spawn_workers(
                need, self.address, authkey=self.authkey,
                mp_context=self._mp_context, name=self._worker_name,
            )
            with self._proc_lock:
                self._pending_procs.extend(replacement)

    def _respawn(self, index: int, dead_conn: Any = None) -> bool:
        """Retire slot ``index``'s connection (and local process, if any)
        and restore capacity: fork a replacement with ``spawn_local``,
        else re-open the slot for the next connecting worker.

        ``dead_conn`` makes the call idempotent under races: the idle
        monitor and a dispatcher can both observe the same death, and
        only the first observer actually respawns (returns True).
        """
        with self._proc_lock:
            if dead_conn is not None and self._conns[index] is not dead_conn:
                return False  # another path already retired this connection
            self._restarts[index] += 1
            self._slot_ready[index].clear()
            conn, self._conns[index] = self._conns[index], None
            cache, self._caches[index] = self._caches[index], None
            proc, self._procs[index] = self._procs[index], None
            self._caps[index] = None
        if isinstance(conn, FramedConn):
            conn.kill()
        if cache is not None:
            cache.close()
        if proc is not None:
            proc.join(timeout=0.1)
            if proc.is_alive():  # link broke but the process wedged
                proc.terminate()
                proc.join(timeout=1.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=1.0)
            try:
                proc.close()  # release FDs now, not at GC (§14 regression)
            except Exception:
                pass
        if self._spawn_local and not self._net_stop.is_set():
            replacement = spawn_workers(
                1, self.address, authkey=self.authkey,
                mp_context=self._mp_context, name=self._worker_name,
            )
            with self._proc_lock:
                self._pending_procs.extend(replacement)
        return True

    # -- lifecycle / stats ------------------------------------------------------

    def stats(self) -> dict[str, int]:
        """Base pool counters plus the transport's: ``remote_jobs``
        (bodies run on workers), ``worker_restarts``, ``worker_kills``
        (§14 watchdog), ``heartbeat_lapses`` (liveness-window expiries),
        ``handshakes_rejected``, ``auth_failures`` (peers dropped before
        any unpickling), ``pending_respawns`` (spawned workers replaced
        before they ever connected), ``empty_slot_timeouts`` (dispatches
        that found no worker within ``connect_timeout``),
        ``workers_connected`` (live slots) and the aggregated
        transfer-cache ``cache_hits`` / ``cache_misses``."""
        out = super().stats()
        out["remote_jobs"] = sum(self._remote_jobs)
        out["worker_restarts"] = sum(self._restarts)
        out["worker_kills"] = sum(self._worker_kills)
        out["heartbeat_lapses"] = sum(self._hb_lapses)
        out["handshakes_rejected"] = self._rejected
        out["auth_failures"] = self._auth_failures
        out["pending_respawns"] = self._pending_respawns
        out["empty_slot_timeouts"] = self._empty_slot_timeouts
        hits = misses = connected = 0
        with self._proc_lock:
            for conn, cache in zip(self._conns, self._caches):
                if isinstance(conn, FramedConn):
                    connected += 1
                if cache is not None:
                    cs = cache.stats()
                    hits += cs["hits"]
                    misses += cs["misses"]
        out["workers_connected"] = connected
        out["cache_hits"] = hits
        out["cache_misses"] = misses
        return out

    def _teardown_net(self) -> None:
        """Stop network threads, close every connection and reap every
        worker process (spawned or pending)."""
        self._net_stop.set()
        try:
            self._listener.close()  # unblocks the acceptor
        except OSError:
            pass
        with self._proc_lock:
            conns = [c for c in self._conns if isinstance(c, FramedConn)]
            caches = [c for c in self._caches if c is not None]
            procs = [p for p in self._procs if p is not None] + self._pending_procs
            self._conns = [None] * self._n_slots
            self._caches = [None] * self._n_slots
            self._procs = [None] * self._n_slots
            self._pending_procs = []
        for conn in conns:
            try:
                conn.send(("bye",))  # orderly shutdown for remote workers
            except OSError:
                pass
        for proc in procs:
            proc.join(timeout=5.0)
            if proc.is_alive():  # pragma: no cover - wedged worker safety net
                proc.terminate()
                proc.join(timeout=1.0)
            try:
                proc.close()
            except Exception:
                pass
        for conn in conns:
            conn.close()
        for cache in caches:
            cache.close()
        for t in (self._accept_thread, self._monitor_thread):
            if t.is_alive():
                t.join(timeout=2.0)

    def close(self) -> None:
        """Stop dispatcher threads, then shut workers down and close every
        connection. In-flight bodies finish (their replies drain first);
        queued-but-unstarted tasks are abandoned, as in the base pool."""
        if self._stop:
            return
        super().close()  # joins dispatcher threads; replies drain first
        self._teardown_net()
