"""SocketPool transport behavior (DESIGN.md §16): the framed job protocol,
handshake gating, the worker launcher, per-connection transfer caching and
the consumer surfaces — everything socket-*specific*. The backend-portable
scheduler semantics are certified by ``tests/dist/conformance.py``; the
fault battery (real kills, half-open sockets, heartbeat lapses) lives in
``test_socket_chaos.py``.

The port's copy of ``tests/dist/test_socket_pool.py``, against ``repro_torch``.
"""
import os
import pickle
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import Executor, Task, TaskGraph
from repro_torch.dist import SocketPool, UnpicklableTaskError, WorkerDiedError
from repro_torch.dist.remote_worker import (
    AUTHKEY_ENV,
    MAGIC,
    PROTOCOL_VERSION,
    AuthenticationError,
    FramedConn,
    answer_challenge,
    deliver_challenge,
    run_worker,
    spawn_workers,
    worker_caps,
)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


@pytest.fixture()
def pool():
    with SocketPool(2, name="test-sockpool") as p:
        yield p


# ---------------------------------------------------------------------------
# placement + wiring (socket-specific: the body crosses a TCP frame)
# ---------------------------------------------------------------------------


def test_remote_execution_crosses_the_socket(pool):
    assert pool.submit_future(lambda: os.getpid()).result(20) != os.getpid()
    s = pool.stats()
    assert s["remote_jobs"] >= 1
    assert s["workers_connected"] == 2


def test_affinity_local_pins_to_parent(pool):
    t = Task(lambda: os.getpid(), affinity="local")
    t.propagate_errors = False
    assert Executor(pool=pool).run(t).result(20) == os.getpid()


def test_unpicklable_body_raises_clear_error_at_submit(pool):
    import threading

    lock = threading.Lock()
    t = Task(lambda: lock.acquire(), name="locked", affinity="remote")
    with pytest.raises(UnpicklableTaskError, match="locked"):
        pool.submit(t)
    assert not t.started


def test_remote_exception_type_survives(pool):
    with pytest.raises(ZeroDivisionError):
        pool.submit_future(lambda: 1 // 0).result(20)


def test_workers_alias_and_liveness_validation():
    with SocketPool(workers=1) as p:
        assert p.num_threads == 1
        assert p.submit_future(lambda: "hi").result(20) == "hi"
    with pytest.raises(ValueError, match="liveness"):
        SocketPool(1, heartbeat_s=0.5, liveness_s=0.5)


# ---------------------------------------------------------------------------
# handshake gating
# ---------------------------------------------------------------------------


def _raw_hello(address, hello, *, authkey, timeout=5.0):
    """Authenticate, send ``hello``, return the ack (the attach path a
    well-keyed but possibly version-skewed worker walks)."""
    conn = FramedConn(socket.create_connection(address, timeout=timeout))
    try:
        answer_challenge(conn, authkey, timeout=timeout)
        deliver_challenge(conn, authkey, timeout=timeout)
        conn.send(hello)
        return conn.recv(timeout=timeout)
    finally:
        conn.close()


def test_handshake_rejects_version_mismatch(pool):
    ack = _raw_hello(
        pool.address,
        {"magic": MAGIC, "version": 999, "caps": worker_caps()},
        authkey=pool.authkey,
    )
    assert ack["ok"] is False and "protocol" in ack["error"]
    assert ack["version"] == PROTOCOL_VERSION  # the rejection names ours
    assert pool.stats()["handshakes_rejected"] == 1
    # the pool keeps serving on its existing workers
    assert pool.submit_future(lambda: 21 * 2).result(20) == 42


def test_handshake_rejects_wrong_magic(pool):
    ack = _raw_hello(
        pool.address,
        {"magic": "not-repro", "version": 1, "caps": {}},
        authkey=pool.authkey,
    )
    assert ack["ok"] is False
    assert pool.submit_future(lambda: "fine").result(20) == "fine"


def test_handshake_rejects_when_slots_full(pool):
    """All slots occupied: a well-formed extra worker is turned away."""
    ack = _raw_hello(
        pool.address,
        {"magic": MAGIC, "version": PROTOCOL_VERSION, "caps": worker_caps()},
        authkey=pool.authkey,
    )
    assert ack["ok"] is False and "slot" in ack["error"]
    assert pool.submit_future(lambda: "serving").result(20) == "serving"


# ---------------------------------------------------------------------------
# authentication: nothing from an unauthenticated peer is ever unpickled
# ---------------------------------------------------------------------------

_EVIL_TRIPPED = False


def _trip_evil_flag():
    global _EVIL_TRIPPED
    _EVIL_TRIPPED = True
    return ()


class _EvilPayload:
    """Unpickling this object calls ``_trip_evil_flag`` — the in-process
    stand-in for an RCE gadget on the wire."""

    def __reduce__(self):
        return (_trip_evil_flag, ())


def test_unauthenticated_pickle_is_never_loaded(pool):
    """A peer that skips the challenge and fires a malicious pickle at
    the listener is dropped before any ``pickle.loads`` runs (the accept
    loop and the pool share this process, so the gadget would trip the
    flag right here if it were ever unpickled)."""
    global _EVIL_TRIPPED
    _EVIL_TRIPPED = False
    payload = pickle.dumps(_EvilPayload(), protocol=pickle.HIGHEST_PROTOCOL)
    with socket.create_connection(pool.address, timeout=5.0) as sk:
        sk.sendall(struct.pack("!I", len(payload)) + payload)
        sk.settimeout(5.0)
        # the parent reads our bytes only as a (wrong) HMAC digest and
        # hangs up; drain until EOF to observe the rejection
        while True:
            try:
                if not sk.recv(4096):
                    break
            except OSError:
                break
    deadline = time.monotonic() + 5.0
    while pool.stats()["auth_failures"] < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _EVIL_TRIPPED
    assert pool.stats()["auth_failures"] == 1
    assert pool.stats()["handshakes_rejected"] == 0  # dropped pre-handshake
    assert pool.submit_future(lambda: "still serving").result(20) == "still serving"


def test_wrong_authkey_is_rejected(pool):
    conn = FramedConn(socket.create_connection(pool.address, timeout=5.0))
    try:
        with pytest.raises(AuthenticationError):
            answer_challenge(conn, b"not-the-key", timeout=5.0)
    finally:
        conn.close()
    deadline = time.monotonic() + 5.0
    while pool.stats()["auth_failures"] < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert pool.stats()["auth_failures"] == 1
    assert pool.submit_future(lambda: 2 + 2).result(20) == 4


def test_worker_refuses_unauthenticated_parent():
    """The worker side is symmetric: a rogue listener that feeds
    ``run_worker`` a pickled frame instead of a challenge gets dropped
    (exit code 1) without the payload ever being unpickled."""
    global _EVIL_TRIPPED
    _EVIL_TRIPPED = False
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    host, port = listener.getsockname()[:2]

    def _rogue_parent():
        sk, _ = listener.accept()
        payload = pickle.dumps(_EvilPayload(), protocol=pickle.HIGHEST_PROTOCOL)
        sk.sendall(struct.pack("!I", len(payload)) + payload)
        time.sleep(0.5)
        sk.close()

    import threading

    t = threading.Thread(target=_rogue_parent, daemon=True)
    t.start()
    try:
        code = run_worker(host, port, authkey=b"worker-key", connect_timeout=5.0)
    finally:
        t.join(10)
        listener.close()
    assert code == 1
    assert not _EVIL_TRIPPED


def test_nonloopback_bind_requires_explicit_authkey():
    with pytest.raises(ValueError, match="authkey"):
        SocketPool(1, host="0.0.0.0")
    # an explicit key makes the same bind legal
    with SocketPool(1, host="0.0.0.0", authkey=b"fleet-secret") as p:
        assert p.authkey == b"fleet-secret"
        assert p.submit_future(lambda: "keyed").result(20) == "keyed"


# ---------------------------------------------------------------------------
# remote attach: the launcher CLI and spawn_workers
# ---------------------------------------------------------------------------


def test_cli_worker_attaches_and_serves():
    """``python -m repro_torch.dist.remote_worker --connect host:port`` fills a
    slot: the pool records no local process for it, the handshake carries
    the CLI's pid, and an orderly close sends ``bye`` (worker exits 0)."""
    import repro_torch.dist.remote_worker as rw

    src_dir = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(rw.__file__)))
    )
    env = {**os.environ}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src_dir, env.get("PYTHONPATH")) if p
    )
    with SocketPool(1, spawn_local=False) as pool:
        host, port = pool.address
        env[AUTHKEY_ENV] = pool.authkey.hex()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist.remote_worker",
             "--connect", f"{host}:{port}"],
            env=env,
        )
        try:
            assert pool.submit_future(lambda: os.getpid()).result(30) == proc.pid
            assert pool._procs[0] is None  # remote slot: no local Process
            assert pool._caps[0]["pid"] == proc.pid
        finally:
            pool.close()
            assert proc.wait(10) == 0  # "bye" -> orderly exit
    # close() before the fixture-style exit above; the context exit is a no-op


def test_submit_parks_until_a_worker_attaches():
    """spawn_local=False: jobs wait for capacity, then flow. The §16
    dispatcher blocks on the slot-ready event, not on a dead endpoint."""
    with SocketPool(1, spawn_local=False, connect_timeout=30.0) as pool:
        fut = pool.submit_future(lambda: "late but served")
        time.sleep(0.2)  # genuinely parked: nothing to run it yet
        assert not fut.done()
        procs = spawn_workers(1, pool.address, authkey=pool.authkey)
        try:
            assert fut.result(30) == "late but served"
        finally:
            pool.close()
            for p in procs:
                p.join(10)


def test_spawn_workers_returns_live_processes():
    with SocketPool(2, spawn_local=False) as pool:
        procs = spawn_workers(2, pool.address, authkey=pool.authkey)
        try:
            fut = pool.submit_future(lambda: sum(range(100)))
            assert fut.result(30) == 4950
            # the second worker may still be mid-handshake (mutual auth
            # adds round trips); wait for it rather than racing it
            deadline = time.monotonic() + 20
            while (pool.stats()["workers_connected"] < 2
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert pool.stats()["workers_connected"] == 2
        finally:
            pool.close()
            for p in procs:
                p.join(10)


# ---------------------------------------------------------------------------
# slot binding and pending-worker lifecycle
# ---------------------------------------------------------------------------


def test_spawned_workers_bind_by_nonce(pool):
    """Each locally spawned worker's connection is bound to its Process
    via the per-spawn nonce echoed in the hello caps."""
    for i in range(2):
        assert pool._procs[i] is not None
        assert pool._caps[i]["nonce"] == pool._procs[i].spawn_nonce


def test_slot_binding_ignores_pid_collision():
    """A connecting worker must be bound to a pending local Process only
    via its spawn nonce, never its self-reported pid: a remote worker
    whose pid collides with a pending local worker's must not adopt that
    Process (exitcode probes and watchdog SIGKILLs would target a
    stranger)."""

    class FakePending:
        pid = 987654
        spawn_nonce = "nonce-of-a-real-local-spawn"
        exitcode = None

    fake = FakePending()
    with SocketPool(1, spawn_local=False) as pool:
        with pool._proc_lock:
            pool._pending_procs.append(fake)
        caps = worker_caps()
        caps["pid"] = fake.pid  # the collision
        conn = FramedConn(socket.create_connection(pool.address, timeout=5.0))
        try:
            answer_challenge(conn, pool.authkey, timeout=5.0)
            deliver_challenge(conn, pool.authkey, timeout=5.0)
            conn.send({"magic": MAGIC, "version": PROTOCOL_VERSION, "caps": caps})
            assert conn.recv(timeout=5.0)["ok"] is True
            assert pool._slot_ready[0].wait(5.0)
            assert pool._procs[0] is None  # not mis-bound to the fake
            with pool._proc_lock:
                assert fake in pool._pending_procs  # still awaiting its own
                pool._pending_procs.remove(fake)
        finally:
            conn.close()
            pool.close()


def _exit_immediately():
    return  # a spawned worker that dies before ever connecting


def test_dead_pending_worker_is_replaced(monkeypatch):
    """A respawned local worker that exits before connecting (import
    failure, startup OOM kill) must not strand its slot: the monitor
    detects the exited pending process and forks a replacement, instead
    of capacity being silently lost for the pool's lifetime."""
    import multiprocessing as mp

    import repro_torch.dist.socket_pool as sp

    real_spawn = sp.spawn_workers
    doomed = {"armed": False, "fired": False}

    def flaky_spawn(n, address, **kw):
        if doomed["armed"] and not doomed["fired"]:
            doomed["fired"] = True
            procs = []
            for _ in range(n):
                p = mp.get_context("fork").Process(
                    target=_exit_immediately, daemon=True
                )
                p.spawn_nonce = "doomed-before-connect"
                p.start()
                procs.append(p)
            return procs
        return real_spawn(n, address, **kw)

    monkeypatch.setattr(sp, "spawn_workers", flaky_spawn)
    with SocketPool(1, heartbeat_s=0.05, name="refill-sock") as pool:
        assert pool.submit_future(lambda: 1).result(20) == 1
        doomed["armed"] = True
        pool._procs[0].kill()  # respawn path hands the slot the doomed child
        deadline = time.monotonic() + 30
        while pool.stats()["pending_respawns"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.stats()["pending_respawns"] >= 1
        # the monitor's replacement (a healthy worker) restores capacity
        assert pool.submit_future(lambda: "revived").result(30) == "revived"
        assert pool.stats()["worker_restarts"] >= 1


# ---------------------------------------------------------------------------
# per-connection transfer cache
# ---------------------------------------------------------------------------


def test_transfer_cache_dedups_repeated_arrays(pool):
    """The same large array flowing to several consumers ships once per
    connection; repeats travel digest-only (§16 TransferCache)."""
    g = TaskGraph()
    src = g.add(lambda: np.ones(300_000), name="make", affinity="local")
    sums = [g.then(src, lambda a: float(a.sum()), name=f"s{i}") for i in range(4)]
    Executor(pool=pool).run(g).result(30)
    assert [t.result for t in sums] == [300_000.0] * 4
    s = pool.stats()
    assert s["cache_misses"] >= 1  # first send per connection
    assert s["cache_hits"] >= 1  # at least one repeat went digest-only


def test_transfer_cache_resets_after_respawn(pool):
    """A replacement worker holds no cached state: the same array misses
    again on the fresh connection instead of dangling a stale digest."""
    g = TaskGraph()
    src = g.add(lambda: np.full(200_000, 7.0), name="make", affinity="local")
    sums = [g.then(src, lambda a: float(a.sum())) for _ in range(4)]
    Executor(pool=pool).run(g).result(30)
    assert pool.stats()["cache_misses"] >= 1
    # kill both workers: every connection (and its cache) is replaced
    for p in list(pool._procs):
        if p is not None:
            p.kill()
    deadline = time.monotonic() + 20
    while pool.stats()["worker_restarts"] < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    # the replacement connections carry *fresh* caches: counters are zero
    s = pool.stats()
    assert s["cache_misses"] == 0 and s["cache_hits"] == 0
    g2 = TaskGraph()
    src2 = g2.add(lambda: np.full(200_000, 7.0), name="make2", affinity="local")
    sums2 = [g2.then(src2, lambda a: float(a.sum())) for _ in range(4)]
    Executor(pool=pool).run(g2).result(30)
    assert [t.result for t in sums2] == [1_400_000.0] * 4
    # the same array *missed* again — sent inline on the new connection,
    # not resolved against a digest the dead worker took with it
    assert pool.stats()["cache_misses"] >= 1


def test_large_array_result_returns_intact(pool):
    arr = pool.submit_future(lambda: np.arange(100_000, dtype=np.int64)).result(30)
    assert isinstance(arr, np.ndarray)
    assert arr.shape == (100_000,) and arr[-1] == 99_999


# ---------------------------------------------------------------------------
# consumer surfaces on the socket backend
# ---------------------------------------------------------------------------


def test_checkpoint_manager_on_socket_backend(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    tree = {"w": np.arange(12.0).reshape(3, 4), "step": np.array(3)}
    with CheckpointManager(tmp_path, backend="socket") as mgr:
        mgr.save_async(3, tree)
        mgr.wait()
        restored, meta = mgr.restore(tree, device="cpu")
    assert meta["step"] == 3
    np.testing.assert_array_equal(restored["w"], tree["w"])


def test_prefetcher_on_socket_backend():
    from repro_torch.data import Prefetcher

    class Source:
        def batch(self, step):
            return {"x": np.full(4, float(step))}

    pf = Prefetcher(Source(), backend="socket", depth=2,
                    put_fn=lambda b: float(b["x"].sum()))
    try:
        assert [pf.get(30) for _ in range(5)] == [0.0, 4.0, 8.0, 12.0, 16.0]
    finally:
        pf.close()


def test_prefetcher_socket_requires_put_fn():
    from repro_torch.data import Prefetcher

    class Source:
        def batch(self, step):  # pragma: no cover - never reached
            return {}

    with pytest.raises(ValueError, match="put_fn"):
        Prefetcher(Source(), backend="socket")


# ---------------------------------------------------------------------------
# framing primitives
# ---------------------------------------------------------------------------


def test_framed_conn_roundtrip_and_eof():
    a, b = socket.socketpair()
    ca, cb = FramedConn(a), FramedConn(b)
    try:
        ca.send(("job", 1, b"x" * 70_000, None))  # bigger than one segment
        kind, jid, blob, rest = cb.recv(timeout=5.0)
        assert (kind, jid, rest) == ("job", 1, None) and len(blob) == 70_000
        cb.send(("res", 1, True, "ok"))
        assert ca.recv(timeout=5.0) == ("res", 1, True, "ok")
        cb.close()
        with pytest.raises((EOFError, OSError)):
            ca.recv(timeout=5.0)
    finally:
        ca.close()
        cb.close()


def test_recv_restores_blocking_socket():
    """A timed recv must not leave its timeout armed on the socket: the
    next large ``send`` would otherwise run ``sendall`` under the stale
    liveness window, so big frames over slow links could never succeed
    (the transport retry would deterministically fail the same way)."""
    a, b = socket.socketpair()
    ca, cb = FramedConn(a), FramedConn(b)
    try:
        cb.send(("hb",))
        assert ca.recv(timeout=2.5) == ("hb",)
        assert a.gettimeout() is None  # restored: sends are unbounded
        with pytest.raises(TimeoutError):
            ca.recv(timeout=0.05)
        assert a.gettimeout() is None  # restored on the timeout path too
    finally:
        ca.close()
        cb.close()


def test_framed_conn_recv_timeout():
    a, b = socket.socketpair()
    ca, cb = FramedConn(a), FramedConn(b)
    try:
        with pytest.raises(TimeoutError):
            ca.recv(timeout=0.1)
    finally:
        ca.close()
        cb.close()


def test_stats_surface_has_transport_counters(pool):
    pool.submit_future(lambda: None).result(20)
    s = pool.stats()
    for key in (
        "remote_jobs",
        "worker_restarts",
        "worker_kills",
        "heartbeat_lapses",
        "handshakes_rejected",
        "auth_failures",
        "pending_respawns",
        "empty_slot_timeouts",
        "workers_connected",
        "cache_hits",
        "cache_misses",
    ):
        assert key in s, key
