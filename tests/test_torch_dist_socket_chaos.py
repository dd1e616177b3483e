"""Socket chaos battery (DESIGN.md §16 acceptance): real connection
kills, half-open sockets, heartbeat lapses and hard-timeout worker kills
against a live :class:`SocketPool` — plus the seeded-determinism gate: the
same chaos seed yields a **byte-identical** injected schedule across two
consecutive runs on fresh pools.

Determinism here is load-bearing, not cosmetic. The injector's decisions
are keyed hashes of ``(seed, task, occurrence)``, so the schedule can only
diverge if the *pool* makes occurrence counts interleaving-dependent —
e.g. a kill silently swallowed because the idle monitor respawned the
worker before the dispatcher noticed (exactly the race the
``_transport_fault`` handoff closes). These tests are the canary for that
class of bug.

Process-safe idioms as everywhere: module-level bodies for anything that
must ship by pickle reference, ``idempotent=True`` on bodies a chaos kill
may interrupt mid-flight (§14 at-most-once), assertions on parent-side
task state.

The port's copy of ``tests/dist/test_socket_chaos.py``, against ``repro_torch``.
"""
import hashlib
import json
import os
import signal
import time

import pytest
import torch

from repro_torch.core import (
    ChaosError,
    Executor,
    FaultInjector,
    RetryPolicy,
    Task,
    TaskGraph,
    TaskTimeoutError,
)
from repro_torch.dist import SocketPool, WorkerDiedError

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

_POLICY = RetryPolicy(
    max_attempts=10, backoff=0.0, retry_on=(ChaosError, WorkerDiedError)
)
_CHAOS = dict(fail_rate=0.2, delay_rate=0.08, kill_rate=0.1, delay_s=0.001)


def _battery_graph(n=24):
    g = TaskGraph("sock-chaos")
    tasks = [
        g.add(lambda i=i: i * i, name=f"k:{i}", retry=_POLICY, idempotent=True)
        for i in range(n)
    ]
    sink = g.gather(tasks, name="collect")
    return g, sink


def _run_battery(seed):
    """One full battery run on a fresh pool; returns (schedule, values,
    stats) — everything the determinism gate compares or bounds."""
    with SocketPool(2, name="chaos-sock") as pool:
        inj = FaultInjector(
            seed=seed, match=lambda t: (t.name or "").startswith("k:"), **_CHAOS
        )
        g, sink = _battery_graph()
        with inj.on(pool):
            Executor(pool=pool).run(g).result(120)
        return inj.schedule(), list(sink.result), pool.stats()


def fingerprint(schedule):
    """Canonical digest of an injected-fault schedule (the CI artifact)."""
    blob = json.dumps(schedule, separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _sleepy(i):
    time.sleep(0.02)
    return i * 3


def _wedge():
    time.sleep(30.0)


def _exit_now():
    os._exit(1)


# ---------------------------------------------------------------------------
# the seeded battery: byte-identical schedules across consecutive runs
# ---------------------------------------------------------------------------


def test_seeded_battery_byte_identical_across_two_runs():
    runs = [_run_battery(seed=2026) for _ in range(2)]
    (sched_a, vals_a, stats_a), (sched_b, vals_b, _) = runs
    # byte-identical: compare the serialized schedules, not just equality
    blob_a = json.dumps(sched_a, separators=(",", ":")).encode()
    blob_b = json.dumps(sched_b, separators=(",", ":")).encode()
    assert blob_a == blob_b
    assert fingerprint(sched_a) == fingerprint(sched_b)
    # the battery actually exercised every fault kind, incl. real kills
    counts = {"fail": 0, "delay": 0, "kill": 0}
    for _name, _occ, kind in sched_a:
        counts[kind] += 1
    assert counts["fail"] >= 2 and counts["kill"] >= 1
    # chaos changes the schedule, never the answer
    assert vals_a == vals_b == [i * i for i in range(24)]
    assert stats_a["worker_restarts"] >= 1  # the kills were real


def test_different_seeds_differ():
    """Sanity for the gate above: the fingerprint is sensitive — two seeds
    with these rates virtually never produce the same schedule."""
    sched_a, _va, _sa = _run_battery(seed=11)
    sched_b, _vb, _sb = _run_battery(seed=12)
    assert fingerprint(sched_a) != fingerprint(sched_b)


# ---------------------------------------------------------------------------
# real transport faults, one at a time
# ---------------------------------------------------------------------------


def test_half_open_connection_recovers():
    """Shutting down a live connection under traffic (the half-open case:
    the parent's endpoint dies, the worker process is still running) fails
    in-flight bodies with ``WorkerDiedError``; retries land on replacement
    capacity and the graph completes intact."""
    with SocketPool(2, name="halfopen-sock") as pool:
        g = TaskGraph()
        tasks = [
            g.add(lambda i=i: _sleepy(i), name=f"s:{i}", retry=_POLICY,
                  idempotent=True)
            for i in range(16)
        ]
        sink = g.gather(tasks, name="collect")
        fut = Executor(pool=pool).run(g)
        time.sleep(0.05)  # let jobs reach the wire
        conn = pool._conns[0]
        if hasattr(conn, "kill"):
            conn.kill()  # RDWR shutdown: both directions die mid-stream
        assert fut.result(60) is None
        assert list(sink.result) == [i * 3 for i in range(16)]
        assert pool.stats()["worker_restarts"] >= 1


def test_heartbeat_lapse_detected_and_recovered():
    """A SIGSTOPped worker stops pulsing; the liveness window declares it
    dead (heartbeat_lapses counter), the slot respawns, and idempotent
    bodies retry to completion."""
    with SocketPool(2, heartbeat_s=0.05, liveness_s=0.4,
                    name="lapse-sock") as pool:
        g = TaskGraph()
        tasks = [
            g.add(lambda i=i: _sleepy(i), name=f"h:{i}", retry=_POLICY,
                  idempotent=True)
            for i in range(8)
        ]
        sink = g.gather(tasks, name="collect")
        fut = Executor(pool=pool).run(g)
        time.sleep(0.06)  # a body is in flight on some worker
        victim = next(p for p in pool._procs if p is not None)
        os.kill(victim.pid, signal.SIGSTOP)  # silent, not dead: no EOF
        assert fut.result(60) is None
        assert list(sink.result) == [i * 3 for i in range(8)]
        s = pool.stats()
        assert s["heartbeat_lapses"] >= 1
        assert s["worker_restarts"] >= 1


def test_hard_timeout_kills_remote_worker_and_restores_capacity():
    with SocketPool(2, name="watchdog-sock") as pool:
        t = Task(_wedge, name="wedged", affinity="remote", timeout=0.2)
        t.propagate_errors = False
        with pytest.raises(TaskTimeoutError, match="wedged"):
            Executor(pool=pool).run(t).result(30)
        s = pool.stats()
        assert s["worker_kills"] >= 1 and s["timeouts"] >= 1
        # the replacement worker serves the next job
        assert pool.submit_future(lambda: "alive").result(20) == "alive"


def test_started_loss_is_at_most_once_without_idempotent():
    """A body that genuinely dies mid-execution (os._exit) surfaces as
    ``WorkerDiedError(started=True)`` and is NOT retried without
    ``idempotent=True`` — even under a matching policy (§14)."""
    with SocketPool(2, name="amo-sock") as pool:
        t = Task(
            _exit_now, name="amo", affinity="remote",
            retry=RetryPolicy(max_attempts=5, backoff=0.0,
                              retry_on=WorkerDiedError),
        )
        t.propagate_errors = False
        with pytest.raises(WorkerDiedError) as ei:
            Executor(pool=pool).run(t).result(30)
        assert ei.value.started is True
        assert pool.stats()["worker_restarts"] >= 1
        assert pool.wait_idle(20) is True  # not poisoned
