"""§14 fault tolerance: retry/timeout policies, the hung-task watchdog and
the seeded chaos harness, parametrized over every backend (the port's copy
of ``tests/core/test_chaos.py``, against ``repro_torch``; the last tests hold
a seeded ``FaultInjector`` to the same ``schedule()`` in both packages).

The transport-loss case pairs two bodies on a cross-process barrier
(:data:`_PAIR`), so both worker processes take a job, the killed one among
them, whatever the host's load: the reference's copy let a busy host run
every job on the live worker, and then nothing was retried.

Process-safe idioms apply (see tests/core/test_executor.py): bodies whose
*attempt counters* drive the test are pinned ``affinity="local"`` so the
counter lives in the parent on the process backend too; purely-failing or
purely-sleeping bodies are module-level functions so they ship by pickle
reference. Chaos injection happens at the parent-side dispatch seam, so it
is backend-uniform by construction.
"""
import multiprocessing
import os
import threading
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
    checkpoint,
)
from repro_torch.dist.process_pool import WorkerDiedError

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

BACKENDS = ("serial", "thread", "process", "socket")


@pytest.fixture(params=BACKENDS)
def ex(request):
    """One Executor per backend — the whole suite runs on all four."""
    n = 2 if request.param in ("process", "socket") else 4
    with Executor(n, backend=request.param) as e:
        yield e


@pytest.fixture()
def tex():
    """Thread-backend executor for backend-specific tests."""
    with Executor(4, backend="thread") as e:
        yield e


@pytest.fixture()
def pex():
    """Process-backend executor for worker-kill tests."""
    with Executor(2, backend="process") as e:
        yield e


def _always_fail():
    raise ValueError("permanent failure")


def _sleep_long():
    time.sleep(30.0)


def _exit_now():
    os._exit(1)


# two parties: a body that waits here holds its worker until the other
# arrives. Created at import, so every worker process forked later (a
# respawned one too) inherits it; a body reads it as a module global, which
# the wire leaves to the worker's inherited module (a barrier does not pickle)
_PAIR = multiprocessing.get_context("fork").Barrier(2)


def _meet(i):
    _PAIR.wait(60)
    return i


# ---------------------------------------------------------------------------
# RetryPolicy surface
# ---------------------------------------------------------------------------


def test_retry_policy_validation_and_backoff():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=2, backoff=-1.0)
    with pytest.raises(ValueError):
        Task(lambda: None, timeout=0.0)
    pol = RetryPolicy(max_attempts=5, backoff=0.1, factor=2.0, max_backoff=0.3)
    assert [pol.delay(a) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.3, 0.3]
    assert pol.matches(ValueError("x"))
    from repro_torch.core import CancelledError

    assert not pol.matches(CancelledError("never retried"))
    narrow = RetryPolicy(max_attempts=2, retry_on=OSError)
    assert narrow.matches(OSError()) and not narrow.matches(ValueError())


# ---------------------------------------------------------------------------
# retry semantics (all backends)
# ---------------------------------------------------------------------------


def test_retry_to_success(ex):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError(f"boom {len(calls)}")
        return 42

    t = Task(flaky, name="flaky", affinity="local",
             retry=RetryPolicy(max_attempts=5, backoff=0.001))
    t.propagate_errors = False
    assert ex.run(t).result(30) == 42
    assert t.exception is None
    assert ex.stats()["retries"] == 2


def test_exhausted_retries_surface_the_chain(ex):
    t = Task(_always_fail, name="doomed",
             retry=RetryPolicy(max_attempts=3, backoff=0))
    t.propagate_errors = False
    with pytest.raises(ValueError, match="permanent failure"):
        ex.run(t).result(30)
    # the surfaced exception chains every failed attempt (§14)
    depth, exc = 0, t.exception
    while exc is not None:
        depth += 1
        exc = exc.__context__
    assert depth == 3
    assert ex.stats()["retries"] == 2


def test_retry_composes_with_dataflow(ex):
    calls = []

    def flaky_mid(x):
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("transient")
        return x * 10

    g = TaskGraph()
    a = g.add(lambda: 4, name="a")
    b = g.then(a, flaky_mid, name="b")
    b.affinity = "local"
    b.retry_policy = RetryPolicy(max_attempts=3, backoff=0)
    c = g.then(b, lambda v: v + 2, name="c")
    assert ex.run(g).result(30) is None
    assert c.result == 42


def test_deferred_backoff_does_not_block_workers(tex):
    """A backing-off retry must not occupy a worker: other tasks keep
    flowing while the failed task waits out its delay on the pool timer."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ValueError("wait for it")
        return "done"

    t = Task(flaky, name="slow-retry", affinity="local",
             retry=RetryPolicy(max_attempts=3, backoff=0.3))
    t.propagate_errors = False
    fut = tex.run(t)
    t0 = time.monotonic()
    # the pool is fully available during the backoff window
    assert tex.run(lambda: "quick").result(5) == "quick"
    assert time.monotonic() - t0 < 0.25
    assert fut.result(30) == "done"


def test_cancelled_tasks_never_retry(tex):
    from repro_torch.core import CancelledError

    g = TaskGraph()
    bad = g.add(_always_fail, name="bad")
    skipped = g.then(bad, lambda _x: "unreachable", name="skipped")
    skipped.retry_policy = RetryPolicy(max_attempts=5, backoff=0)
    with pytest.raises(ValueError):
        tex.run(g).result(30)
    assert isinstance(skipped.exception, CancelledError)
    assert tex.stats()["retries"] == 0


# ---------------------------------------------------------------------------
# timeouts: cooperative checkpoint + process watchdog
# ---------------------------------------------------------------------------


def test_cooperative_timeout_checkpoint(ex):
    def body():
        for _ in range(200):
            time.sleep(0.005)
            checkpoint()

    t = Task(body, name="deadline", affinity="local", timeout=0.05)
    t.propagate_errors = False
    with pytest.raises(TaskTimeoutError, match="deadline"):
        ex.run(t).result(30)
    assert ex.stats()["timeouts"] == 1


def test_timeout_then_retry_to_success(tex):
    calls = []

    def flaky_slow():
        calls.append(1)
        if len(calls) < 2:
            while True:
                time.sleep(0.005)
                checkpoint()
        return "recovered"

    t = Task(flaky_slow, name="slow-once", affinity="local", timeout=0.05,
             retry=RetryPolicy(max_attempts=2, backoff=0, retry_on=TaskTimeoutError))
    t.propagate_errors = False
    assert tex.run(t).result(30) == "recovered"
    st = tex.stats()
    assert st["timeouts"] == 1 and st["retries"] == 1


def test_checkpoint_is_noop_outside_a_task():
    checkpoint()  # no current task: must not raise


def test_watchdog_kills_stuck_worker(pex):
    """A remote body that never returns is killed at its deadline: the
    task fails with TaskTimeoutError, the pool respawns the worker and
    keeps serving."""
    t = Task(_sleep_long, name="wedge", timeout=0.5, affinity="remote")
    t.propagate_errors = False
    with pytest.raises(TaskTimeoutError, match="wedge"):
        pex.run(t).result(30)
    st = pex.stats()
    assert st["worker_kills"] == 1 and st["timeouts"] == 1
    assert st["worker_restarts"] >= 1
    assert pex.run(lambda: 7).result(30) == 7  # capacity restored


# ---------------------------------------------------------------------------
# §10 contract under a permanently wedged body (regression)
# ---------------------------------------------------------------------------


def test_wedged_body_result_and_wait_idle_timeouts(tex):
    """A stuck task must never hang the contract surface: Future.result
    raises TimeoutError at its deadline and wait_idle reports False."""
    gate = threading.Event()
    fut = tex.submit(gate.wait)
    with pytest.raises(TimeoutError):
        fut.result(0.2)
    assert tex.wait_idle(0.2) is False
    gate.set()
    assert fut.result(30) is True
    assert tex.wait_idle(30) is True


# ---------------------------------------------------------------------------
# ProcessPool fault model: transport loss, at-most-once
# ---------------------------------------------------------------------------


def test_transport_loss_is_retried_implicitly(pex):
    """A worker that died while idle fails the *send*; the implicit
    transport-loss policy resubmits without any per-task RetryPolicy."""
    pool = pex.pool
    pool._procs[0].kill()
    pool._procs[0].join()
    # two bodies that only finish together: both workers take one, so the
    # dead worker's send fails whatever the order the threads wake in
    met = [pex.submit(lambda i=i: _meet(i)) for i in range(2)]
    assert [f.result(90) for f in met] == [0, 1]
    futs = [pex.submit(lambda i=i: i * i) for i in range(8)]
    assert [f.result(30) for f in futs] == [i * i for i in range(8)]
    st = pex.stats()
    assert st["retries"] >= 1 and st["worker_restarts"] >= 1


def test_started_bodies_are_at_most_once_unless_idempotent(pex):
    t = Task(_exit_now, name="suicide", affinity="remote")
    t.propagate_errors = False
    with pytest.raises(WorkerDiedError) as ei:
        pex.run(t).result(30)
    assert ei.value.started is True
    base = pex.stats()["retries"]  # non-idempotent: never retried
    t2 = Task(_exit_now, name="suicide2", affinity="remote", idempotent=True)
    t2.propagate_errors = False
    with pytest.raises(WorkerDiedError):
        pex.run(t2).result(30)
    assert pex.stats()["retries"] == base + 1  # one implicit retry, then surfaced


# ---------------------------------------------------------------------------
# seeded chaos: deterministic schedules, surviving results intact
# ---------------------------------------------------------------------------

_CHAOS = dict(fail_rate=0.25, delay_rate=0.1, kill_rate=0.08, delay_s=0.001)


def _chaos_graph():
    g = TaskGraph("chaos")
    tasks = [
        g.add(
            lambda i=i: i + 1,
            name=f"c:{i}",
            retry=RetryPolicy(
                max_attempts=10, backoff=0, retry_on=(ChaosError, WorkerDiedError)
            ),
        )
        for i in range(30)
    ]
    sink = g.gather(tasks, name="collect")
    return g, sink


def test_chaos_same_seed_same_schedule(ex):
    runs = []
    for _ in range(2):
        inj = FaultInjector(seed=7, match=lambda t: (t.name or "").startswith("c:"),
                            **_CHAOS)
        g, sink = _chaos_graph()
        with inj.on(ex.pool):
            ex.run(g).result(60)
        runs.append((inj.schedule(), list(sink.result)))
    assert runs[0] == runs[1]
    sched, values = runs[0]
    counts = {"fail": 0, "delay": 0, "kill": 0}
    for _name, _occ, kind in sched:
        counts[kind] += 1
    # the floor: >=10% injected body failures, delays, >=2 kills
    assert counts["fail"] >= 3 and counts["delay"] >= 1 and counts["kill"] >= 2
    assert values == [i + 1 for i in range(30)]  # surviving results intact


def test_chaos_schedule_identical_across_backends():
    outcomes = {}
    for backend in BACKENDS:
        n = 2 if backend in ("process", "socket") else 4
        with Executor(n, backend=backend) as e:
            inj = FaultInjector(seed=123, match=lambda t: (t.name or "").startswith("c:"),
                                **_CHAOS)
            g, sink = _chaos_graph()
            with inj.on(e.pool):
                e.run(g).result(60)
            outcomes[backend] = (inj.schedule(), list(sink.result))
    assert len(set(map(repr, outcomes.values()))) == 1, outcomes
    assert outcomes["serial"][1] == [i + 1 for i in range(30)]


def test_chaos_counts_provoked_recoveries(tex):
    inj = FaultInjector(seed=11, fail_rate=0.5)
    tasks = [Task(lambda i=i: i, name=f"f:{i}",
                  retry=RetryPolicy(max_attempts=20, backoff=0, retry_on=ChaosError))
             for i in range(20)]
    for t in tasks:
        t.propagate_errors = False
    with inj.on(tex.pool):
        for t in tasks:
            tex.pool.submit(t)
        tex.wait_idle(60)
    assert inj.counts()["fail"] == len(inj.schedule()) >= 5
    assert inj.retries == len(inj.schedule())  # every injected fail was retried
    assert all(t.result == i for i, t in enumerate(tasks))


def test_chaos_uninstall_restores_the_seam(tex):
    inj = FaultInjector(seed=1, fail_rate=1.0)
    with inj.on(tex.pool):
        assert tex.pool._offload == inj._offload
    assert tex.pool._offload is None
    assert tex.run(lambda: "clean").result(10) == "clean"
    with pytest.raises(RuntimeError):
        inj.install(tex.pool)
        inj.install(tex.pool)  # double-install is an error
    inj.uninstall()


# ---------------------------------------------------------------------------
# §14 x §12: retries inside replayed segments
# ---------------------------------------------------------------------------


def test_retry_inside_replayed_segment_keeps_plan(tex):
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 3:  # fail once, on the replayed (second) pass
            raise RuntimeError("mid-replay hiccup")
        return x + 1

    g = TaskGraph("chain")
    a = g.add(lambda: 0, name="a")
    b = g.then(a, flaky, name="b")
    b.affinity = "local"
    b.retry_policy = RetryPolicy(max_attempts=3, backoff=0)
    c = g.then(b, lambda v: v * 10, name="c")
    tex.run(g).result(30)  # pass 1: live, records the plan
    tex.run(g).result(30)  # pass 2: compiles + replays
    tex.run(g).result(30)  # pass 3: replay with a retried member
    assert c.result == 10
    plan = g.replay_plan
    assert plan is not None and not plan.diverged  # retried-to-success: plan survives
    assert tex.stats()["retries"] == 1


def test_exhausted_retry_in_replay_diverges_then_recovers(tex):
    state = {"fail": False}

    def maybe_fail(x):
        if state["fail"]:
            raise RuntimeError("hard failure")
        return x + 1

    g = TaskGraph("chain2")
    a = g.add(lambda: 1, name="a")
    b = g.then(a, maybe_fail, name="b")
    b.affinity = "local"
    b.retry_policy = RetryPolicy(max_attempts=2, backoff=0)
    tex.run(g).result(30)
    tex.run(g).result(30)
    state["fail"] = True  # replayed pass exhausts retries and fails
    with pytest.raises(RuntimeError, match="hard failure"):
        tex.run(g).result(30)
    assert g.replay_plan.diverged
    state["fail"] = False
    with pytest.raises(RuntimeError, match="hard failure"):
        tex.wait_idle(10)  # collect the poisoned-pool error (§8 contract)
    tex.run(g).result(30)  # falls back live, completes
    assert b.result == 2


# ---------------------------------------------------------------------------
# the port against the reference package: one seed, one fault schedule
# ---------------------------------------------------------------------------


def _package_chaos_run(core, died, backend):
    """The chaos graph through ``core``'s Executor on ``backend`` under a
    seeded injector: (its schedule, the surviving values)."""
    g = core.TaskGraph("chaos")
    tasks = [
        g.add(lambda i=i: i + 1, name=f"c:{i}",
              retry=core.RetryPolicy(max_attempts=10, backoff=0,
                                     retry_on=(core.ChaosError, died)))
        for i in range(30)
    ]
    sink = g.gather(tasks, name="collect")
    n = 2 if backend in ("process", "socket") else 4
    with core.Executor(n, backend=backend) as e:
        inj = core.FaultInjector(seed=123, match=lambda t: (t.name or "").startswith("c:"),
                                 **_CHAOS)
        with inj.on(e.pool):
            e.run(g).result(60)
    return inj.schedule(), list(sink.result)


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeded_schedule_equals_the_reference_package(backend):
    import repro.core as ref_core
    from repro.dist.process_pool import WorkerDiedError as RefWorkerDiedError

    import repro_torch.core as port_core

    ref = _package_chaos_run(ref_core, RefWorkerDiedError, backend)
    port = _package_chaos_run(port_core, WorkerDiedError, backend)
    assert port == ref
    assert port[1] == [i + 1 for i in range(30)]
