"""ProcessPool behavior: placement, fault handling, arena edges, and the
backend edge cases the §11 satellite calls out — unpicklable bodies fail
at submit, worker death fails the task (and releases ``wait_idle``), and
the scheduler's §10 semantics survive the address-space boundary.

The port's copy of ``tests/dist/test_process_pool.py``, against ``repro_torch``.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import Executor, Task, TaskGraph
from repro_torch.dist import ProcessPool, UnpicklableTaskError, WorkerDiedError

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


@pytest.fixture()
def pool():
    with ProcessPool(2, name="test-procpool") as p:
        yield p


def _locked_body():
    lock = threading.Lock()
    return lambda: lock.acquire()


# ---------------------------------------------------------------------------
# placement + wiring
# ---------------------------------------------------------------------------


def test_remote_execution_actually_happens(pool):
    """The body observes a different pid — proof it escaped the parent."""
    assert pool.submit_future(lambda: os.getpid()).result(10) != os.getpid()
    assert pool.stats()["remote_jobs"] >= 1


def test_affinity_local_pins_to_parent(pool):
    t = Task(lambda: os.getpid(), affinity="local")
    t.propagate_errors = False
    fut = Executor(pool=pool).run(t)
    assert fut.result(10) == os.getpid()


def test_condition_and_spawner_bodies_always_run_in_parent(pool):
    pids = {}
    g = TaskGraph()
    entry = g.add(lambda: None)
    cond = g.add(lambda: pids.setdefault("cond", os.getpid()) and 99, kind="condition")
    cond.after(entry)

    def spawn(rt):
        pids["spawn"] = os.getpid()
        return rt.add(lambda: os.getpid())

    sp = g.add(spawn, takes_runtime=True)
    sp.after(entry)
    worker_pid = g.then(sp, lambda p: p)
    Executor(pool=pool).run(g).result(10)
    assert pids["cond"] == os.getpid()  # control flow is scheduler-side
    assert pids["spawn"] == os.getpid()
    assert worker_pid.result != os.getpid()  # spawned body went remote


def test_unpicklable_body_raises_clear_error_at_submit(pool):
    t = Task(_locked_body(), name="locked", affinity="remote")
    with pytest.raises(UnpicklableTaskError, match="locked"):
        pool.submit(t)
    assert not t.started  # nothing was scheduled


def test_unpicklable_body_with_any_affinity_runs_locally(pool):
    t = Task(_locked_body(), affinity="any")
    t.propagate_errors = False
    assert Executor(pool=pool).run(t).result(10) is True  # acquired in-parent
    assert t.done


def test_unpicklable_spawned_remote_task_fails_its_task(pool):
    """A runtime-spawned affinity='remote' body that cannot ship fails
    when it runs (wiring happens inside the scheduler loop — deferred),
    and the failure adopts through the join like any subflow error."""
    g = TaskGraph()

    def spawn(rt):
        rt.add(_locked_body(), affinity="remote", name="bad-spawn")

    g.add(spawn, takes_runtime=True)
    for t in g.tasks:
        t.propagate_errors = False
    with pytest.raises(UnpicklableTaskError, match="bad-spawn"):
        Executor(pool=pool).run(g).result(10)


# ---------------------------------------------------------------------------
# fault handling
# ---------------------------------------------------------------------------


def test_worker_death_fails_task_and_releases_wait_idle(pool):
    fut = pool.submit_future(lambda: os._exit(7))
    with pytest.raises(WorkerDiedError):
        fut.result(10)
    assert pool.wait_idle(10) is True  # no hang, no poisoned pool
    # capacity restored: the respawned worker serves the next job
    assert pool.submit_future(lambda: "alive").result(10) == "alive"
    assert pool.stats()["worker_restarts"] >= 1


def test_worker_death_poisons_propagating_graph(pool):
    g = TaskGraph()
    dead = g.add(lambda: os._exit(3), name="dies")
    g.then(dead, lambda _x: "unreachable")
    with pytest.raises(WorkerDiedError):
        Executor(pool=pool).run(g).result(10)


def test_remote_exception_type_survives(pool):
    with pytest.raises(ZeroDivisionError):
        pool.submit_future(lambda: 1 // 0).result(10)


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"), reason="needs procfs")
def test_respawn_cycles_do_not_leak_fds():
    """Regression (§14 satellite): every kill/respawn cycle must close the
    dead worker's pipe ends AND its Process object's sentinel/fifo
    descriptors — 20 cycles through one slot may not grow this process's
    open-FD count."""
    with ProcessPool(1, name="fd-pool") as pool:
        with pytest.raises(WorkerDiedError):
            pool.submit_future(lambda: os._exit(9)).result(20)  # warm the path
        pool.submit_future(lambda: None).result(20)  # slot respawned + live
        baseline = len(os.listdir("/proc/self/fd"))
        for _ in range(20):
            with pytest.raises(WorkerDiedError):
                pool.submit_future(lambda: os._exit(9)).result(20)
        pool.submit_future(lambda: None).result(20)  # steady state again
        after = len(os.listdir("/proc/self/fd"))
        # identical modulo transient slack (a respawn mid-count holds a
        # few descriptors for one cycle); 20 leaked cycles would show as
        # +40 or more (two pipe ends each)
        assert after - baseline <= 4, f"fd leak: {baseline} -> {after}"
        assert pool.stats()["worker_restarts"] >= 21


# ---------------------------------------------------------------------------
# shared-memory data plane
# ---------------------------------------------------------------------------


def test_large_array_edges_cross_the_arena(pool):
    n = 512  # 2 MB float64 — far above the arena threshold
    g = TaskGraph()
    src = g.add(lambda: np.ones((n, n)), name="make")
    total = g.then(src, lambda a: float(a.sum()), name="sum")
    Executor(pool=pool).run(g).result(30)
    assert total.result == float(n * n)


def test_large_array_result_returns_intact(pool):
    arr = pool.submit_future(lambda: np.arange(100_000, dtype=np.int64)).result(30)
    assert isinstance(arr, np.ndarray)
    assert arr.shape == (100_000,) and arr[-1] == 99_999


def test_arena_segments_recycle_across_jobs(pool):
    g = TaskGraph()
    heads = [g.add(lambda i=i: np.full(50_000, i, np.float64), name=f"h{i}") for i in range(4)]
    sums = [g.then(h, lambda a: float(a.sum())) for h in heads]
    Executor(pool=pool).run(g).result(30)
    assert [s.result for s in sums] == [0.0, 50_000.0, 100_000.0, 150_000.0]
    # pooled segments are bounded by concurrency, not by job count
    assert len(pool._arena._owned) <= 2 * pool.num_threads


def test_fanout_parallel_remote_bodies(pool):
    g = TaskGraph()
    root = g.add(lambda: None)
    layer = [g.add(lambda i=i: os.getpid() * 0 + i).after(root) for i in range(8)]
    tot = g.gather(layer, fn=lambda *vs: sum(vs))
    Executor(pool=pool).run(g).result(30)
    assert tot.result == sum(range(8))
    assert pool.stats()["remote_jobs"] >= 8


# ---------------------------------------------------------------------------
# snapshot semantics (the documented sharp edge)
# ---------------------------------------------------------------------------


def test_remote_closure_mutation_does_not_travel_back(pool):
    """Remote bodies see closure snapshots; the parent's cell is untouched.
    This is the documented §11 contract, pinned here so it fails loudly if
    the semantics ever drift."""
    hits = []
    t = Task(lambda: hits.append(1) or len(hits))
    t.propagate_errors = False
    assert Executor(pool=pool).run(t).result(10) == 1  # worker-side append
    assert hits == []  # parent cell untouched


def test_unpicklable_edge_value_falls_back_in_parent(pool):
    """An 'any' task whose dataflow input does not pickle runs in-parent
    (thread/serial parity) instead of failing with a raw pickle error;
    affinity='remote' keeps the clear contract error (review fix)."""
    g = TaskGraph()
    src = g.add(lambda: threading.Lock(), affinity="local", name="lockmaker")
    took = g.then(src, lambda lk: lk.acquire(), name="taker")
    Executor(pool=pool).run(g).result(10)
    assert took.result is True  # body ran in-parent on the real lock

    g2 = TaskGraph()
    src2 = g2.add(lambda: threading.Lock(), affinity="local")
    bad = g2.then(src2, lambda lk: lk, name="must-remote")
    bad.affinity = "remote"
    for t in g2.tasks:
        t.propagate_errors = False
    with pytest.raises(UnpicklableTaskError, match="dataflow input"):
        Executor(pool=pool).run(g2).result(10)


# ---------------------------------------------------------------------------
# the port's prefetcher on the process backend (the reference's cases in
# tests/data/test_pipeline.py, against repro_torch.data)
# ---------------------------------------------------------------------------


def _pid_stamp(batch):
    """Module-level transform so the process backend can ship it."""
    return {**batch, "transform_pid": np.asarray(os.getpid())}


def test_prefetcher_process_backend_transforms_cross_processes():
    """backend="process": the lane graphs run their transform bodies in
    worker processes; batches arrive in order and the transform ran in
    another pid."""
    from repro_torch.data import Prefetcher, SyntheticTokens

    src = SyntheticTokens(101, 8, 4, seed=4)
    with Prefetcher(src, depth=2, backend="process", put_fn=_pid_stamp) as pf:
        batches = [pf.get(60) for _ in range(3)]
    for step, b in enumerate(batches):
        np.testing.assert_array_equal(np.asarray(b["tokens"]), src.batch(step)["tokens"])
        assert int(b["transform_pid"]) != os.getpid()


def test_prefetcher_process_backend_requires_explicit_put_fn():
    """The default transform puts each batch on a torch device: in a
    forked worker that is the wrong process, so it fails loudly."""
    from repro_torch.data import Prefetcher, SyntheticTokens

    with pytest.raises(ValueError, match="put_fn"):
        Prefetcher(SyntheticTokens(101, 8, 4, seed=6), backend="process")


def test_prefetcher_guard_applies_to_adopted_process_pool():
    """The put_fn guard checks the resolved backend: a ProcessPool handed
    in through pool= does not bypass it."""
    from repro_torch.data import Prefetcher, SyntheticTokens

    with ProcessPool(1) as pp:
        with pytest.raises(ValueError, match="put_fn"):
            Prefetcher(SyntheticTokens(101, 8, 4, seed=7), pool=pp)


def test_produce_pinned_local_by_contract():
    """produce and deliver stay in-parent by their affinity."""
    from repro_torch.data import Prefetcher, SyntheticTokens

    src = SyntheticTokens(101, 8, 4, seed=8)
    with Prefetcher(src, depth=1, backend="process", put_fn=lambda b: b) as pf:
        lane = pf._lanes[0]
        assert lane.produce.affinity == "local"
        assert lane.deliver.affinity == "local"
        pf.get(60)
