"""Cross-backend conformance suite: one matrix, four executors.

Every test here runs — with the *same* parametrized assertions, no
backend-specific skips — on all four execution backends (DESIGN.md §11,
§16): **serial**, **thread**, **process** and **socket**. This is the
certification surface for any new transport: a pool that passes this
file provides the §9/§10 scheduler contract (lifecycle, priorities,
conditions and weak cycles, subflows, counted completion), §12 replay
parity, the §14 fault model (retry, cooperative timeout, the
at-most-once gate for started transport losses) and §8 observer
accounting, indistinguishably from the paper's thread pool.

Process-safe idioms apply throughout (they are what make one suite
possible): loop/convergence state lives in condition bodies (which
always run scheduler-side) or flows along dataflow edges; attempt
counters are pinned ``affinity="local"``; assertions read parent-side
task state (``result`` / ``done`` / ``exception``), never closure cells
a remote body would have mutated in its own address space.

Backend-*specific* behavior lives elsewhere: thread-only timing tests in
``tests/core/test_executor.py``, pipe-transport faults in
``tests/dist/test_process_pool.py``, socket-transport faults and the
chaos battery in ``tests/dist/test_socket_pool.py`` /
``test_socket_chaos.py``.

The port's copy of ``tests/dist/conformance.py``, against ``repro_torch``.
"""
import asyncio
import threading
import time

import pytest
import torch

from repro_torch.core import (
    Executor,
    RetryPolicy,
    Task,
    TaskGraph,
    TaskTimeoutError,
    checkpoint,
)
from repro_torch.dist import WorkerDiedError

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


def _build_loop(iters):
    """entry -> body -> more? with a weak back-edge to body.

    Loop state lives in the *condition* body — conditions always execute
    scheduler-side, so the counter is authoritative on every backend.
    """
    g = TaskGraph("loop")
    state = {"i": 0, "runs": 0}
    entry = g.add(lambda: state.update(i=0), name="entry", affinity="local")
    body = g.add(lambda: None, name="body")  # remote-eligible each pass
    body.after(entry)

    def more():
        state["i"] += 1
        state["runs"] += 1
        return 0 if state["i"] < iters else 1

    cond = g.add(more, kind="condition", name="more")
    cond.after(body)
    cond.precede(body)
    return g, state


# ---------------------------------------------------------------------------
# lifecycle + facade basics
# ---------------------------------------------------------------------------


def test_run_callable_returns_future(ex):
    assert ex.run(lambda: 6 * 7).result(30) == 42


def test_run_single_task_resolves_to_result(ex):
    t = Task(lambda: "payload")
    t.propagate_errors = False
    assert ex.run(t).result(30) == "payload"


def test_run_graph_and_iterable(ex):
    g = TaskGraph()
    a = g.add(lambda: 3)
    b = g.then(a, lambda x: x * x)
    assert ex.run(g).result(30) is None
    assert b.result == 9
    # an anonymous iterable of tasks is wrapped in a graph; the dataflow
    # edge proves t2 ran after t1 on any backend
    t1 = Task(lambda: 20)
    t2 = Task(lambda x: x + 1, takes_inputs=True)
    t2.succeed(t1)
    assert ex.run([t1, t2]).result(30) is None
    assert t2.result == 21


def test_submit_alias(ex):
    assert ex.submit(lambda: "ok").result(30) == "ok"


def test_run_failure_delivered_through_future(ex):
    with pytest.raises(ValueError, match="boom"):
        ex.run(lambda: (_ for _ in ()).throw(ValueError("boom"))).result(30)
    # the backend stays healthy afterwards
    assert ex.run(lambda: "still alive").result(30) == "still alive"


def test_failure_propagates_along_dataflow_edges(ex):
    g = TaskGraph()
    bad = g.add(lambda: (_ for _ in ()).throw(RuntimeError("upstream died")))
    down = g.then(bad, lambda x: x)
    for t in g.tasks:
        t.propagate_errors = False
    with pytest.raises(RuntimeError, match="upstream died"):
        ex.run(g).result(30)
    assert isinstance(down.exception, RuntimeError)  # adopted, body skipped


def test_wait_idle_after_work(ex):
    ex.run(lambda: 1).result(30)
    assert ex.wait_idle(30) is True


def test_lifecycle_close_is_idempotent_and_final():
    """Every backend constructs, serves, closes — and a second close is a
    no-op. (The one test here that owns its executors: lifecycle IS the
    thing under test, so the fixture cannot provide it.)"""
    for backend in BACKENDS:
        e = Executor(2, backend=backend)
        try:
            assert e.run(lambda: backend).result(30) == backend
        finally:
            e.close()
        e.close()  # idempotent
        assert e.pool._stop


def test_prewired_single_task_runs(ex):
    """Submitting one pre-wired (non-source) Task runs exactly that task,
    as ThreadPool._schedule does — no backend may reject it as a
    sourceless graph."""
    t1 = Task(lambda: "unrun")
    t2 = Task(lambda x: (x, "ran"), takes_inputs=True)
    t2.succeed(t1)
    t2.propagate_errors = False
    assert ex.run(t2).result(30) == (None, "ran")  # t1 never ran: slot is None


# ---------------------------------------------------------------------------
# priorities
# ---------------------------------------------------------------------------


def test_run_graph_priority_overrides_non_explicit_bands(ex):
    """run(graph, priority=) follows the ThreadPool.submit contract: every
    task without an explicit band is promoted, explicit bands win.
    (Serial ignores bands at runtime but records them identically.)"""
    g = TaskGraph()
    a = g.add(lambda: None)
    b = a.then(lambda _x: None)
    c = g.add(lambda: None, priority=-2.0)
    ex.run(g, priority=3.0).result(30)
    assert a.priority == b.priority == 3.0
    assert c.priority == -2.0


def test_subflow_priority_inherited_from_spawner(ex):
    g = TaskGraph()
    captured = []

    def spawn(rt):  # spawner bodies always run scheduler-side
        captured.append(rt.add(lambda: None).priority)
        captured.append(rt.add(lambda: None, priority=-1.0).priority)

    g.add(spawn, takes_runtime=True, priority=2.5)
    ex.run(g).result(30)
    assert captured == [2.5, -1.0]


# ---------------------------------------------------------------------------
# condition tasks: branching + weak cycles
# ---------------------------------------------------------------------------


def test_condition_selects_single_branch(ex):
    g = TaskGraph("branch")
    src = g.add(lambda: None, name="src")
    pick = g.add(lambda: 1, kind="condition", name="pick")
    pick.after(src)
    left = g.add(lambda: "L", name="left")
    right = g.add(lambda: "R", name="right")
    pick.precede(left, right)  # branch order = wiring order
    assert ex.run(g).result(30) is None
    # every member of a condition graph re-arms after running (clearing
    # `started` for the next pass), so assert on results — rearm keeps them
    assert right.result == "R"
    assert left.result is None  # branch not taken


def test_branch_not_taken_resets_cleanly_across_runs(ex):
    """Un-run branches leave no residue: across run_count > 1 each run
    releases exactly the branch its condition names."""
    sel = {"v": 0}
    g = TaskGraph()
    pick = g.add(lambda: sel["v"], kind="condition")  # conditions run in-parent
    a = g.add(lambda: "a")
    b = g.add(lambda: "b")
    pick.precede(a, b)
    taken = []
    for v in (0, 1, 0):
        sel["v"] = v
        if taken:
            g.reset()
        assert ex.run(g).result(30) is None
        assert (a.result is None) != (b.result is None)  # exactly one branch ran
        taken.append(a.result or b.result)
    assert taken == ["a", "b", "a"]
    assert g.run_count == 3


def test_condition_out_of_range_ends_run(ex):
    """A non-int / out-of-range return selects nothing — the loop's exit."""
    g = TaskGraph()
    c = g.add(lambda: 99, kind="condition")
    dead = g.add(lambda: "never")
    c.precede(dead)
    assert ex.run(g).result(30) is None
    assert dead.result is None  # branch never released


def test_condition_loop_bounded_iteration(ex):
    g, state = _build_loop(7)
    assert ex.run(g).result(30) is None
    assert state["runs"] == 7


def test_condition_loop_rerunnable(ex):
    g, state = _build_loop(4)
    for expect in (4, 8, 12):
        ex.run(g).result(30)
        assert state["runs"] == expect
        g.reset()
    assert g.run_count == 3


def test_condition_loop_failure_resolves_future(ex):
    boom = {"at": 3, "i": 0}
    g = TaskGraph()
    entry = g.add(lambda: boom.update(i=0), name="entry", affinity="local")

    # pass counting and the triggered failure stay scheduler-side
    # (affinity="local"): the loop machinery under test is identical on
    # every backend, and the counter must be authoritative
    def body():
        boom["i"] += 1
        if boom["i"] == boom["at"]:
            raise ValueError("pass 3 failed")

    bt = g.add(body, name="body", affinity="local")
    bt.after(entry)
    # the condition consumes the body's value edge, so a body failure
    # propagates into it (skip + adopt) and the loop stops that pass
    cond = g.add(
        lambda _x: 0 if boom["i"] < 10 else 1, kind="condition", takes_inputs=True
    )
    cond.succeed(bt)
    cond.precede(bt)
    for t in g.tasks:
        t.propagate_errors = False
    with pytest.raises(ValueError, match="pass 3"):
        ex.run(g).result(30)
    assert boom["i"] == 3  # the loop stopped at the failing pass


# ---------------------------------------------------------------------------
# counted completion
# ---------------------------------------------------------------------------


def test_counted_completion_resolves_exactly_at_quiescence(ex):
    """Condition graphs complete by counted quiescence (§10), not by the
    hidden-sink protocol: the run future resolves only after the final
    pass, and the pool is immediately idle when it does."""
    g, state = _build_loop(5)
    fut = ex.run(g)
    assert fut.result(30) is None
    assert state["runs"] == 5  # resolved exactly at the last pass
    assert ex.wait_idle(10) is True  # nothing still in flight behind it


def test_counted_completion_branch_not_taken_is_not_awaited(ex):
    """The counted protocol must not wait for branches the condition
    never released — a not-taken branch would otherwise hang the run."""
    g = TaskGraph()
    c = g.add(lambda: 0, kind="condition")
    taken = g.add(lambda: "yes")
    skipped = g.add(lambda: "no")
    c.precede(taken, skipped)
    assert ex.run(g).result(30) is None
    assert taken.result == "yes" and skipped.result is None


# ---------------------------------------------------------------------------
# dynamic subflows
# ---------------------------------------------------------------------------


def test_subflow_join_before_successor(ex):
    """Every runtime-spawned task completes before the spawner's successor
    runs, and the gather's result is visible through the spawner."""
    g = TaskGraph()

    def spawn(rt):
        ws = [rt.add(lambda i=i: i * i, name=f"w{i}") for i in range(8)]
        return rt.gather(ws)

    sp = g.add(spawn, takes_runtime=True, name="spawn")
    # the spawner's dataflow value is the gather's result (join unwraps it)
    done = g.then(sp, lambda vals: sorted(vals))
    assert ex.run(g).result(30) is None
    assert done.result == [i * i for i in range(8)]
    assert all(w.done for w in sp._spawned)  # joined before the successor


def test_subflow_sized_by_runtime_data(ex):
    """The fan-out width comes from data the task sees at execution time."""
    g = TaskGraph()
    width = g.add(lambda: 5, name="width")

    def spawn(rt, n):
        return rt.gather([rt.add(lambda i=i: i, name=f"s{i}") for i in range(n)])

    sp = g.add(spawn, takes_inputs=True, takes_runtime=True, name="spawn")
    sp.succeed(width)
    total = g.then(sp, sum)
    assert ex.run(g).result(30) is None
    assert total.result == sum(range(5))
    assert len(sp._spawned) == 6  # 5 workers + gather


def test_subflow_failure_propagates_to_future(ex):
    g = TaskGraph()

    def spawn(rt):
        rt.add(lambda: None)
        rt.add(lambda: (_ for _ in ()).throw(RuntimeError("shard died")))

    sp = g.add(spawn, takes_runtime=True)
    g.then(sp, lambda _gt: None)
    for t in g.tasks:
        t.propagate_errors = False
    with pytest.raises(RuntimeError, match="shard died"):
        ex.run(g).result(30)
    assert isinstance(sp.exception, RuntimeError)  # adopted by the spawner
    ex.wait_idle(30)  # pool not poisoned


def test_nested_subflow_spawner(ex):
    """A spawned task may itself be a takes_runtime spawner; the outer
    successor still waits for the innermost join."""
    g = TaskGraph()

    def outer_spawn(rt):
        def inner_spawn(rt2):
            return rt2.gather([rt2.add(lambda i=i: ("inner", i)) for i in range(3)])

        return rt.add(inner_spawn, takes_runtime=True, name="inner")

    sp = g.add(outer_spawn, takes_runtime=True, name="outer")
    after = g.then(sp, lambda inner_vals: sorted(inner_vals))
    assert ex.run(g).result(30) is None
    assert after.result == [("inner", i) for i in range(3)]


# ---------------------------------------------------------------------------
# §12 replay parity
# ---------------------------------------------------------------------------


def test_replay_parity_across_passes(ex):
    """Pass 1 runs live, later passes replay (where the backend compiles
    plans): results must be identical in every pass, the plan must stay
    un-diverged, and plan availability must match the backend contract
    (every ThreadPool-derived backend compiles; serial never does)."""
    g = TaskGraph("chain")
    a = g.add(lambda: 2, name="a")
    b = g.then(a, lambda v: v + 3, name="b")
    c = g.then(b, lambda v: v * 10, name="c")
    results = []
    for _ in range(4):
        ex.run(g).result(30)
        results.append((a.result, b.result, c.result))
    assert results == [(2, 5, 50)] * 4
    assert (g.replay_plan is not None) == (ex.backend != "serial")
    if g.replay_plan is not None:
        assert not g.replay_plan.diverged


def test_replay_parity_with_condition_loop(ex):
    """Counted (condition) graphs run replay-armed passes too: the loop
    executes the same number of body passes every round."""
    g, state = _build_loop(3)
    for expect in (3, 6, 9):
        ex.run(g).result(30)
        assert state["runs"] == expect
        g.reset()


# ---------------------------------------------------------------------------
# §14: retry / timeout / at-most-once — the backend-uniform contract
# ---------------------------------------------------------------------------


def test_retry_to_success(ex):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError(f"transient {len(calls)}")
        return 42

    t = Task(flaky, name="flaky", affinity="local",
             retry=RetryPolicy(max_attempts=5, backoff=0.001))
    t.propagate_errors = False
    assert ex.run(t).result(30) == 42
    assert ex.stats()["retries"] == 2


def test_cooperative_timeout(ex):
    def body():
        for _ in range(200):
            time.sleep(0.005)
            checkpoint()

    t = Task(body, name="deadline", affinity="local", timeout=0.05)
    t.propagate_errors = False
    with pytest.raises(TaskTimeoutError, match="deadline"):
        ex.run(t).result(30)
    assert ex.stats()["timeouts"] == 1


def test_at_most_once_gate_for_started_losses(ex):
    """The §14 gate is scheduler-side and must hold on every backend: a
    ``WorkerDiedError(started=True)`` is never retried for a
    non-idempotent task — even under a matching policy — and is retried
    normally once the task declares ``idempotent=True``."""
    calls = []

    def started_loss():
        calls.append(1)
        raise WorkerDiedError("synthetic started transport loss", started=True)

    pol = RetryPolicy(max_attempts=3, backoff=0, retry_on=WorkerDiedError)
    t = Task(started_loss, name="amo", affinity="local", retry=pol)
    t.propagate_errors = False
    with pytest.raises(WorkerDiedError):
        ex.run(t).result(30)
    assert len(calls) == 1  # started=True + non-idempotent: no retry

    calls.clear()
    t2 = Task(started_loss, name="amo-idem", affinity="local", retry=pol,
              idempotent=True)
    t2.propagate_errors = False
    with pytest.raises(WorkerDiedError):
        ex.run(t2).result(30)
    assert len(calls) == 3  # idempotent: policy runs to exhaustion


def test_pre_start_losses_always_retryable(ex):
    """``started=False`` transport losses are safe on any backend: the
    body never ran, so a matching policy retries regardless of
    idempotency."""
    calls = []

    def prestart_loss():
        calls.append(1)
        if len(calls) < 2:
            raise WorkerDiedError("synthetic pre-start loss", started=False)
        return "delivered"

    t = Task(prestart_loss, name="prestart", affinity="local",
             retry=RetryPolicy(max_attempts=3, backoff=0, retry_on=WorkerDiedError))
    t.propagate_errors = False
    assert ex.run(t).result(30) == "delivered"
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# §8 observer accounting
# ---------------------------------------------------------------------------


class _CountingObserver:
    """Thread-safe §8 observer counting scheduler events."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submits = 0
        self.starts = 0
        self.finishes = 0
        self.retries = 0
        self.timeouts = 0

    def _bump(self, field):
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def on_submit(self, task):
        self._bump("submits")

    def on_start(self, task, worker):
        self._bump("starts")

    def on_finish(self, task, worker):
        self._bump("finishes")

    def on_steal(self, task, thief, victim):  # pragma: no cover - not compared
        pass

    def on_retry(self, task, attempt, worker):
        self._bump("retries")

    def on_timeout(self, task, worker):
        self._bump("timeouts")


def _observed_graph():
    g = TaskGraph("observed")
    layer = [g.add(lambda i=i: i, name=f"t{i}") for i in range(6)]
    g.gather(layer, name="sink")
    return g


def test_observer_counts_balanced(ex):
    obs = _CountingObserver()
    ex.add_observer(obs)
    try:
        ex.run(_observed_graph()).result(30)
        ex.wait_idle(30)
    finally:
        ex.remove_observer(obs)
    assert obs.starts == obs.finishes >= 7  # 6 tasks + gather (+ bookkeeping)
    # on_submit is a queue-push event: inline continuations skip it and
    # the serial baseline has no queue, so the portable invariant is a
    # bound, not equality — every queued task is eventually started
    assert obs.submits <= obs.starts
    assert obs.retries == obs.timeouts == 0


def test_observer_counts_identical_across_backends():
    """The same graph produces the same §8 *execution* ledger on every
    backend — offloading bodies must not add, drop or double any start,
    finish, retry or timeout event. (Submit counts are queue events and
    legitimately interleaving-dependent: inline continuations never
    queue, so they are excluded from the cross-backend comparison.)"""
    ledgers = {}
    for backend in BACKENDS:
        obs = _CountingObserver()
        with Executor(2, backend=backend) as e:
            e.add_observer(obs)
            e.run(_observed_graph()).result(30)
            e.wait_idle(30)
        ledgers[backend] = (obs.starts, obs.finishes, obs.retries, obs.timeouts)
    assert len(set(ledgers.values())) == 1, ledgers


# ---------------------------------------------------------------------------
# run_until + asyncio bridge
# ---------------------------------------------------------------------------


def test_run_until_reruns_to_convergence(ex):
    # convergence state is carried by the task's own result: the predicate
    # reads parent-side task state, valid on every backend
    state = {"x": 100.0}
    g = TaskGraph()

    def halve():
        state["x"] /= 2
        return state["x"]

    t = g.add(halve, affinity="local")  # caller-side loop, caller-side state
    rounds = ex.run_until(g, lambda: t.result < 1.0)
    assert rounds == 7  # 100 / 2^7 < 1
    assert g.run_count == 7


def test_run_until_max_rounds(ex):
    g = TaskGraph()
    g.add(lambda: None)
    with pytest.raises(RuntimeError, match="still false"):
        ex.run_until(g, lambda: False, max_rounds=3)
    assert g.run_count == 3


def test_await_future_from_asyncio(ex):
    async def main():
        return await ex.run(lambda: 6 * 7)

    assert asyncio.run(main()) == 42


def test_await_future_already_resolved(ex):
    fut = ex.run(lambda: "early")
    fut.result(30)

    async def main():
        return await fut

    assert asyncio.run(main()) == "early"


def test_await_future_delivers_exception(ex):
    async def main():
        await ex.run(lambda: (_ for _ in ()).throw(ValueError("async boom")))

    with pytest.raises(ValueError, match="async boom"):
        asyncio.run(main())


def test_co_run_graph_with_condition_loop(ex):
    g, state = _build_loop(5)

    async def main():
        await ex.co_run(g)
        return state["runs"]

    assert asyncio.run(main()) == 5


def test_co_run_concurrent_awaits(ex):
    """Several co_run awaitables progress concurrently on one loop."""

    async def main():
        futs = [ex.co_run(lambda i=i: i * 10) for i in range(5)]
        return await asyncio.gather(*futs)

    assert asyncio.run(main()) == [0, 10, 20, 30, 40]


# ---------------------------------------------------------------------------
# the port against the reference package, backend by backend
# ---------------------------------------------------------------------------


def _mixed_graph(core):
    """A condition loop (state in the condition body), a subflow gathered
    into a dataflow value, and dataflow edges joining them: the same graph
    in either package. Returns (graph, result tasks, loop state)."""
    g = core.TaskGraph("mixed")
    state = {"i": 0}
    src = g.add(lambda: list(range(6)), name="src")
    sq = g.then(src, lambda xs: [x * x for x in xs], name="sq")

    def spawn(rt):
        return rt.gather([rt.add(lambda k=k: 10 * k, name=f"p{k}") for k in range(4)])

    sub = g.add(spawn, takes_runtime=True, name="sub")
    sub.after(src)
    parts = g.then(sub, lambda vals: sorted(vals), name="parts")
    total = g.gather([sq, parts], name="total")
    body = g.add(lambda: None, name="body")
    body.after(src)

    def more():
        state["i"] += 1
        return 0 if state["i"] < 5 else 1

    cond = g.add(more, kind="condition", name="more")
    cond.after(body)
    cond.precede(body)
    return g, (sq, parts, total), state


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_graph_equals_the_reference_package(backend):
    import repro.core as ref_core

    import repro_torch.core as port_core

    got = {}
    for name, core in (("reference", ref_core), ("port", port_core)):
        n = 2 if backend in ("process", "socket") else 4
        with core.Executor(n, backend=backend) as e:
            g, outs, state = _mixed_graph(core)
            for _ in range(2):  # a second pass replays the settled graph
                state["i"] = 0
                e.run(g).result(60)
            got[name] = ([t.result for t in outs], state["i"])
    assert got["port"] == got["reference"]
    assert got["port"] == ([[0, 1, 4, 9, 16, 25], [0, 10, 20, 30],
                            [[0, 1, 4, 9, 16, 25], [0, 10, 20, 30]]], 5)
