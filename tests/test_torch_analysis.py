"""The port's graph verifier (``repro_torch.analysis``): the reference's
tests of the linter, the race detector, the schedule fuzzer and
``Executor(verify=)`` (``tests/analysis/test_{lint,races,fuzz,verify}.py``),
run against the copies."""
import warnings

import pytest
import torch

import repro_torch.analysis.verify as verify_mod
from repro_torch.analysis.fuzz import _corpus, fuzz_schedules, main
from repro_torch.analysis.lint import RULES, Finding, lint_graph, rule_catalog
from repro_torch.analysis.races import RaceObserver, detect_races, task_writes
from repro_torch.analysis.verify import GraphVerificationError, verify_graph
from repro_torch.core import Executor, RetryPolicy, TaskGraph

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# §15 graph linter: one true-positive and one clean-pass per rule.
# ---------------------------------------------------------------------------


def rules_of(findings):
    return {f.rule for f in findings}


def lint(g, **kw):
    kw.setdefault("races", False)
    return lint_graph(g, **kw)


# -- strong-cycle --------------------------------------------------------------


def test_strong_cycle_true_positive_names_path():
    g = TaskGraph("cyc")
    a = g.add(lambda: None, name="a")
    b = g.add(lambda: None, name="b")
    b.succeed(a)
    a.succeed(b)
    (f,) = [f for f in lint(g) if f.rule == "strong-cycle"]
    assert f.severity == "error"
    assert "a -> b -> a" in f.message
    assert f.tasks == ("a", "b")


def test_strong_cycle_clean_on_weak_loop():
    g = TaskGraph("loop")
    entry = g.add(None, name="entry")
    body = g.add(lambda: None, name="body")
    body.after(entry)
    cond = g.add(lambda: 2, kind="condition", name="more")
    cond.after(body)
    cond.precede(body)
    assert "strong-cycle" not in rules_of(lint(g))


# -- unreachable-task ----------------------------------------------------------


def test_unreachable_true_positive_external_predecessor():
    other = TaskGraph("other")
    ext = other.add(lambda: None, name="ext")
    g = TaskGraph("main")
    t = g.add(lambda: None, name="dangling")
    t.after(ext)  # strong pred lives in a different graph
    found = [f for f in lint(g) if f.rule == "unreachable-task"]
    assert found and "outside this graph" in found[0].message


def test_unreachable_clean_and_not_duplicated_for_cycles():
    g = TaskGraph("ok")
    a = g.add(lambda: None, name="a")
    g.then(a, lambda x: x, name="b")
    assert "unreachable-task" not in rules_of(lint(g))
    # cycle members are the strong-cycle rule's report, not this rule's
    g2 = TaskGraph("cyc")
    x = g2.add(lambda: None, name="x")
    y = g2.add(lambda: None, name="y")
    x.succeed(y)
    y.succeed(x)
    assert "unreachable-task" not in rules_of(lint(g2))


# -- orphan-task ---------------------------------------------------------------


def test_orphan_true_positive():
    g = TaskGraph("orphan")
    g.add(lambda: 1, name="real")
    g.add(None, name="placeholder")
    (f,) = [f for f in lint(g) if f.rule == "orphan-task"]
    assert f.severity == "warning" and f.tasks == ("placeholder",)


def test_orphan_clean_when_wired_or_alone():
    g = TaskGraph("wired")
    entry = g.add(None, name="entry")
    body = g.add(lambda: 1, name="body")
    body.after(entry)
    assert "orphan-task" not in rules_of(lint(g))
    solo = TaskGraph("solo")
    solo.add(None, name="only")
    assert "orphan-task" not in rules_of(lint(solo))


# -- condition-branch-range ----------------------------------------------------


def test_branch_range_error_when_no_return_selects():
    g = TaskGraph("condbad")
    entry = g.add(None, name="entry")
    c = g.add(lambda: 7, kind="condition", name="pick")
    c.after(entry)
    c.precede(g.add(lambda: 1, name="tgt"))
    (f,) = [f for f in lint(g) if f.rule == "condition-branch-range"]
    assert f.severity == "error" and "[7]" in f.message


def test_branch_range_warns_out_of_cycle_only():
    # outside a cycle, a sometimes-out-of-range constant is a warning
    g = TaskGraph("maybe")
    entry = g.add(None, name="entry")
    c = g.add(lambda x=0: 0 if x else 3, kind="condition", name="pick")
    c.after(entry)
    c.precede(g.add(lambda: 1, name="tgt"))
    (f,) = [f for f in lint(g) if f.rule == "condition-branch-range"]
    assert f.severity == "warning" and "[3]" in f.message
    # inside a cycle the same shape is the loop-exit idiom: clean
    g2 = TaskGraph("loop")
    entry2 = g2.add(None, name="entry")
    body = g2.add(lambda: 1, name="body")
    body.after(entry2)
    c2 = g2.add(lambda x=0: 0 if x else 3, kind="condition", name="more")
    c2.after(body)
    c2.precede(body)
    assert "condition-branch-range" not in rules_of(lint(g2))


def test_branch_range_flags_condition_without_successors():
    g = TaskGraph("nosucc")
    entry = g.add(None, name="entry")
    c = g.add(lambda: 0, kind="condition", name="lonely")
    c.after(entry)
    found = [f for f in lint(g) if f.rule == "condition-branch-range"]
    assert found and "no successors" in found[0].message


def test_branch_range_declines_dynamic_bodies():
    g = TaskGraph("dyn")
    entry = g.add(None, name="entry")

    def decide():
        import os

        return len(os.getcwd()) % 2

    c = g.add(decide, kind="condition", name="pick")
    c.after(entry)
    c.precede(g.add(lambda: 1, name="tgt"))
    assert "condition-branch-range" not in rules_of(lint(g))


# -- weak-loop-no-exit ---------------------------------------------------------


def test_weak_loop_no_exit_true_positive():
    g = TaskGraph("noexit")
    entry = g.add(None, name="entry")
    body = g.add(lambda: 1, name="body")
    body.after(entry)
    c = g.add(lambda: 0, kind="condition", name="again")
    c.after(body)
    c.precede(body)
    (f,) = [f for f in lint(g) if f.rule == "weak-loop-no-exit"]
    assert f.severity == "error" and "body" in f.tasks and "again" in f.tasks


def test_weak_loop_clean_with_reachable_exit():
    g = TaskGraph("exit")
    entry = g.add(None, name="entry")
    body = g.add(lambda: 1, name="body")
    body.after(entry)
    state = {"n": 0}

    def more():
        state["n"] += 1
        return 0 if state["n"] < 3 else 9  # 9 selects nothing: the loop drains

    c = g.add(more, kind="condition", name="more")
    c.after(body)
    c.precede(body)
    assert "weak-loop-no-exit" not in rules_of(lint(g))


# -- priority-inversion --------------------------------------------------------


def test_priority_inversion_true_positive():
    g = TaskGraph("inv")
    low = g.add(lambda: 1, name="low", priority=0.0)
    high = g.add(lambda: 2, name="high", priority=5.0)
    high.succeed(low)
    (f,) = [f for f in lint(g) if f.rule == "priority-inversion"]
    assert f.severity == "warning" and f.tasks == ("low", "high")


def test_priority_inversion_clean_on_weak_edges_and_equal_bands():
    g = TaskGraph("ok")
    entry = g.add(None, name="entry", priority=5.0)
    tick = g.add(lambda: 1, name="tick", priority=5.0)
    tick.after(entry)
    c = g.add(lambda: 2, kind="condition", name="more", priority=5.0)
    c.after(tick)
    c.precede(tick)  # weak edges never count, whatever the bands
    assert "priority-inversion" not in rules_of(lint(g))


# -- retry-non-idempotent ------------------------------------------------------


@pytest.mark.parametrize("backend", ["serial", "thread", "process"])
def test_retry_non_idempotent_fires_only_where_offload_is_possible(backend):
    g = TaskGraph("retry")
    g.add(lambda: 1, name="flaky", retry=RetryPolicy(max_attempts=3))
    fired = "retry-non-idempotent" in rules_of(lint(g, backend=backend))
    assert fired == (backend == "process")


def test_retry_non_idempotent_remote_fires_without_backend_context():
    g = TaskGraph("retry-remote")
    g.add(
        lambda: 1, name="flaky", affinity="remote", retry=RetryPolicy(max_attempts=3)
    )
    (f,) = [f for f in lint(g) if f.rule == "retry-non-idempotent"]
    assert "at-most-once" in f.message


@pytest.mark.parametrize("backend", ["serial", "thread", "process"])
def test_retry_clean_when_idempotent_or_local(backend):
    g = TaskGraph("ok")
    g.add(
        lambda: 1,
        name="safe",
        retry=RetryPolicy(max_attempts=3),
        idempotent=True,
        affinity="remote",
    )
    g.add(
        lambda: 2, name="pinned", retry=RetryPolicy(max_attempts=3), affinity="local"
    )
    assert "retry-non-idempotent" not in rules_of(lint(g, backend=backend))


# -- remote-unpicklable --------------------------------------------------------


def test_remote_unpicklable_true_positive():
    import threading

    lock = threading.Lock()
    g = TaskGraph("wire")
    g.add(lambda: lock.acquire(False), name="locked", affinity="remote")
    (f,) = [f for f in lint(g) if f.rule == "remote-unpicklable"]
    assert f.severity == "error" and "locked" in f.tasks


def test_remote_unpicklable_clean_for_wireable_bodies():
    g = TaskGraph("wire-ok")
    g.add(lambda: 40 + 2, name="pure", affinity="remote")
    assert "remote-unpicklable" not in rules_of(lint(g))


# -- affinity-ignored ----------------------------------------------------------


def test_affinity_ignored_true_positive_on_condition():
    g = TaskGraph("aff")
    entry = g.add(None, name="entry")
    c = g.add(lambda: 0, kind="condition", name="pick", affinity="remote")
    c.after(entry)
    c.precede(g.add(lambda: 1, name="tgt"))
    (f,) = [f for f in lint(g) if f.rule == "affinity-ignored"]
    assert "condition" in f.message


def test_affinity_ignored_clean_for_plain_remote_body():
    g = TaskGraph("aff-ok")
    g.add(lambda: 1, name="worker", affinity="remote")
    assert "affinity-ignored" not in rules_of(lint(g))


# -- timeout-control-flow ------------------------------------------------------


def test_timeout_control_flow_true_positive():
    g = TaskGraph("to")
    entry = g.add(None, name="entry")
    c = g.add(lambda: 0, kind="condition", name="pick", timeout=1.0)
    c.after(entry)
    c.precede(g.add(lambda: 1, name="tgt"))
    (f,) = [f for f in lint(g) if f.rule == "timeout-control-flow"]
    assert f.severity == "warning"


def test_timeout_clean_on_plain_bodies():
    g = TaskGraph("to-ok")
    g.add(lambda: 1, name="bounded", timeout=5.0)
    assert "timeout-control-flow" not in rules_of(lint(g))


# -- framework -----------------------------------------------------------------


def test_rule_catalog_lists_every_rule():
    cat = rule_catalog()
    for name in RULES:
        assert name in cat


def test_rules_subset_selection():
    g = TaskGraph("cyc")
    a = g.add(lambda: None, name="a")
    b = g.add(lambda: None, name="b")
    a.succeed(b)
    b.succeed(a)
    only = lint_graph(g, rules=["strong-cycle"], races=False)
    assert rules_of(only) == {"strong-cycle"}
    with pytest.raises(KeyError):
        lint_graph(g, rules=["no-such-rule"], races=False)


def test_finding_str_is_informative():
    f = Finding("strong-cycle", "error", "boom", ("a", "b"), "g")
    assert str(f) == "error[strong-cycle] graph 'g': boom [a, b]"


# ---------------------------------------------------------------------------
# §15 race detector: static dis-level scan + dynamic vector-clock witness.
# ---------------------------------------------------------------------------


COUNTER = 0  # module global written by the global-race fixtures below


def race_rules(findings):
    return [f for f in findings if f.rule == "shared-state-race"]


def make_closure_pair(g):
    """Two independent tasks bumping the same captured variable."""
    total = 0

    def bump_a():
        nonlocal total
        total += 1

    def bump_b():
        nonlocal total
        total += 2

    return g.add(bump_a, name="bump_a"), g.add(bump_b, name="bump_b")


# -- static: task_writes -------------------------------------------------------


def test_task_writes_sees_closure_cell():
    g = TaskGraph("w")
    a, b = make_closure_pair(g)
    wa, wb = task_writes(a), task_writes(b)
    assert wa and wb
    # same cell ⇒ same key; the description names the variable
    assert set(wa) == set(wb)
    assert "captured variable 'total'" in next(iter(wa.values()))


def test_task_writes_sees_global_and_attr():
    class Box:
        def __init__(self):
            self.n = 0

        def poke(self):
            self.n += 1

    box = Box()

    def bump_global():
        global COUNTER
        COUNTER += 1

    g = TaskGraph("w")
    tg = g.add(bump_global, name="g")
    ta = g.add(box.poke, name="a")
    assert any(k[0] == "global" for k in task_writes(tg))
    attr_keys = [k for k in task_writes(ta) if k[0] == "attr"]
    assert attr_keys and attr_keys[0][2] == "n"


def test_task_writes_recurses_into_nested_functions():
    total = 0

    def outer():
        def inner():
            nonlocal total
            total += 1

        inner()

    g = TaskGraph("w")
    t = g.add(outer, name="outer")
    assert any(k[0] == "cell" for k in task_writes(t))


def test_task_writes_ignores_local_state():
    def pure():
        acc = 0
        for i in range(4):
            acc += i
        return acc

    g = TaskGraph("w")
    assert task_writes(g.add(pure, name="pure")) == {}


def test_task_writes_handles_non_functions():
    g = TaskGraph("w")
    assert task_writes(g.add(None, name="none")) == {}
    assert task_writes(g.add(min, name="builtin")) == {}


# -- static: detect_races ------------------------------------------------------


def test_detect_races_flags_unordered_closure_writers():
    g = TaskGraph("racy")
    a, b = make_closure_pair(g)
    (f,) = race_rules(detect_races(g))
    assert f.severity == "error"
    assert set(f.tasks) == {"bump_a", "bump_b"}
    assert "captured variable 'total'" in f.message


def test_detect_races_clean_when_edge_orders_writers():
    g = TaskGraph("ordered")
    a, b = make_closure_pair(g)
    b.succeed(a)
    assert detect_races(g) == []


def test_detect_races_weak_edges_order_too():
    # §10 loop: body and condition both touch the loop counter, but the
    # weak back-edge serializes each pass — not a race.
    g = TaskGraph("loop")
    entry = g.add(None, name="entry")
    i = 0

    def body():
        nonlocal i
        i += 1

    def more():
        nonlocal i
        return 0 if i < 3 else 9

    b = g.add(body, name="body")
    b.after(entry)
    c = g.add(more, kind="condition", name="more")
    c.after(b)
    c.precede(b)
    assert detect_races(g) == []


def test_detect_races_different_cells_do_not_collide():
    g = TaskGraph("distinct")

    def make(name):
        n = 0

        def bump():
            nonlocal n
            return n

        return g.add(bump, name=name)

    make("x")
    make("y")
    assert detect_races(g) == []


def test_lint_graph_includes_races_by_default():
    g = TaskGraph("racy")
    make_closure_pair(g)
    assert race_rules(lint_graph(g))
    assert not race_rules(lint_graph(g, races=False))


# -- dynamic: RaceObserver -----------------------------------------------------


def test_race_observer_orders_chain():
    g = TaskGraph("chain")
    a = g.add(lambda: 1, name="a")
    b = g.add(lambda: 2, name="b")
    b.succeed(a)
    obs = RaceObserver(g)
    with Executor(2, observers=[obs]) as ex:
        ex.run(g).result(10)
    assert obs.happens_before(a, b)
    assert not obs.happens_before(b, a)
    assert not obs.concurrent(a, b)


def test_race_observer_confirms_static_race():
    g = TaskGraph("racy")
    a, b = make_closure_pair(g)
    findings = detect_races(g)
    obs = RaceObserver(g)
    with Executor(2, observers=[obs]) as ex:
        ex.run(g).result(10)
    assert obs.concurrent(a, b)
    (report,) = obs.check(findings)
    assert report["status"] == "confirmed-concurrent"


def test_race_observer_check_unrun_graph_reports_not_observed():
    g = TaskGraph("racy")
    make_closure_pair(g)
    obs = RaceObserver(g)  # never attached to a run
    (report,) = obs.check(detect_races(g))
    assert report["status"] == "not-observed"


def test_race_observer_ignores_foreign_tasks():
    g = TaskGraph("mine")
    a = g.add(lambda: 1, name="a")
    other = TaskGraph("other")
    x = other.add(lambda: 2, name="x")
    obs = RaceObserver(g)
    obs.on_start(x, worker=0)  # must not blow up or pollute clocks
    obs.on_finish(x, worker=0)
    assert not obs.happens_before(x, a)


@pytest.mark.parametrize("backend", ["serial", "thread"])
def test_race_observer_backend_parity(backend):
    g = TaskGraph("diamond")
    src = g.add(lambda: 0, name="src")
    l = g.add(lambda: 1, name="l")
    r = g.add(lambda: 2, name="r")
    join = g.add(lambda: 3, name="join")
    l.succeed(src)
    r.succeed(src)
    join.succeed(l, r)
    obs = RaceObserver(g)
    with Executor(2, backend=backend, observers=[obs]) as ex:
        ex.run(g).result(10)
    # graph order holds on every backend; the branches stay unordered
    assert obs.happens_before(src, join)
    assert obs.concurrent(l, r)


# ---------------------------------------------------------------------------
# §15 schedule fuzzer: result identity across seeded interleavings.
# ---------------------------------------------------------------------------


def test_corpus_graphs_are_schedule_independent():
    for graph, reset in _corpus():
        report = fuzz_schedules(graph, schedules=6, reset=reset)
        assert report.ok, str(report)


def test_schedule_dependent_race_is_flagged():
    # two unordered writers to one slot + a reader below the join: the
    # reader's value depends purely on which writer the schedule ran last
    g = TaskGraph("last-writer-wins")
    slot = {}

    def wa():
        slot["x"] = 1

    def wb():
        slot["x"] = 2

    a = g.add(wa, name="wa")
    b = g.add(wb, name="wb")
    g.gather([a, b], fn=lambda *_: slot["x"], name="read")
    report = fuzz_schedules(g, schedules=8, reset=slot.clear)
    assert not report.ok
    assert report.rerun_deterministic  # same schedule twice agrees...
    assert {f.rule for f in report.findings} == {"schedule-dependent-result"}
    found = [f for f in report.findings if "read" in f.tasks]
    assert found and "depends on execution order" in found[0].message


def test_rerun_nondeterminism_is_separated_from_schedule_dependence():
    g = TaskGraph("stateful")
    state = {"n": 0}

    def bump():
        state["n"] += 1
        return state["n"]

    g.add(bump, name="bump")
    report = fuzz_schedules(g, schedules=8)  # no reset: state leaks across runs
    assert not report.ok and not report.rerun_deterministic
    (f,) = report.findings
    assert f.rule == "rerun-nondeterministic" and "reset=" in f.message
    # with the reset hook the same graph fuzzes clean
    assert fuzz_schedules(g, schedules=8, reset=lambda: state.update(n=0)).ok


def test_exceptions_fingerprint_stably():
    g = TaskGraph("boom")

    def blow():
        raise ValueError("expected")

    g.add(blow, name="blow")
    report = fuzz_schedules(g, schedules=4)
    assert report.ok  # deterministic failure is still schedule-independent
    assert report.baseline["blow"] == ("exception", "ValueError", "expected")


def test_non_terminating_loop_hits_step_limit():
    g = TaskGraph("forever")
    entry = g.add(None, name="entry")
    body = g.add(lambda: 1, name="body")
    body.after(entry)
    c = g.add(lambda: 0, kind="condition", name="again")
    c.after(body)
    c.precede(body)
    with pytest.raises(RuntimeError, match="weak-loop-no-exit"):
        fuzz_schedules(g, schedules=2)


def test_graph_left_reusable_after_fuzzing():
    from repro_torch.core import Executor

    g = TaskGraph("reuse")
    a = g.add(lambda: 21, name="a")
    g.then(a, lambda x: x * 2, name="b")
    assert fuzz_schedules(g, schedules=4).ok
    with Executor(2) as ex:
        ex.run(g).result(10)
    assert g.tasks[1].result == 42


def test_cli_quick_exits_zero(capsys):
    assert main(["--quick"]) == 0
    err = capsys.readouterr().err
    assert "fuzz[fuzz-diamond]" in err and "ok" in err


# ---------------------------------------------------------------------------
# §15 Executor(verify=) integration: modes, caching, consumers stay clean.
# ---------------------------------------------------------------------------


def racy_graph(name="racy"):
    g = TaskGraph(name)
    total = 0

    def wa():
        nonlocal total
        total += 1

    def wb():
        nonlocal total
        total += 2

    g.add(wa, name="wa")
    g.add(wb, name="wb")
    return g


def clean_graph(name="clean"):
    g = TaskGraph(name)
    a = g.add(lambda: 21, name="a")
    g.then(a, lambda x: x * 2, name="b")
    return g


# -- verify_graph facade -------------------------------------------------------


def test_verify_graph_report_shape():
    rep = verify_graph(clean_graph())
    assert rep.ok and rep.errors == [] and "verified clean" in str(rep)
    bad = verify_graph(racy_graph())
    assert not bad.ok and bad.errors
    with pytest.raises(GraphVerificationError) as exc:
        bad.raise_if_errors()
    assert exc.value.report is bad
    assert "shared-state-race" in str(exc.value)


# -- executor modes ------------------------------------------------------------


def test_strict_raises_before_any_task_runs():
    ran = []
    g = racy_graph()
    g.add(lambda: ran.append(1), name="probe")
    with Executor(2, verify="strict") as ex:
        with pytest.raises(GraphVerificationError):
            ex.run(g)
    assert ran == []  # the graph never reached the pool


def test_warn_mode_warns_but_runs():
    g = racy_graph()
    with Executor(2, verify="warn") as ex:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ex.run(g).result(10)
    assert any("shared-state-race" in str(w.message) for w in caught)


def test_off_is_default_and_silent():
    g = racy_graph()
    with Executor(2) as ex:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ex.run(g).result(10)
    assert caught == []


def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match="verify"):
        Executor(1, verify="loud")


def test_env_default(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "strict")
    with Executor(2) as ex:
        with pytest.raises(GraphVerificationError):
            ex.run(racy_graph())
    monkeypatch.setenv("REPRO_VERIFY", "off")
    with Executor(2) as ex:  # env only sets the default; explicit arg wins
        ex.run(clean_graph()).result(10)


def test_strict_green_on_clean_graph_and_result_flows():
    g = clean_graph()
    with Executor(2, verify="strict") as ex:
        ex.run(g).result(10)
    assert g.tasks[1].result == 42


# -- epoch caching -------------------------------------------------------------


def test_verification_cached_per_structure(monkeypatch):
    calls = []
    real = verify_mod.verify_graph

    def counting(graph, **kw):
        calls.append(graph.name)
        return real(graph, **kw)

    monkeypatch.setattr(verify_mod, "verify_graph", counting)
    g = clean_graph("cached")
    with Executor(2, verify="warn") as ex:
        ex.run(g).result(10)
        ex.run(g).result(10)  # same structure: cached, no second pass
        assert calls == ["cached"]
        g.then(g.tasks[-1], lambda x: x, name="c")  # structural change bumps epoch
        ex.run(g).result(10)
        assert calls == ["cached", "cached"]


def test_strict_failure_not_cached(monkeypatch):
    g = racy_graph()
    with Executor(2, verify="strict") as ex:
        with pytest.raises(GraphVerificationError):
            ex.run(g)
        with pytest.raises(GraphVerificationError):
            ex.run(g)  # unchanged broken graph re-raises, not silently cached


# -- shipped consumers stay clean under strict ---------------------------------


def test_prefetcher_lane_graphs_verify_strict():
    from repro_torch.data.pipeline import Prefetcher

    class Src:
        def batch(self, step):
            return {"x": step}

    pf = Prefetcher(Src(), backend="serial", depth=2, device="cpu")
    try:
        for lane in pf._lanes:
            verify_graph(lane.graph).raise_if_errors()
    finally:
        pf.close()


def test_checkpoint_template_graph_verifies_strict(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), keep=2)
    try:
        mgr.save_async(1, {"w": [1.0, 2.0]})
        mgr.wait()
        verify_graph(mgr._tpl_graph).raise_if_errors()
    finally:
        mgr.close()
