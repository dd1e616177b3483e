"""The port's copy of the trace-time schedule simulator (DESIGN.md §2,
``repro_torch.core.schedule``) and the pipeline's tick table.

First, every function is held equal to the reference's, array for array:
``simulate``, ``pipeline_schedule``, ``gpipe_schedule``, ``schedule_to_table``,
``peak_activation_buffers`` and ``forward_tick_table`` over stages S in
{1, 2, 3, 4, 8} and microbatches M in 1..16, and ``simulate`` on
hypothesis-drawn DAGs. Then the reference's property tests
(``tests/core/test_schedule.py``) run against the copy: generated schedules
respect every dependency edge, and applied to pipeline parallelism the
policy reproduces canonical 1F1B (makespan and the S-s activation-memory
bound).
"""
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # fallback shim; requirements-dev.txt pins the real one
    from repro.testing import given, settings, st

from repro_torch.core import (
    SimTask,
    gpipe_schedule,
    peak_activation_buffers,
    pipeline_schedule,
    pipeline_task_graph,
    schedule_to_table,
    simulate,
)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


def _check_valid(tasks, res):
    for tid, t in enumerate(tasks):
        for succ in t.successors:
            assert res.start[succ] >= res.end[tid] - 1e-9, (
                f"{tasks[succ].name} started before {t.name} finished"
            )


@st.composite
def random_dags(draw):
    n = draw(st.integers(min_value=1, max_value=40))
    num_workers = draw(st.integers(min_value=1, max_value=6))
    tasks = []
    for i in range(n):
        pinned = draw(st.booleans())
        tasks.append(
            SimTask(
                name=f"t{i}",
                cost=float(draw(st.integers(min_value=1, max_value=5))),
                worker=(
                    draw(st.integers(min_value=0, max_value=num_workers - 1)) if pinned else None
                ),
                priority=float(draw(st.integers(min_value=0, max_value=3))),
            )
        )
    # edges only i -> j with i < j: guaranteed acyclic
    for j in range(1, n):
        for i in range(j):
            if draw(st.booleans()) and draw(st.integers(0, 3)) == 0:
                tasks[i].successors.append(j)
                tasks[j].num_predecessors += 1
    return tasks, num_workers


@settings(max_examples=60, deadline=None)
@given(random_dags())
def test_simulated_schedules_respect_dependencies(dag):
    tasks, num_workers = dag
    res = simulate(tasks, num_workers)
    _check_valid(tasks, res)
    # every task scheduled exactly once
    scheduled = [tid for tl in res.timelines for (tid, _s, _e) in tl]
    assert sorted(scheduled) == list(range(len(tasks)))
    # pinned tasks ran on their pinned worker
    for w, tl in enumerate(res.timelines):
        for tid, _s, _e in tl:
            if tasks[tid].worker is not None:
                assert tasks[tid].worker == w
    # no worker overlaps itself
    for tl in res.timelines:
        spans = sorted((s, e) for _t, s, e in tl)
        for (s0, e0), (s1, _e1) in zip(spans, spans[1:]):
            assert s1 >= e0 - 1e-9
    # makespan is at least the critical path and at most the serial time
    assert res.makespan <= sum(t.cost for t in tasks) + 1e-9


@settings(max_examples=30, deadline=None)
@given(
    st.integers(min_value=1, max_value=8),
    st.integers(min_value=1, max_value=24),
)
def test_pipeline_schedule_is_canonical_1f1b(S, M):
    tasks = pipeline_task_graph(S, M)
    res = pipeline_schedule(S, M)
    _check_valid(tasks, res)
    # canonical 1F1B makespan with unit costs
    assert res.makespan == pytest.approx(2 * (S - 1) + 2 * M)
    # 1F1B memory property: stage s buffers at most S - s activations
    peaks = peak_activation_buffers(tasks, res, S)
    for s, p in enumerate(peaks):
        assert p <= S - s
    # work conservation: every stage runs one F and one B per microbatch
    table = schedule_to_table(tasks, res, S)
    for s in range(S):
        ops = [row[s] for row in table if row[s] is not None]
        assert len(ops) == 2 * M
        assert sorted((o.kind, o.microbatch) for o in ops) == sorted(
            [("F", m) for m in range(M)] + [("B", m) for m in range(M)]
        )


@settings(max_examples=20, deadline=None)
@given(
    st.integers(min_value=2, max_value=8),
    st.integers(min_value=2, max_value=16),
)
def test_gpipe_buffers_all_microbatches_1f1b_does_not(S, M):
    onef1b_tasks = pipeline_task_graph(S, M)
    onef1b = pipeline_schedule(S, M)
    g_tasks = pipeline_task_graph(S, M, memory_limited=False)
    gpipe = gpipe_schedule(S, M)
    _check_valid(g_tasks, gpipe)
    g_peaks = peak_activation_buffers(g_tasks, gpipe, S)
    o_peaks = peak_activation_buffers(onef1b_tasks, onef1b, S)
    assert max(g_peaks) == M  # GPipe buffers every microbatch
    assert max(o_peaks) == min(S, M)  # 1F1B caps at pipeline depth
    # and the anti-dependency edges cost no throughput with unit costs
    assert onef1b.makespan <= gpipe.makespan + 1e-9


def test_work_stealing_balances_unpinned_tasks():
    """Independent unpinned tasks spread across workers via stealing."""
    tasks = [SimTask(name=f"t{i}", cost=1.0) for i in range(16)]
    res = simulate(tasks, 4)
    sizes = [len(tl) for tl in res.timelines]
    assert sum(sizes) == 16
    assert res.makespan == pytest.approx(4.0)  # perfect balance


def test_deadlock_detection():
    a = SimTask(name="a")
    b = SimTask(name="b")
    a.successors.append(1)
    b.num_predecessors = 1
    b.successors.append(0)
    a.num_predecessors = 1  # cycle
    with pytest.raises(RuntimeError, match="deadlock"):
        simulate([a, b], 2)


# ---------------------------------------------------------------------------
# the copy against the reference, exactly
# ---------------------------------------------------------------------------

STAGES = (1, 2, 3, 4, 8)
MICROBATCHES = tuple(range(1, 17))


def _result(res):
    """A SimResult as plain values, for exact comparison across packages."""
    return (res.timelines, res.makespan, sorted(res.start.items()), sorted(res.end.items()))


def _table(table):
    return [[None if op is None else (op.kind, op.microbatch, op.stage) for op in row]
            for row in table]


def _sim_tasks(core, dag):
    """The same DAG as each package's SimTasks (the draw's own objects are
    the port's)."""
    return [core.SimTask(name=t.name, cost=t.cost, worker=t.worker, priority=t.priority,
                         successors=list(t.successors), num_predecessors=t.num_predecessors)
            for t in dag]


@pytest.mark.parametrize("S", STAGES)
def test_pipeline_schedules_equal_the_reference(S):
    from repro.core import schedule as ref

    from repro_torch.core import schedule as port

    for M in MICROBATCHES:
        for limited in (True, False):
            rt = ref.pipeline_task_graph(S, M, memory_limited=limited)
            pt = port.pipeline_task_graph(S, M, memory_limited=limited)
            assert [(t.name, t.cost, t.worker, t.priority, t.successors, t.num_predecessors,
                     (t.payload.kind, t.payload.microbatch, t.payload.stage)) for t in pt] == [
                (t.name, t.cost, t.worker, t.priority, t.successors, t.num_predecessors,
                 (t.payload.kind, t.payload.microbatch, t.payload.stage)) for t in rt], (S, M)
            make_r = ref.pipeline_schedule if limited else ref.gpipe_schedule
            make_p = port.pipeline_schedule if limited else port.gpipe_schedule
            rr, pr = make_r(S, M), make_p(S, M)
            assert _result(pr) == _result(rr), (S, M, limited)
            assert _table(port.schedule_to_table(pt, pr, S)) == _table(
                ref.schedule_to_table(rt, rr, S)), (S, M, limited)
            assert port.peak_activation_buffers(pt, pr, S) == ref.peak_activation_buffers(
                rt, rr, S), (S, M, limited)


@pytest.mark.parametrize("S", STAGES)
def test_forward_tick_table_equals_the_reference(S):
    import numpy as np
    from repro.parallel.pipeline import forward_tick_table as ref_table

    from repro_torch.parallel.pipeline import forward_tick_table

    for M in MICROBATCHES:
        got, want = forward_tick_table(S, M), ref_table(S, M)
        assert got.dtype == want.dtype and got.shape == want.shape, (S, M)
        np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(random_dags(), st.booleans())
def test_simulate_equals_the_reference_on_random_dags(dag, steal):
    from repro import core as ref_core

    from repro_torch import core as port_core

    tasks, num_workers = dag
    got = port_core.simulate(_sim_tasks(port_core, tasks), num_workers, allow_steal=steal)
    want = ref_core.simulate(_sim_tasks(ref_core, tasks), num_workers, allow_steal=steal)
    assert _result(got) == _result(want)
