"""The port's copy of graph capture and replay (``repro_torch/core/replay.py``)
in the scenario of the reference's
``tests/core/test_replay.py::test_cancellation_mid_replay_falls_back_live``.

That reference test fails alone: its first pass parks the head on
``release.wait(10)`` while the test waits at most 10 s for the pass's result,
so the pass's result times out before the test ever reaches the replay
(the race, not the scheduler). Here the first pass runs through, and the
rest of the scenario is the same: a cancelled replayed pass marks its plan
diverged, and the next pass runs live and is right."""
import threading

import pytest

from repro_torch.core import CancelledError, Executor, TaskGraph


def _cancel_mid_replay(tex):
    g = TaskGraph("cancel")
    gate = threading.Event()
    release = threading.Event()
    hits = []

    def slow():
        gate.set()
        assert release.wait(10)
        hits.append(1)

    head = g.add(slow, name="head")
    g.then(head, lambda _: hits.append(2), name="tail")
    release.set()  # the live pass runs through
    tex.run(g).result(10)
    gate.clear()
    release.clear()
    fut = tex.run(g)  # replayed pass
    plan = g.replay_plan
    assert plan is not None
    assert gate.wait(10)  # head is running inside the replay
    fut.cancel()
    release.set()
    with pytest.raises(CancelledError):
        fut.result(10)
    assert plan.diverged
    assert tex.wait_idle(10)
    hits.clear()
    tex.run(g).result(10)  # live fallback
    assert hits == [1, 2]
    return g


def test_cancellation_mid_replay_falls_back_live():
    with Executor(4, backend="thread") as tex:
        _cancel_mid_replay(tex)


def test_replay_recompiles_after_the_live_fallback():
    """After the live fallback the graph settles again and a later pass
    replays from a fresh plan, with the same result."""
    with Executor(4, backend="thread") as tex:
        g = _cancel_mid_replay(tex)
        old = g.replay_plan
        for _ in range(2):
            tex.run(g).result(10)
        assert g.replay_plan is not None and g.replay_plan is not old
        assert not g.replay_plan.diverged
