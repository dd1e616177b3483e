"""Shared-memory arena: pooled recycling, ephemeral receipt, lifetimes (the
port's copy of ``tests/dist/test_shm_arena.py``, against ``repro_torch``).

The exhaustion case pairs its jobs on a cross-process barrier
(:data:`_PAIR`), so two large-array jobs are always in flight together and
the capped arena always overflows: the reference's copy left that to the
threads' timing, and on a busy host the jobs ran one after another."""
import multiprocessing

import numpy as np
import torch

from repro_torch.dist.shm_arena import ArrayRef, ShmArena, _bucket

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

# two parties, created at import so the pool's forked workers inherit it;
# a body reads it as a module global (a barrier does not pickle, so the
# wire leaves it to the worker's inherited module)
_PAIR = multiprocessing.get_context("fork").Barrier(2)


def _paired_sum(a):
    _PAIR.wait(60)  # the other worker holds its job's segment meanwhile
    return float(a.sum())


def test_round_trip_pooled():
    arena = ShmArena(threshold=0)
    try:
        a = np.arange(24, dtype=np.int64).reshape(4, 6)
        ref = arena.put(a)
        assert not ref.ephemeral
        out = arena.get(ref)
        np.testing.assert_array_equal(out, a)
        arena.recycle(ref)
    finally:
        arena.close()


def test_pooled_segments_are_recycled():
    arena = ShmArena(threshold=0)
    try:
        a = np.zeros(1000, dtype=np.float64)
        r1 = arena.put(a)
        arena.recycle(r1)
        r2 = arena.put(a + 1)  # same bucket: must reuse the freed segment
        assert r2.name == r1.name
        assert arena.get(r2)[0] == 1.0
        arena.recycle(r2)
        assert len(arena._owned) == 1  # one segment served both jobs
    finally:
        arena.close()


def test_distinct_buckets_get_distinct_segments():
    arena = ShmArena(threshold=0)
    try:
        r_small = arena.put(np.zeros(10, dtype=np.int8))
        r_big = arena.put(np.zeros(1 << 20, dtype=np.int8))
        assert r_small.name != r_big.name
        arena.recycle(r_small)
        arena.recycle(r_big)
    finally:
        arena.close()


def test_ephemeral_result_copied_and_unlinked():
    producer = ShmArena(threshold=0, attach_only=True)
    consumer = ShmArena(threshold=0)
    try:
        a = np.arange(128, dtype=np.float32)
        ref = producer.put(a)
        assert ref.ephemeral
        out = consumer.get(ref)
        np.testing.assert_array_equal(out, a)
        out[0] = 99.0  # the copy is owned: segment already gone
        # re-attach must fail: receipt unlinked the segment
        import pytest
        from multiprocessing import shared_memory

        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=ref.name)
    finally:
        producer.close()
        consumer.close()


def test_noncontiguous_and_zero_dim_arrays():
    arena = ShmArena(threshold=0)
    try:
        a = np.arange(64).reshape(8, 8)[:, ::2]  # non-contiguous view
        ref = arena.put(a)
        np.testing.assert_array_equal(arena.get(ref), a)
        arena.recycle(ref)
        scalar = np.float64(3.5).reshape(())
        ref2 = arena.put(scalar)
        assert arena.get(ref2).item() == 3.5
        arena.recycle(ref2)
    finally:
        arena.close()


def test_bucket_rounding():
    assert _bucket(1) == 4096
    assert _bucket(4096) == 4096
    assert _bucket(4097) == 8192
    assert _bucket(3 << 20) == 4 << 20


def test_array_ref_pickles():
    import pickle

    ref = ArrayRef("seg", (2, 3), "float32", 24, True)
    out = pickle.loads(pickle.dumps(ref))
    assert (out.name, out.shape, out.dtype, out.nbytes, out.ephemeral) == (
        "seg",
        (2, 3),
        "float32",
        24,
        True,
    )


def test_close_unlinks_owned_segments():
    arena = ShmArena(threshold=0)
    ref = arena.put(np.zeros(16))
    name = ref.name
    arena.close()
    import pytest
    from multiprocessing import shared_memory

    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)


def test_max_pooled_cap_falls_back_to_ephemeral_without_blocking():
    """§11 satellite: at the ``max_pooled`` cap, ``put`` degrades to an
    ephemeral segment instead of blocking or growing — values still
    deliver intact, and the overflow is visible in stats()."""
    arena = ShmArena(threshold=0, max_pooled=2)
    try:
        arrays = [np.full(1000, float(i)) for i in range(5)]
        refs = [arena.put(a) for a in arrays]
        assert sum(not r.ephemeral for r in refs) == 2  # the cap
        assert sum(r.ephemeral for r in refs) == 3  # the overflow
        for ref, a in zip(refs, arrays):
            np.testing.assert_array_equal(arena.get(ref), a)
        s = arena.stats()
        assert s["pooled_segments"] == 2  # never grew past the cap
        assert s["ephemeral_created"] == 3
        assert s["ephemeral_unlinked"] == 3  # get() released each one
        for ref in refs:
            arena.recycle(ref)
        # recycled pooled segments serve the next round (no new creation)
        r = arena.put(np.ones(1000))
        assert not r.ephemeral
        assert arena.stats()["pooled_created"] == 2
        arena.recycle(r)
    finally:
        arena.close()


def test_exhaustion_under_concurrent_jobs_stays_deadlock_free():
    """A capped arena under a real ProcessPool: more concurrent large-array
    jobs than pooled segments. Overflow rides ephemeral segments, every
    job completes (no checkout ever blocks), and the recycle counters
    surface through ``pool.stats()['arena']``."""
    from repro_torch.core import Executor, TaskGraph
    from repro_torch.dist import ProcessPool

    with ProcessPool(2, arena_threshold=1024, arena_max_pooled=1,
                     name="capped-arena") as pool:
        g = TaskGraph()
        heads = [
            g.add(lambda i=i: np.full(2000, float(i)), name=f"mk{i}",
                  affinity="local")
            for i in range(6)
        ]
        sums = [g.then(h, lambda a: _paired_sum(a)) for h in heads]
        Executor(pool=pool).run(g).result(180)
        assert [t.result for t in sums] == [2000.0 * i for i in range(6)]
        arena = pool.stats()["arena"]
        assert arena["pooled_segments"] <= 1  # the cap held
        assert arena["ephemeral_created"] >= 1  # overflow took the fallback
        assert arena["pooled_recycled"] >= 1  # and pooled traffic recycled


def test_stats_counters_round_trip():
    arena = ShmArena(threshold=0)
    try:
        ref = arena.put(np.zeros(100))
        arena.recycle(ref)
        ref2 = arena.put(np.zeros(100))
        arena.recycle(ref2)
        s = arena.stats()
        assert s["pooled_created"] == 1
        assert s["pooled_reused"] == 1
        assert s["pooled_recycled"] == 2
        assert s["free_segments"] == 1
    finally:
        arena.close()


def test_freelist_keyed_by_requested_bucket_not_os_size():
    """recycle must file segments under the checkout bucket: the OS may
    page-round seg.size (macOS: 16 KiB), which would make every lookup
    miss and grow the pool unboundedly (review fix)."""
    arena = ShmArena(threshold=0)
    try:
        ref = arena.put(np.zeros(100, dtype=np.int8))  # bucket 4096
        arena.recycle(ref)
        assert list(arena._free) == [4096]  # keyed by bucket, whatever fstat says
        ref2 = arena.put(np.zeros(200, dtype=np.int8))
        assert ref2.name == ref.name  # reused even if seg.size were rounded
    finally:
        arena.close()


_TWO_POOLS = """
import numpy as np
import repro_torch.core as core

for _ in range(2):
    with core.Executor(2, backend="process") as ex:
        g = core.TaskGraph("edges")
        src = g.add(lambda: np.arange(40960, dtype=np.float64), name="src")
        sq = g.then(src, lambda a: a * a, name="sq")
        ex.run(g).result(60)
        assert float(sq.result[-1]) == 40959.0 ** 2
print("ok")
"""


def test_second_process_pool_leaves_stderr_empty():
    """ROADMAP F13: two process pools in turn, each moving an array edge
    value through the arena (a pooled segment a worker attaches), print
    nothing on stderr. Before the repair, the resource tracker that the
    second pool's workers share with their parent printed ``KeyError:
    '/repro_a_...'`` tracebacks as the parent unlinked its segments."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-c", _TWO_POOLS], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert proc.stderr == ""
