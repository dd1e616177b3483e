"""Wire-format unit tests: function shipping (pickle + code-object
fallback), value/argument packs, exception transport.

The port's copy of ``tests/dist/test_wire.py``, against ``repro_torch``.
"""
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.dist.shm_arena import ShmArena
from repro_torch.dist.wire import (
    UnpicklableTaskError,
    dumps_args,
    dumps_exception,
    dumps_fn,
    dumps_value,
    loads_args,
    loads_exception,
    loads_fn,
    loads_value,
    shm_refs,
)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


def module_level(x):
    return x * 3


MODULE_CONST = 17


def test_plain_function_round_trips_by_reference():
    fn = loads_fn(dumps_fn(module_level))
    assert fn(4) == 12


def test_lambda_round_trips_via_code_wire():
    fn = loads_fn(dumps_fn(lambda x: x + 1))
    assert fn(41) == 42


def test_closure_cells_are_captured_by_value():
    def make(k):
        return lambda x: x * k

    fn = loads_fn(dumps_fn(make(5)))
    assert fn(6) == 30


def test_defaults_and_nested_lambdas_ship():
    base = 100

    def make():
        inner = lambda v: v + base  # noqa: E731 - nested closure on purpose
        return lambda x, off=7: inner(x) + off

    fn = loads_fn(dumps_fn(make()))
    assert fn(1) == 108


def test_referenced_globals_ship_by_value():
    # the loaded function must see the submission-time global, not rely on
    # the destination module state (fork-time snapshots go stale)
    fn = loads_fn(dumps_fn(lambda: MODULE_CONST * 2))
    g = fn.__globals__
    assert g["MODULE_CONST"] == 17
    assert fn() == 34


def test_partial_round_trips():
    fn = loads_fn(dumps_fn(functools.partial(module_level, 9)))
    assert fn() == 27


def test_recursive_lambda_global_does_not_recurse_forever():
    # fact references itself through its module globals; the dump guard
    # must break the cycle instead of recursing to a stack overflow
    import sys

    mod = sys.modules[__name__]
    mod.fact = eval("lambda n: 1 if n <= 1 else n * fact(n - 1)", mod.__dict__)
    try:
        wire = dumps_fn(mod.fact)
        assert wire is not None
    finally:
        del mod.fact


def test_closure_over_module_ships_by_name():
    def make():
        import numpy as np_local

        return lambda: np_local.arange(3).sum()

    fn = loads_fn(dumps_fn(make()))
    assert fn() == 3


def test_unpicklable_closure_raises_clear_error():
    lock = threading.Lock()
    with pytest.raises(UnpicklableTaskError, match="does not pickle"):
        dumps_fn(lambda: lock.acquire())


def test_bound_method_of_stateful_object_raises():
    class Holder:
        def __init__(self):
            self.lock = threading.Lock()

        def body(self):
            return 1

    with pytest.raises(UnpicklableTaskError, match="not a plain function"):
        dumps_fn(Holder().body)


def test_value_pack_small_arrays_pickle_large_use_arena():
    arena = ShmArena(threshold=1024)
    try:
        small = np.arange(4)
        large = np.arange(1024, dtype=np.float64)  # 8 KiB >= threshold
        pack = dumps_args((small, large, "tag"), arena)
        refs = shm_refs(pack)
        assert len(refs) == 1 and refs[0].nbytes == large.nbytes
        s, l, t = loads_args(pack, arena)
        np.testing.assert_array_equal(s, small)
        np.testing.assert_array_equal(l, large)
        assert t == "tag"
        for ref in refs:
            arena.recycle(ref)
    finally:
        arena.close()


def test_callable_value_falls_back_to_fn_wire():
    k = 5
    wire = dumps_value(lambda v: v * k)
    assert loads_value(wire)(3) == 15


def test_exception_transport_preserves_type():
    exc = loads_exception(dumps_exception(ValueError("worker boom")))
    assert isinstance(exc, ValueError) and "worker boom" in str(exc)


def test_unpicklable_exception_degrades_to_runtime_error():
    class Weird(Exception):
        def __init__(self):
            super().__init__("weird")
            self.lock = threading.Lock()

    exc = loads_exception(dumps_exception(Weird()))
    assert isinstance(exc, RuntimeError) and "weird" in str(exc)


def test_failed_pack_recycles_partial_arena_blocks():
    """A pack that fails mid-serialization must return already-allocated
    pooled segments to the freelist (review fix: no leak-until-close)."""
    arena = ShmArena(threshold=1024)
    try:
        big = np.zeros(4096, dtype=np.float64)
        with pytest.raises(Exception):
            dumps_args((big, threading.Lock()), arena)
        # the segment created for `big` is back in the freelist
        assert sum(len(v) for v in arena._free.values()) == len(arena._owned) == 1
        with pytest.raises(Exception):
            dumps_args(({"a": big, "bad": threading.Lock()},), arena)
        assert sum(len(v) for v in arena._free.values()) == len(arena._owned) == 1
    finally:
        arena.close()


def test_failed_result_pack_unlinks_ephemeral_segments():
    """Worker-side cleanup contract: a result pack that fails mid-
    serialization unlinks the ephemeral segments already created (review
    fix: recycle handles ephemeral refs — nothing persists in /dev/shm)."""
    from multiprocessing import shared_memory

    arena = ShmArena(threshold=1024, attach_only=True)
    try:
        big = np.zeros(4096, dtype=np.float64)
        ref = arena.put(big)  # simulate the first element of a failing pack
        arena.recycle(ref)
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=ref.name)
        with pytest.raises(Exception):
            dumps_value({"a": big, "bad": threading.Lock()}, arena)
    finally:
        arena.close()


def test_main_module_functions_ship_by_value():
    """A __main__-level function must ride the code wire: its pickle
    reference dangles in any worker forked before the definition ran
    (review-drive fix — the adopted-pool Prefetcher scenario)."""
    k = []  # ensure no accidental closure

    def f(x):
        return x * 4

    f.__module__ = "__main__"  # simulate a script-level def
    wire = dumps_fn(f)
    assert wire[0] != 0  # not a bare pickle reference
    assert loads_fn(wire)(5) == 20 and not k


def test_recursive_inner_function_fails_fast_with_clear_error():
    """A self-referential closure cannot ship by value: the wire reports
    it immediately (no RecursionError stack burn) with an actionable
    message (review fix)."""

    def make():
        def fact(n):
            return 1 if n <= 1 else n * fact(n - 1)

        return fact

    with pytest.raises(UnpicklableTaskError, match="self-referential"):
        dumps_fn(make())


def test_cyclic_container_edge_value_falls_back_to_pickle():
    """A small self-referential container ships via pickle (which handles
    cycles) instead of recursing in the arena scan (review fix)."""
    arena = ShmArena(threshold=1024)
    try:
        cyc = []
        cyc.append(cyc)
        out = loads_value(dumps_value(cyc, arena), arena)
        assert out[0] is out
    finally:
        arena.close()


# ---------------------------------------------------------------------------
# §16 satellite: the edge cases the socket transport leans on
# ---------------------------------------------------------------------------


def test_mutually_recursive_closures_fail_fast_with_clear_error():
    """Two inner functions referencing each other form a closure cycle the
    code wire cannot ship; the dump guard reports it immediately (no
    RecursionError stack burn) with the same actionable message as the
    direct self-reference case."""

    def make():
        def even(n):
            return True if n == 0 else odd(n - 1)

        def odd(n):
            return False if n == 0 else even(n - 1)

        return even

    with pytest.raises(UnpicklableTaskError, match="self-referential"):
        dumps_fn(make())


def test_lambda_capturing_module_object_in_cell_ships_by_name():
    """A module object held in a closure *cell* (not just referenced as a
    global) rides the wire by import name and rebinds on the far side."""
    import numpy as np_mod

    hold = np_mod  # closure cell holds the module object itself

    def make():
        return lambda: hold.arange(5).sum()

    fn = loads_fn(dumps_fn(make()))
    assert fn() == 10


class _Plain:
    """Module-level on purpose: instances pickle by class reference."""

    def __init__(self, k):
        self.k = k

    def mul(self, x):
        return self.k * x


def test_partial_over_bound_method_of_picklable_instance_round_trips():
    fn = loads_fn(dumps_fn(functools.partial(_Plain(3).mul, 7)))
    assert fn() == 21


def test_partial_over_bound_method_of_stateful_instance_raises():
    class Holder:
        def __init__(self):
            self.lock = threading.Lock()

        def body(self, x):  # pragma: no cover - never ships
            return x

    with pytest.raises(UnpicklableTaskError, match="not a plain function"):
        dumps_fn(functools.partial(Holder().body, 1))


# property test: the wire round-trips arbitrary nested arg packs — runs
# under real hypothesis when installed, the deterministic shim otherwise
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from repro_torch.testing import given, settings, st


@st.composite
def _arg_packs(draw):
    scalars = st.sampled_from([0, -1, 3.5, "tag", None, True])
    small = st.lists(scalars, min_size=0, max_size=4)
    n = draw(st.integers(min_value=1, max_value=2048))
    dtype = draw(st.sampled_from(["float64", "int32"]))
    arr = np.arange(n, dtype=dtype)
    shape = draw(st.sampled_from(["flat", "tuple", "dict"]))
    if shape == "flat":
        return (arr, draw(small))
    if shape == "tuple":
        return ((draw(scalars), arr), [arr, draw(scalars)])
    return ({"a": arr, "b": draw(small)}, draw(scalars))


@settings(max_examples=25, deadline=None)
@given(pack=_arg_packs())
def test_args_round_trip_property(pack):
    """dumps_args/loads_args is lossless for nested scalars + arrays, both
    below and above the arena threshold (arrays >= 1 KiB cross the shm
    plane; equality must hold either way)."""
    arena = ShmArena(threshold=1024)
    try:
        out = loads_args(dumps_args(pack, arena), arena)
        _assert_tree_equal(out, pack)
        for ref in shm_refs(dumps_args(pack, arena)):
            arena.recycle(ref)
    finally:
        arena.close()


def _assert_tree_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b
