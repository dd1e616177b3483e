"""Job wire protocol for the process backend (DESIGN.md §11).

A remote job carries two payload kinds across the parent↔worker pipe:

* **function wire** (:func:`dumps_fn` / :func:`loads_fn`) — the task body.
  Plain picklable callables (module-level functions, ``functools.partial``
  of them) go through stdlib pickle. Lambdas and closures — the dominant
  body idiom in this codebase — fail stdlib pickle, so they fall back to a
  *code-object wire*: the function's code is ``marshal``-ed, and its
  defaults and closure cells are captured **by value** (recursively, so a
  lambda closing over another lambda ships too). The worker rebuilds the
  function against the globals of its defining module (``sys.modules``
  first — under the default ``fork`` start method the module object
  already exists in the child — then a regular import).

  The by-value capture is the contract's sharp edge: a remote body sees a
  *snapshot* of its closure taken at submission, and mutations it makes
  never travel back. Loop/condition state must therefore live in
  scheduler-side bodies (conditions always run in-parent) or flow along
  dataflow edges. DESIGN.md §11 spells the rule out.

* **value wire** (:func:`dumps_value` / :func:`loads_value`) — edge values
  (dataflow arguments and results). Most objects go through pickle;
  numpy/jax arrays at or above the arena threshold are carried through a
  :class:`~repro_torch.dist.shm_arena.ShmArena` block instead — the descriptor
  crosses the pipe, the bytes cross shared memory (zero-copy on the read
  side). Callables nested in values reuse the function wire.

:class:`UnpicklableTaskError` is the submit-time verdict for a body that
cannot be shipped: raised eagerly by ``ProcessPool`` for tasks with
``affinity="remote"`` so the caller learns at submit, not mid-run.

Closures round-trip with their captured state::

    >>> from repro_torch.dist.wire import dumps_fn, loads_fn
    >>> def make(k):
    ...     return lambda x: x * k
    >>> loads_fn(dumps_fn(make(6)))(7)
    42
"""
from __future__ import annotations

import importlib
import marshal
import pickle
import sys
import threading
import types
from typing import Any, Optional

__all__ = [
    "UnpicklableTaskError",
    "picklability_error",
    "dumps_fn",
    "loads_fn",
    "dumps_value",
    "loads_value",
    "dumps_exception",
    "loads_exception",
]

# wire tags (first element of every payload tuple)
_PICKLE = 0  # stdlib pickle bytes
_CODE = 1  # marshalled code object + captured defaults/cells/globals
_PARTIAL = 2  # functools.partial: (fn-wire, args-wire, kwargs-wire)
_SHM = 3  # shared-memory array descriptor (ArrayRef)
_TUPLE = 4  # tuple of value-wires (used for argument packs)
_MODULE = 5  # module captured in a cell/global, shipped by name
_DICT = 6  # dict of value-wires (batch dicts holding large arrays)
_LIST = 7  # list of value-wires

_CONTAINER_SCAN_MAX = 64  # don't deep-scan huge containers for arena arrays


def _referenced_globals(code: Any) -> set:
    """Global names a code object (or any code nested in it) can load —
    the subset of ``fn.__globals__`` worth shipping by value."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _referenced_globals(const)
    return names


_dump_guard = threading.local()  # breaks self-referential global cycles


class UnpicklableTaskError(TypeError):
    """A task body (or a value it captures) cannot be serialized for a
    worker process.

    Raised at submit time for ``affinity="remote"`` tasks; tasks with the
    default ``affinity="any"`` fall back to in-parent execution instead.
    """


def _dumps_cell(value: Any) -> Any:
    """Wire one captured value (default or closure cell): pickle first,
    modules by name, function wire for callables pickle rejects — and for
    ``__main__`` functions, which pickle only *by reference* and so would
    dangle in a worker forked before their definition."""
    if isinstance(value, types.ModuleType):
        return (_MODULE, value.__name__)
    if isinstance(value, types.FunctionType) and value.__module__ == "__main__":
        return dumps_fn(value)
    try:
        return (_PICKLE, pickle.dumps(value))
    except Exception:
        if callable(value):
            return dumps_fn(value)
        raise


def picklability_error(fn: Any) -> Optional[str]:
    """Non-raising probe: would :func:`dumps_fn` accept this body?

    Returns ``None`` when ``fn`` can cross the §11 process wire, or the
    :class:`UnpicklableTaskError` message naming the offending capture
    when it cannot. This is the static-analysis entry point
    (``repro_torch.analysis.lint``'s *remote-unpicklable* rule) — the same
    serializer the real offload path runs, invoked at lint time instead
    of at dispatch, so a ``affinity="remote"`` body that would die in
    flight is reported before the graph ever runs. The probe serializes
    (it does not ship), so it is side-effect free but pays the wire cost
    once per probed body.
    """
    try:
        dumps_fn(fn)
    except UnpicklableTaskError as exc:
        return str(exc)
    except Exception as exc:  # defensive: any serializer failure is a verdict
        return f"{type(exc).__name__}: {exc}"
    return None


def dumps_fn(fn: Any) -> tuple:
    """Serialize a callable for a worker process.

    Importable functions go by pickle reference; lambdas, closures and
    ``__main__``-level functions go by value through the code wire (a
    pickle *reference* to ``__main__`` dangles in any worker forked
    before the definition ran, and resolves to nothing under spawn).
    Raises :class:`UnpicklableTaskError` (with the offending object named)
    when neither pickle nor the code-object fallback can carry it.
    """
    if not (isinstance(fn, types.FunctionType) and fn.__module__ == "__main__"):
        try:
            return (_PICKLE, pickle.dumps(fn))
        except Exception:
            pass
    import functools

    if isinstance(fn, functools.partial):
        try:
            return (
                _PARTIAL,
                dumps_fn(fn.func),
                tuple(_dumps_cell(a) for a in fn.args),
                tuple((k, _dumps_cell(v)) for k, v in fn.keywords.items()),
            )
        except UnpicklableTaskError:
            raise
        except Exception as exc:
            raise UnpicklableTaskError(
                f"cannot serialize partial arguments of {fn!r} for a worker "
                f"process: {exc}"
            ) from exc
    if not isinstance(fn, types.FunctionType):
        # bound methods of stateful objects, callables holding locks/pools…
        raise UnpicklableTaskError(
            f"cannot serialize task body {fn!r} for a worker process — it is "
            "not a plain function and does not pickle. Run it with "
            'affinity="local", or restructure it as a module-level function.'
        )
    seen = getattr(_dump_guard, "seen", None)
    if seen is None:
        seen = _dump_guard.seen = set()
    if id(fn) in seen:
        # a closure cell containing the function itself (recursive inner
        # def): by-value capture cannot tie that knot — fail fast and
        # clearly instead of burning the stack
        raise UnpicklableTaskError(
            f"{fn.__qualname__!r} is a self-referential closure (recursive "
            "inner function); define it at module level or run the task "
            'with affinity="local".'
        )
    seen.add(id(fn))
    try:
        try:
            code = marshal.dumps(fn.__code__)
            defaults = (
                tuple(_dumps_cell(d) for d in fn.__defaults__)
                if fn.__defaults__
                else None
            )
            cells = (
                tuple(_dumps_cell(c.cell_contents) for c in fn.__closure__)
                if fn.__closure__
                else None
            )
        except UnpicklableTaskError:
            raise
        except Exception as exc:
            raise UnpicklableTaskError(
                f"cannot serialize task body {fn.__qualname__!r} for a worker "
                f"process — a captured value does not pickle: {exc}. Run it "
                'with affinity="local", or pass the value along a dataflow '
                "edge."
            ) from exc
        # Ship the globals the body actually reads, by value, so they
        # resolve to their *submission-time* state in the worker (the module
        # dict a forked worker inherited is a snapshot from pool start-up).
        # Names that refuse to pickle — including the function itself, via
        # the seen-set (a recursive module-level lambda) — are left to the
        # worker's module dict: best effort.
        shipped: list = []
        fg = fn.__globals__
        for gname in _referenced_globals(fn.__code__):
            if gname in fg and id(fg[gname]) not in seen:
                try:
                    shipped.append((gname, _dumps_cell(fg[gname])))
                except Exception:
                    pass  # fall back to the worker's module dict for this name
    finally:
        seen.discard(id(fn))
    return (_CODE, code, fn.__module__, fn.__name__, defaults, cells, tuple(shipped))


def _module_globals(module: str) -> dict:
    """Globals of the body's defining module, in the worker.

    Under ``fork`` the module object (including ``__main__`` and pytest
    test modules) is already in ``sys.modules``; under ``spawn`` it must
    be importable by name.
    """
    mod = sys.modules.get(module)
    if mod is None:
        try:
            mod = importlib.import_module(module)
        except Exception:
            return {"__builtins__": __builtins__, "__name__": module}
    return mod.__dict__


def _loads_cell(wire: Any, arena: Any = None) -> Any:
    tag = wire[0]
    if tag == _PICKLE:
        return pickle.loads(wire[1])
    if tag == _MODULE:
        return importlib.import_module(wire[1])
    return loads_fn(wire, arena)


def loads_fn(wire: tuple, arena: Any = None) -> Any:
    """Rebuild a callable from :func:`dumps_fn` output."""
    tag = wire[0]
    if tag == _PICKLE:
        return pickle.loads(wire[1])
    if tag == _PARTIAL:
        import functools

        _t, fn_w, args_w, kwargs_w = wire
        return functools.partial(
            loads_fn(fn_w, arena),
            *[_loads_cell(a, arena) for a in args_w],
            **{k: _loads_cell(v, arena) for k, v in kwargs_w},
        )
    _t, code, module, name, defaults, cells, shipped = wire
    # fresh globals per function: the worker's module dict as fallback,
    # shipped submission-time bindings overlaid (and body-side global
    # writes isolated — remote bodies are snapshots, DESIGN.md §11)
    g = dict(_module_globals(module))
    g.setdefault("__builtins__", __builtins__)
    for gname, cell in shipped:
        g[gname] = _loads_cell(cell, arena)
    fn = types.FunctionType(
        marshal.loads(code),
        g,
        name,
        tuple(_loads_cell(d) for d in defaults) if defaults is not None else None,
        tuple(types.CellType(_loads_cell(c)) for c in cells)
        if cells is not None
        else None,
    )
    return fn


# -- edge values ------------------------------------------------------------


def _as_shippable_array(value: Any) -> Optional[Any]:
    """Return a numpy view/copy when ``value`` is a numpy or jax array,
    else None. jax arrays are pulled to host — a device buffer cannot
    cross an address-space boundary, its bytes can."""
    import numpy as np

    if isinstance(value, np.ndarray):
        return value
    if type(value).__module__.split(".")[0] in ("jax", "jaxlib"):
        try:
            return np.asarray(value)
        except Exception:
            return None
    return None


def dumps_value(value: Any, arena: Any = None, _depth: int = 2) -> tuple:
    """Wire one edge value. Arrays at/above the arena threshold travel as
    shared-memory descriptors — including arrays nested one or two levels
    inside small dicts/lists/tuples (the batch-dict idiom), which are
    decomposed element-wise; everything else as pickle (callables via the
    function wire)."""
    if arena is not None:
        arr = _as_shippable_array(value)
        if arr is not None and arr.nbytes >= arena.threshold:
            return (_SHM, arena.put(arr))
        if _depth > 0 and _contains_arena_array(value, arena, _depth):
            if isinstance(value, dict):
                keys = list(value.keys())
                wires = _dumps_many(value.values(), arena, _depth - 1)
                return (_DICT, tuple(zip(keys, wires)))
            if isinstance(value, (list, tuple)):
                tag = _LIST if isinstance(value, list) else _TUPLE
                return (tag, tuple(_dumps_many(value, arena, _depth - 1)))
    try:
        return (_PICKLE, pickle.dumps(value))
    except Exception:
        if callable(value):
            return dumps_fn(value)
        raise


def _dumps_many(values: Any, arena: Any, depth: int) -> list:
    """Wire a sequence of values; on failure, recycle the arena blocks of
    the elements already wired — a half-built pack must not strand pooled
    segments outside the freelist (they would leak until pool close)."""
    out: list = []
    try:
        for v in values:
            out.append(dumps_value(v, arena, depth))
    except Exception:
        if arena is not None:
            for w in out:
                for ref in shm_refs(w):
                    arena.recycle(ref)
        raise
    return out


def _contains_arena_array(value: Any, arena: Any, depth: int) -> bool:
    """Shallow scan: does this small container hold an arena-sized array?

    Bounded by ``depth`` (how far ``dumps_value`` would decompose), so a
    self-referential container falls through to pickle — which handles
    cycles — instead of recursing here."""
    if depth <= 0:
        return False
    if isinstance(value, dict):
        items: Any = value.values()
    elif isinstance(value, (list, tuple)):
        items = value
    else:
        return False
    if len(value) > _CONTAINER_SCAN_MAX:
        return False
    for v in items:
        arr = _as_shippable_array(v)
        if arr is not None and arr.nbytes >= arena.threshold:
            return True
        if _contains_arena_array(v, arena, depth - 1):
            return True
    return False


def loads_value(wire: tuple, arena: Any = None) -> Any:
    tag = wire[0]
    if tag == _PICKLE:
        return pickle.loads(wire[1])
    if tag == _SHM:
        return arena.get(wire[1])
    if tag == _TUPLE:
        return tuple(loads_value(w, arena) for w in wire[1])
    if tag == _LIST:
        return [loads_value(w, arena) for w in wire[1]]
    if tag == _DICT:
        return {k: loads_value(w, arena) for k, w in wire[1]}
    return loads_fn(wire, arena)


def dumps_args(args: tuple, arena: Any = None) -> tuple:
    """Wire an argument pack (the task's dataflow inputs, in edge order).

    Cleanup contract: if any argument fails to serialize, arena blocks
    already allocated for earlier arguments are recycled before the
    exception propagates — the caller never sees a partial pack.
    """
    return (_TUPLE, tuple(_dumps_many(args, arena, 2)))


def loads_args(wire: tuple, arena: Any = None) -> tuple:
    return loads_value(wire, arena)


def shm_refs(wire: tuple) -> list:
    """The :class:`~repro_torch.dist.shm_arena.ArrayRef` descriptors anywhere in
    a value/argument wire (containers included) — what the dispatcher must
    recycle once the job replies."""
    tag = wire[0]
    if tag == _SHM:
        return [wire[1]]
    if tag in (_TUPLE, _LIST):
        return [r for w in wire[1] for r in shm_refs(w)]
    if tag == _DICT:
        return [r for _k, w in wire[1] for r in shm_refs(w)]
    return []


# -- exceptions -------------------------------------------------------------


def dumps_exception(exc: BaseException) -> bytes:
    """Pickle a worker-side exception; unpicklable ones degrade to a
    ``RuntimeError`` carrying the repr (the traceback text survives in the
    message, the object graph does not)."""
    try:
        return pickle.dumps(exc)
    except Exception:
        import traceback

        return pickle.dumps(
            RuntimeError(
                "worker-side exception (unpicklable): "
                + "".join(traceback.format_exception_only(type(exc), exc)).strip()
            )
        )


def loads_exception(data: bytes) -> BaseException:
    return pickle.loads(data)
