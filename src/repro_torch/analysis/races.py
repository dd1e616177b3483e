"""Closure-capture race detector + dynamic happens-before checker.

DESIGN.md §15. The §8 dataflow story is "pass values along edges, don't
share state" — but Python makes sharing effortless: two task bodies that
close over the same variable, write the same global, or poke the same
object's attribute race silently on the thread backend and diverge
silently on the process backend (workers mutate a copy).

**Static half** (:func:`task_writes` / :func:`detect_races`): a ``dis``
scan of each task body (bound methods and partials unwrapped, nested
``def``/lambda/comprehension code objects followed) collecting

* ``STORE_DEREF`` on a *free* variable — a write through a shared
  closure cell (keyed by cell identity, so two bodies capturing the same
  variable collide and two bodies capturing different cells don't);
* ``STORE_GLOBAL`` — keyed by ``(module, name)``;
* ``STORE_ATTR`` where the receiver is statically evident — ``self`` of
  a bound method, a captured cell, or a module global — keyed by
  ``(id(receiver), attribute)``.

Two distinct tasks writing the same key with **no happens-before path**
through the edge graph (reachability over strong *and* weak edges; tasks
in one loop SCC are serialized per pass and count as ordered) is a
``shared-state-race`` finding. Opaque receivers (locals, subscripts,
call results) are skipped — the report favors precision over recall.

**Dynamic half** (:class:`RaceObserver`): an observer assigning each
task a vector clock joined from its predecessors' finish clocks at
``on_start`` and incremented at ``on_finish``. After a real run,
:meth:`RaceObserver.check` cross-checks the static report: a statically
flagged pair whose clocks are incomparable was *actually* unordered this
run (and ``overlapped`` tells you whether wall-clock intervals on
distinct workers truly interleaved). The clocks derive from graph edges
only, so the observer is the runtime witness for exactly the ordering
the linter reasoned about.
"""
from __future__ import annotations

import threading
import time
import types
from typing import Any, Iterable, Optional

from ..core.graph import TaskGraph
from ..core.observer import PoolObserver
from ..core.task import Task

from .lint import ERROR, Finding, LintContext, unwrap_callable

__all__ = ["task_writes", "detect_races", "RaceObserver"]

_STORE_OPS = {"STORE_DEREF", "STORE_GLOBAL", "STORE_ATTR"}


def _receiver_load(instrs: list, j: int, attr: str) -> Optional[Any]:
    """The load instruction that pushed ``STORE_ATTR``'s receiver, or None.

    Plain assignment (``x.a = v``) puts the receiver load directly before
    the store. Augmented assignment (``x.a += v``) compiles to
    ``LOAD x; DUP_TOP; LOAD_ATTR a; ...; ROT_TWO; STORE_ATTR a`` — walk
    back to the duplicated load. Opaque receivers (subscripts, call
    results) return None.
    """
    if j == 0:
        return None
    prev = instrs[j - 1]
    if prev.opname in ("LOAD_FAST", "LOAD_DEREF", "LOAD_GLOBAL", "LOAD_NAME"):
        return prev
    if prev.opname in ("ROT_TWO", "SWAP"):  # SWAP replaces ROT_TWO in 3.11+
        for k in range(j - 2, 0, -1):
            ins = instrs[k]
            if ins.opname == "LOAD_ATTR" and ins.argval == attr:
                if instrs[k - 1].opname in ("DUP_TOP", "COPY"):
                    return instrs[k - 2] if k >= 2 else None
        return None
    return None


def _scan_code(
    code: types.CodeType,
    cells: dict[str, Any],
    self_names: frozenset[str],
    self_obj: Any,
    func: types.FunctionType,
    out: dict[tuple, str],
) -> None:
    """One code object's write scan; recurses into nested code consts.

    ``cells`` maps free-variable names visible in this scope to the
    actual cell objects of the *task body's* closure; names bound to
    cells created inside the body (its own cellvars) are local state and
    deliberately absent.
    """
    import dis

    instrs = list(dis.get_instructions(code))
    for j, ins in enumerate(instrs):
        op = ins.opname
        if op == "STORE_DEREF":
            cell = cells.get(ins.argval)
            if cell is not None:
                out[("cell", id(cell))] = f"captured variable '{ins.argval}'"
        elif op == "STORE_GLOBAL":
            out[("global", func.__module__, ins.argval)] = (
                f"global '{ins.argval}' of module '{func.__module__}'"
            )
        elif op == "STORE_ATTR":
            attr = ins.argval
            prev = _receiver_load(instrs, j, attr)
            if prev is None:
                continue
            pop = prev.opname
            if pop == "LOAD_FAST" and prev.argval in self_names:
                out[("attr", id(self_obj), attr)] = (
                    f"attribute '{type(self_obj).__name__}.{attr}'"
                )
            elif pop == "LOAD_DEREF" and prev.argval in cells:
                cell = cells[prev.argval]
                try:
                    obj = cell.cell_contents
                except ValueError:  # empty cell: key on the cell itself
                    obj = cell
                out[("attr", id(obj), attr)] = (
                    f"attribute '{prev.argval}.{attr}'"
                )
            elif pop in ("LOAD_GLOBAL", "LOAD_NAME"):
                obj = func.__globals__.get(prev.argval, _scan_code)
                if obj is not _scan_code:
                    out[("attr", id(obj), attr)] = (
                        f"attribute '{prev.argval}.{attr}'"
                    )
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            # names free in the nested scope that resolve to the body's own
            # closure stay shared; names closing over the body's locals are
            # new (unshared) cells and drop out of the map here
            nested_cells = {n: cells[n] for n in const.co_freevars if n in cells}
            _scan_code(const, nested_cells, frozenset(), None, func, out)


def task_writes(task: Task) -> dict[tuple, str]:
    """Statically-evident shared-state writes of one task body.

    Returns ``{key: human description}`` where ``key`` identifies the
    written location (cell identity / global name / receiver id +
    attribute — module docs). Bodies that cannot be disassembled (C
    callables, ``fn=None``) report no writes.
    """
    if task.fn is None:
        return {}
    func, self_obj = unwrap_callable(task.fn)
    if func is None:
        return {}
    code = func.__code__
    cells = dict(zip(code.co_freevars, func.__closure__ or ()))
    self_names = frozenset()
    if self_obj is not None and code.co_argcount >= 1:
        self_names = frozenset((code.co_varnames[0],))
    out: dict[tuple, str] = {}
    _scan_code(code, cells, self_names, self_obj, func, out)
    return out


def _reachable_ids(start: Task, adj: dict[int, list[Task]]) -> set[int]:
    seen: set[int] = set()
    stack = [start]
    while stack:
        t = stack.pop()
        for s in adj.get(id(t), ()):
            if id(s) not in seen:
                seen.add(id(s))
                stack.append(s)
    return seen


def detect_races(
    graph: TaskGraph, *, ctx: Optional[LintContext] = None
) -> list[Finding]:
    """``shared-state-race`` findings for ``graph`` (module docs).

    A finding names both tasks and the written location. Pairs ordered by
    a happens-before path (either direction, over strong *and* weak
    edges) are not races — including loop bodies serialized by their SCC.
    """
    ctx = ctx or LintContext(graph)
    writers: dict[tuple, list[tuple[Task, str]]] = {}
    for t in ctx.tasks:
        for key, descr in task_writes(t).items():
            writers.setdefault(key, []).append((t, descr))
    gname = graph.name or "<anonymous>"
    findings: list[Finding] = []
    reach_cache: dict[int, set[int]] = {}

    def reach(t: Task) -> set[int]:
        r = reach_cache.get(id(t))
        if r is None:
            r = reach_cache[id(t)] = _reachable_ids(t, ctx.succ_all)
        return r

    seen_pairs: set[tuple[int, int, tuple]] = set()
    for key, who in writers.items():
        if len(who) < 2:
            continue
        for i in range(len(who)):
            a, descr = who[i]
            for b, _descr_b in who[i + 1 :]:
                if a is b:
                    continue
                if id(b) in reach(a) or id(a) in reach(b):
                    continue  # ordered by the edge graph
                pair = (min(id(a), id(b)), max(id(a), id(b)), key)
                if pair in seen_pairs:
                    continue
                seen_pairs.add(pair)
                findings.append(
                    Finding(
                        "shared-state-race",
                        ERROR,
                        f"tasks {ctx.name(a)!r} and {ctx.name(b)!r} both write "
                        f"{descr} with no happens-before path between them",
                        (ctx.name(a), ctx.name(b)),
                        gname,
                    )
                )
    return findings


class RaceObserver(PoolObserver):
    """Vector-clock happens-before witness for one graph's runs.

    Attach alongside a run (``Executor(observers=[obs])`` or
    ``pool.add_observer``) and query afterwards::

        obs = RaceObserver(graph)
        with Executor(2, observers=[obs]) as ex:
            ex.run(graph).result(10)
        assert not obs.concurrent(a, b)          # graph-ordered
        confirmed = obs.check(detect_races(graph))

    Clocks derive **only from graph edges**: a task's start clock is the
    component-wise max of its in-container predecessors' finish clocks,
    and its finish clock increments its own component. Two tasks are
    :meth:`concurrent` when neither clock dominates — the same relation
    the static detector reasons about, observed on a real schedule.
    Tasks re-run by a loop keep their latest clocks (per-pass ordering is
    what the §10 loop semantics guarantee). Wall-clock intervals per
    worker are recorded too: :meth:`overlapped` reports whether two
    bodies *really* interleaved on distinct workers this run.
    """

    def __init__(self, graph: TaskGraph) -> None:
        self._index = {id(t): i for i, t in enumerate(graph.tasks)}
        self._n = len(graph.tasks)
        self._names = {id(t): (t.name or f"t{i}") for i, t in enumerate(graph.tasks)}
        preds: dict[int, list[int]] = {id(t): [] for t in graph.tasks}
        for u, v, _strong in graph.edges():
            if id(v) in preds and id(u) in self._index:
                preds[id(v)].append(id(u))
        self._preds = preds
        self._lock = threading.Lock()
        self._start: dict[int, list[int]] = {}
        self._finish: dict[int, list[int]] = {}
        self._spans: dict[int, tuple[float, float, int]] = {}
        self._t0: dict[int, float] = {}
        self._workers: dict[int, int] = {}

    # -- observer protocol -----------------------------------------------------

    def on_start(self, task: Task, worker: int) -> None:
        tid = id(task)
        if tid not in self._index:
            return  # subflow / foreign task: outside this graph's clock space
        now = time.perf_counter()
        with self._lock:
            clk = [0] * self._n
            for pid in self._preds[tid]:
                fin = self._finish.get(pid)
                if fin is not None:
                    for k in range(self._n):
                        if fin[k] > clk[k]:
                            clk[k] = fin[k]
            self._start[tid] = clk
            self._t0[tid] = now
            self._workers[tid] = worker

    def on_finish(self, task: Task, worker: int) -> None:
        tid = id(task)
        if tid not in self._index:
            return
        now = time.perf_counter()
        with self._lock:
            clk = list(self._start.get(tid) or [0] * self._n)
            clk[self._index[tid]] += 1
            self._finish[tid] = clk
            t0 = self._t0.get(tid, now)
            self._spans[tid] = (t0, now, worker)

    # -- queries ---------------------------------------------------------------

    def happens_before(self, a: Task, b: Task) -> bool:
        """``a``'s observed finish clock ≤ ``b``'s observed start clock."""
        with self._lock:
            fa = self._finish.get(id(a))
            sb = self._start.get(id(b))
        if fa is None or sb is None:
            return False
        return all(x <= y for x, y in zip(fa, sb))

    def concurrent(self, a: Task, b: Task) -> bool:
        """Neither task's clock dominates: unordered by graph edges."""
        return not self.happens_before(a, b) and not self.happens_before(b, a)

    def overlapped(self, a: Task, b: Task) -> bool:
        """Wall-clock intervals intersected on distinct workers this run."""
        with self._lock:
            sa = self._spans.get(id(a))
            sb = self._spans.get(id(b))
        if sa is None or sb is None:
            return False
        (a0, a1, wa), (b0, b1, wb) = sa, sb
        return wa != wb and a0 < b1 and b0 < a1

    def check(self, findings: Iterable[Finding]) -> list[dict[str, Any]]:
        """Cross-check static ``shared-state-race`` findings on this run.

        For each finding, reports ``status`` ``"confirmed-concurrent"``
        (clocks incomparable — the static verdict held at runtime),
        ``"ordered-this-run"`` (this schedule happened to serialize them:
        still a race, just not witnessed), or ``"not-observed"`` (a named
        task never ran). ``overlapped`` marks true wall-clock interleaving.
        """
        by_name = {name: tid for tid, name in self._names.items()}
        out: list[dict[str, Any]] = []
        for f in findings:
            if f.rule != "shared-state-race" or len(f.tasks) < 2:
                continue
            ta, tb = by_name.get(f.tasks[0]), by_name.get(f.tasks[1])
            entry: dict[str, Any] = {"finding": f, "overlapped": False}
            if ta is None or tb is None:
                entry["status"] = "not-observed"
            else:
                with self._lock:
                    fa, sb = self._finish.get(ta), self._start.get(tb)
                    fb, sa = self._finish.get(tb), self._start.get(ta)
                    span_a, span_b = self._spans.get(ta), self._spans.get(tb)
                if fa is None or fb is None or sa is None or sb is None:
                    entry["status"] = "not-observed"
                else:
                    ab = all(x <= y for x, y in zip(fa, sb))
                    ba = all(x <= y for x, y in zip(fb, sa))
                    entry["status"] = (
                        "ordered-this-run" if (ab or ba) else "confirmed-concurrent"
                    )
                    if span_a is not None and span_b is not None:
                        (a0, a1, wa), (b0, b1, wb) = span_a, span_b
                        entry["overlapped"] = wa != wb and a0 < b1 and b0 < a1
            out.append(entry)
        return out
