"""Graph linter: rule-based static analysis over a :class:`TaskGraph`.

DESIGN.md §15. The scheduler executes whatever graph it is handed; after
conditions (§10), subflows, retries (§14) and cross-process placement
(§11) a misbuilt graph fails at *runtime* — or silently misbehaves. The
linter moves those failures to build time: each rule walks the
:meth:`TaskGraph.edges` introspection surface (never reimplementing
edge-strength semantics) and yields structured :class:`Finding` records.

Rule catalog (``rule_catalog()`` renders it):

========================  ========  =====================================
rule                      severity  fires when
========================  ========  =====================================
strong-cycle              error     a cycle of strong edges (deadlock —
                                    the §8 countdown can never drain)
unreachable-task          error     no path from any source task; or the
                                    task waits on predecessors outside
                                    the graph container
orphan-task               warning   ``fn=None`` placeholder with no edges
condition-branch-range    warning/  a condition provably returns an index
                          error     outside its declared successors (the
                                    loop-exit idiom is exempt inside a
                                    cycle); *error* when **no** return
                                    can ever select a branch
weak-loop-no-exit         error     every condition in a weak-edge loop
                                    provably re-enters the loop — no
                                    terminating branch is reachable
priority-inversion        warning   a strong edge where the successor's
                                    band outranks its predecessor's (the
                                    high-priority task queues behind
                                    low-priority work)
retry-non-idempotent      warning   retry policy on a non-idempotent body
                                    that can offload to a worker process
                                    (§14's at-most-once gate silently
                                    disables started-body retries)
remote-unpicklable        error     ``affinity="remote"`` body that fails
                                    the §11 wire probe
                                    (:func:`repro_torch.dist.picklability_error`)
affinity-ignored          warning   ``affinity="remote"`` on a body that
                                    is parent-pinned by §10/§11 rules
                                    (condition / spawner / ``fn=None``)
timeout-control-flow      warning   ``timeout=`` on a parent-pinned
                                    control-flow task (the §14 watchdog
                                    cannot preempt the scheduler)
shared-state-race         error     (from :mod:`~repro_torch.analysis.races`)
                                    two bodies write the same closure
                                    cell / global / object attribute with
                                    no happens-before path between them
========================  ========  =====================================

Analyses are conservative: a dynamically-computed condition return or an
opaque write target yields *no* finding rather than a guess, so a clean
report is meaningful and the shipped consumers (serve tick graph,
prefetch lanes, checkpoint subflows) lint clean by construction.

CLI: ``python -m repro_torch.analysis.lint [--strict] script.py [args...]``
runs the script and lints every graph it builds (exit 1 on errors; with
``--strict`` on any finding).
"""
from __future__ import annotations

import dis
import types
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

from ..core.graph import TaskGraph
from ..core.task import Task

__all__ = ["Finding", "LintContext", "lint_graph", "rule_catalog", "RULES", "main"]

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One structured lint verdict.

    ``rule`` names the catalog entry, ``severity`` is ``"error"`` (the
    graph will fail or misbehave at runtime) or ``"warning"`` (legal but
    almost certainly not what the author meant), ``tasks`` names the
    offending tasks in path/discovery order, and ``graph`` labels the
    container so multi-graph reports stay attributable.
    """

    rule: str
    severity: str
    message: str
    tasks: tuple[str, ...] = ()
    graph: str = ""

    def __str__(self) -> str:
        where = f" [{', '.join(self.tasks)}]" if self.tasks else ""
        return f"{self.severity}[{self.rule}] graph {self.graph!r}: {self.message}{where}"


@dataclass(frozen=True)
class Rule:
    name: str
    severity: str
    doc: str
    fn: Callable[["LintContext"], Iterable[tuple]] = field(compare=False)


#: Registry of every lint rule, in registration (catalog) order.
RULES: dict[str, Rule] = {}


def _rule(name: str, severity: str) -> Callable:
    def deco(fn: Callable[["LintContext"], Iterable[tuple]]) -> Callable:
        RULES[name] = Rule(name, severity, (fn.__doc__ or "").strip(), fn)
        return fn

    return deco


def rule_catalog() -> str:
    """Human-readable rule listing (name, default severity, summary)."""
    lines = []
    for r in RULES.values():
        summary = r.doc.splitlines()[0] if r.doc else ""
        lines.append(f"{r.name:<24} {r.severity:<8} {summary}")
    return "\n".join(lines)


# -- bytecode helpers (shared with races.py) -----------------------------------


def unwrap_callable(fn: Any) -> tuple[Optional[types.FunctionType], Any]:
    """Peel a task body down to ``(plain function, bound self or None)``.

    Handles bound methods and ``functools.partial`` chains; anything else
    (C callables, callables with ``__call__``) returns ``(None, None)`` —
    bytecode analyses then decline to judge rather than guess.
    """
    import functools

    self_obj = None
    while isinstance(fn, functools.partial):
        fn = fn.func
    if isinstance(fn, types.MethodType):
        self_obj = fn.__self__
        fn = fn.__func__
    while isinstance(fn, functools.partial):
        fn = fn.func
    if isinstance(fn, types.FunctionType):
        return fn, self_obj
    return None, None


def const_returns(fn: Any) -> tuple[Optional[set], bool]:
    """``(constant return values, every return is constant)`` for a body.

    A ``dis`` scan collecting ``LOAD_CONST; RETURN_VALUE`` pairs (and
    3.12's ``RETURN_CONST``). ``(None, False)`` means the body could not
    be analyzed at all; a non-constant return path clears the second
    element so callers can tell "provably always constant" from "some
    constants observed". Returns inside ``with``/``try`` cleanup blocks
    read as non-constant — the analysis stays conservative.
    """
    func, _self = unwrap_callable(fn)
    if func is None:
        return None, False
    consts: set = set()
    all_const = True
    prev: Optional[dis.Instruction] = None
    for ins in dis.get_instructions(func.__code__):
        if ins.opname == "RETURN_VALUE":
            if prev is not None and prev.opname == "LOAD_CONST":
                try:
                    consts.add(prev.argval)
                except TypeError:  # unhashable const: treat as dynamic
                    all_const = False
            else:
                all_const = False
        elif ins.opname == "RETURN_CONST":  # pragma: no cover - 3.12+
            try:
                consts.add(ins.argval)
            except TypeError:
                all_const = False
        prev = ins
    return consts, all_const


def selects_branch(value: Any, num_successors: int) -> bool:
    """True iff :func:`repro_torch.core.graph.select_branch` would release a
    successor for a condition returning ``value``."""
    if isinstance(value, bool):
        value = int(value)
    return isinstance(value, int) and 0 <= value < num_successors


# -- the analysis context ------------------------------------------------------


class LintContext:
    """Shared, lazily-computed graph facts handed to every rule.

    Wraps one :class:`TaskGraph` plus the optional backend the graph is
    about to run on (``"serial"``/``"thread"``/``"process"`` — placement
    rules sharpen when the backend is known). All derived structure
    (adjacency, SCCs, reachability) is computed once and memoized.
    """

    def __init__(self, graph: TaskGraph, *, backend: Optional[str] = None) -> None:
        self.graph = graph
        self.backend = backend
        self.tasks: list[Task] = list(graph.tasks)
        self.edges: list[tuple[Task, Task, bool]] = graph.edges()
        self._contained = {id(t) for t in self.tasks}
        self._succ_all: Optional[dict[int, list[Task]]] = None
        self._strong_cycle: Optional[list[Task]] = None
        self._strong_cycle_done = False
        self._sccs: Optional[list[list[Task]]] = None
        self._scc_of: dict[int, int] = {}
        self._cyclic_sccs: Optional[set[int]] = None

    def name(self, t: Task) -> str:
        return t.name or f"<task@{id(t):x}>"

    def contains(self, t: Task) -> bool:
        return id(t) in self._contained

    @property
    def succ_all(self) -> dict[int, list[Task]]:
        """In-container adjacency over *all* edges (strong and weak)."""
        if self._succ_all is None:
            adj: dict[int, list[Task]] = {id(t): [] for t in self.tasks}
            for u, v, _strong in self.edges:
                if id(v) in self._contained:
                    adj[id(u)].append(v)
            self._succ_all = adj
        return self._succ_all

    def internal_strong_indegree(self) -> dict[int, int]:
        indeg = {id(t): 0 for t in self.tasks}
        for _u, v, strong in self.edges:
            if strong and id(v) in indeg:
                indeg[id(v)] += 1
        return indeg

    def reachable_from_sources(self) -> set[int]:
        seen: set[int] = set()
        stack = [t for t in self.tasks if t.is_source]
        seen.update(id(t) for t in stack)
        while stack:
            for s in self.succ_all[id(stack.pop())]:
                if id(s) not in seen:
                    seen.add(id(s))
                    stack.append(s)
        return seen

    @property
    def strong_cycle(self) -> Optional[list[Task]]:
        """One witness strong cycle (path, first task repeated), or None."""
        if not self._strong_cycle_done:
            self._strong_cycle = self.graph.find_strong_cycle()
            self._strong_cycle_done = True
        return self._strong_cycle

    def strong_cycle_members(self) -> set[int]:
        """Ids of tasks whose strong in-degree never drains under Kahn —
        cycle members *and* everything strongly downstream of them."""
        from collections import deque

        indeg = {id(t): t.num_predecessors for t in self.tasks}
        q = deque(t for t in self.tasks if t.num_predecessors == 0)
        remaining = dict(indeg)
        while q:
            t = q.popleft()
            remaining.pop(id(t), None)
            if t.is_condition:
                continue
            for s in t.successors:
                if id(s) in indeg:
                    indeg[id(s)] -= 1
                    if indeg[id(s)] == 0:
                        q.append(s)
        return set(remaining)

    @property
    def sccs(self) -> list[list[Task]]:
        """Strongly-connected components over all edges (iterative Tarjan)."""
        if self._sccs is None:
            adj = self.succ_all
            index: dict[int, int] = {}
            low: dict[int, int] = {}
            on_stack: set[int] = set()
            stack: list[Task] = []
            sccs: list[list[Task]] = []
            counter = [0]

            for root in self.tasks:
                if id(root) in index:
                    continue
                work: list[tuple[Task, int]] = [(root, 0)]
                while work:
                    node, pi = work[-1]
                    nid = id(node)
                    if pi == 0:
                        index[nid] = low[nid] = counter[0]
                        counter[0] += 1
                        stack.append(node)
                        on_stack.add(nid)
                    advanced = False
                    succs = adj[nid]
                    while pi < len(succs):
                        s = succs[pi]
                        pi += 1
                        work[-1] = (node, pi)
                        if id(s) not in index:
                            work.append((s, 0))
                            advanced = True
                            break
                        if id(s) in on_stack:
                            low[nid] = min(low[nid], index[id(s)])
                    if advanced:
                        continue
                    work.pop()
                    if low[nid] == index[nid]:
                        comp: list[Task] = []
                        while True:
                            w = stack.pop()
                            on_stack.discard(id(w))
                            comp.append(w)
                            if w is node:
                                break
                        for t in comp:
                            self._scc_of[id(t)] = len(sccs)
                        sccs.append(comp)
                    if work:
                        parent, _ = work[-1]
                        low[id(parent)] = min(low[id(parent)], low[nid])
            self._sccs = sccs
        return self._sccs

    def scc_of(self, t: Task) -> int:
        _ = self.sccs
        return self._scc_of[id(t)]

    def cyclic_sccs(self) -> set[int]:
        """Indices of SCCs that contain a cycle (size > 1, or a self-loop)."""
        if self._cyclic_sccs is None:
            out: set[int] = set()
            for i, comp in enumerate(self.sccs):
                if len(comp) > 1:
                    out.add(i)
                else:
                    t = comp[0]
                    if any(s is t for s in self.succ_all[id(t)]):
                        out.add(i)
            self._cyclic_sccs = out
        return self._cyclic_sccs

    def in_cycle(self, t: Task) -> bool:
        return self.scc_of(t) in self.cyclic_sccs()


# -- rules ---------------------------------------------------------------------


@_rule("strong-cycle", ERROR)
def _r_strong_cycle(ctx: LintContext) -> Iterator[tuple]:
    """A cycle of strong edges: the countdown protocol deadlocks."""
    cyc = ctx.strong_cycle
    if cyc is not None:
        path = " -> ".join(ctx.name(t) for t in cyc)
        yield (
            "strong dependency cycle (deadlock — no task in it can ever become "
            f"ready): {path}",
            tuple(ctx.name(t) for t in cyc[:-1]),
        )


@_rule("unreachable-task", ERROR)
def _r_unreachable(ctx: LintContext) -> Iterator[tuple]:
    """No execution path from any source task reaches this task."""
    reach = ctx.reachable_from_sources()
    cycle_members = ctx.strong_cycle_members() if ctx.strong_cycle else set()
    internal = ctx.internal_strong_indegree()
    for t in ctx.tasks:
        if id(t) in reach or id(t) in cycle_members:
            continue  # cycle members are the strong-cycle rule's report
        if t.num_predecessors > internal[id(t)]:
            yield (
                f"task {ctx.name(t)!r} waits on {t.num_predecessors - internal[id(t)]} "
                "strong predecessor(s) outside this graph — it can never start from "
                "this graph's submission",
                (ctx.name(t),),
            )
        else:
            yield (
                f"task {ctx.name(t)!r} is unreachable from every source task",
                (ctx.name(t),),
            )


@_rule("orphan-task", WARNING)
def _r_orphan(ctx: LintContext) -> Iterator[tuple]:
    """A ``fn=None`` placeholder with no edges: runs, computes nothing."""
    if len(ctx.tasks) <= 1:
        return
    for t in ctx.tasks:
        if t.fn is None and not t.takes_runtime and t.is_source and not t.successors:
            yield (
                f"task {ctx.name(t)!r} has no body and no edges — a placeholder "
                "that was never wired in",
                (ctx.name(t),),
            )


@_rule("condition-branch-range", WARNING)
def _r_branch_range(ctx: LintContext) -> Iterator[tuple]:
    """A condition's constant return indexes outside its declared branches."""
    for t in ctx.tasks:
        if not t.is_condition:
            continue
        n = len(t.successors)
        if n == 0:
            yield (
                f"condition {ctx.name(t)!r} declares no successors — its result "
                "can never select a branch",
                (ctx.name(t),),
            )
            continue
        consts, all_const = const_returns(t.fn)
        if consts is None or not consts:
            continue  # dynamic body: decline to judge
        misses = sorted((c for c in consts if not selects_branch(c, n)), key=repr)
        if all_const and len(misses) == len(consts):
            yield (
                f"condition {ctx.name(t)!r} can only return {misses!r} — no return "
                f"value ever selects one of its {n} declared branch(es)",
                (ctx.name(t),),
                ERROR,
            )
            continue
        if misses and not ctx.in_cycle(t):
            yield (
                f"condition {ctx.name(t)!r} returns {misses!r}, outside declared "
                f"branches 0..{n - 1}; outside a cycle that selects nothing (the "
                "loop-exit idiom only makes sense inside a weak-edge loop)",
                (ctx.name(t),),
            )


@_rule("weak-loop-no-exit", ERROR)
def _r_weak_loop(ctx: LintContext) -> Iterator[tuple]:
    """A weak-edge loop in which no terminating branch is reachable."""
    strong_members = ctx.strong_cycle_members() if ctx.strong_cycle else set()
    for i in ctx.cyclic_sccs():
        comp = ctx.sccs[i]
        if any(id(t) in strong_members for t in comp):
            continue  # the strong-cycle rule owns this report
        conditions = [t for t in comp if t.is_condition]
        if not conditions:
            continue
        exit_possible = False
        for c in conditions:
            consts, all_const = const_returns(c.fn)
            if consts is None or not all_const or not consts:
                exit_possible = True  # dynamic return: cannot prove no exit
                break
            for r in consts:
                if not selects_branch(r, len(c.successors)):
                    exit_possible = True  # selects nothing: the loop drains
                    break
                target = c.successors[int(r)]
                if not ctx.contains(target) or ctx.scc_of(target) != i:
                    exit_possible = True  # branch leaves the loop
                    break
            if exit_possible:
                break
        if not exit_possible:
            names = tuple(ctx.name(t) for t in comp)
            yield (
                "weak-edge loop has no reachable terminating branch — every "
                f"condition in it provably re-enters the loop: {', '.join(names)}",
                names,
            )


@_rule("priority-inversion", WARNING)
def _r_priority_inversion(ctx: LintContext) -> Iterator[tuple]:
    """A strong edge whose successor outranks its predecessor's band."""
    for u, v, strong in ctx.edges:
        if not strong or not ctx.contains(v):
            continue
        if v.priority > u.priority:
            yield (
                f"strong edge {ctx.name(u)!r} (priority {u.priority:g}) -> "
                f"{ctx.name(v)!r} (priority {v.priority:g}): the high-priority "
                "successor queues behind lower-priority work it depends on",
                (ctx.name(u), ctx.name(v)),
            )


@_rule("retry-non-idempotent", WARNING)
def _r_retry_non_idempotent(ctx: LintContext) -> Iterator[tuple]:
    """Retry policy on a non-idempotent body that can offload to a worker."""
    for t in ctx.tasks:
        if t.retry_policy is None or t.idempotent:
            continue
        if t.is_condition or t.takes_runtime or t.fn is None:
            continue
        offloadable = t.affinity == "remote" or (
            ctx.backend == "process" and t.affinity == "any"
        )
        if offloadable:
            yield (
                f"task {ctx.name(t)!r} carries a retry policy but is not marked "
                "idempotent: on the process backend, §14's at-most-once gate "
                "refuses to re-run a started body, so worker loss mid-body is "
                "never retried — mark idempotent=True or pin affinity='local'",
                (ctx.name(t),),
            )


@_rule("remote-unpicklable", ERROR)
def _r_remote_unpicklable(ctx: LintContext) -> Iterator[tuple]:
    """An ``affinity="remote"`` body that cannot cross the §11 wire."""
    probe = None
    for t in ctx.tasks:
        if t.affinity != "remote" or t.fn is None or t.is_condition or t.takes_runtime:
            continue
        if probe is None:
            from ..dist.wire import picklability_error as probe  # lazy: §11 opt-in
        err = probe(t.fn)
        if err is not None:
            yield (
                f"task {ctx.name(t)!r} demands affinity='remote' but its body "
                f"cannot be wired to a worker process: {err}",
                (ctx.name(t),),
            )


@_rule("affinity-ignored", WARNING)
def _r_affinity_ignored(ctx: LintContext) -> Iterator[tuple]:
    """``affinity="remote"`` on a body §10/§11 pin to the parent."""
    for t in ctx.tasks:
        if t.affinity != "remote":
            continue
        if t.is_condition or t.takes_runtime or t.fn is None:
            kind = (
                "a condition task"
                if t.is_condition
                else "a subflow spawner" if t.takes_runtime else "a bodyless task"
            )
            yield (
                f"task {ctx.name(t)!r} is {kind}, which always runs in the parent "
                "process — affinity='remote' can never be honored",
                (ctx.name(t),),
            )


@_rule("timeout-control-flow", WARNING)
def _r_timeout_control_flow(ctx: LintContext) -> Iterator[tuple]:
    """``timeout=`` on a parent-pinned control-flow task."""
    for t in ctx.tasks:
        if t.timeout is None or not (t.is_condition or t.takes_runtime):
            continue
        kind = "condition" if t.is_condition else "subflow spawner"
        yield (
            f"{kind} task {ctx.name(t)!r} declares timeout={t.timeout:g}: control "
            "flow runs inline in the scheduler, so the §14 watchdog can flag the "
            "deadline but never preempt or retry the body",
            (ctx.name(t),),
        )


# -- command line --------------------------------------------------------------


def lint_graph(
    graph: TaskGraph,
    *,
    backend: Optional[str] = None,
    races: bool = True,
    rules: Optional[Iterable[str]] = None,
) -> list[Finding]:
    """Run the rule catalog (plus the §15 race detector) over ``graph``.

    ``backend`` sharpens placement rules when known; ``races=False``
    skips the bytecode write-race scan; ``rules`` restricts to a subset
    of catalog names (unknown names raise ``KeyError``). Findings come
    back in catalog order, races last.
    """
    ctx = LintContext(graph, backend=backend)
    selected = (
        list(RULES.values())
        if rules is None
        else [RULES[name] for name in rules if name != "shared-state-race"]
    )
    gname = graph.name or "<anonymous>"
    findings: list[Finding] = []
    for r in selected:
        for item in r.fn(ctx):
            message, tasks = item[0], item[1]
            severity = item[2] if len(item) > 2 else r.severity
            findings.append(Finding(r.name, severity, message, tuple(tasks), gname))
    if races and (rules is None or "shared-state-race" in set(rules)):
        from .races import detect_races  # sibling: no cycle at import time

        findings.extend(detect_races(graph, ctx=ctx))
    return findings


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(str(f) for f in findings)


# -- CLI -----------------------------------------------------------------------


def _lintable(graph: TaskGraph) -> bool:
    """Skip empty graphs and stale containers whose tasks were adopted
    elsewhere (``compose`` leaves the inner container behind)."""
    return len(graph.tasks) > 0 and all(t.graph is graph for t in graph.tasks)


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import runpy
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description=(
            "Run a script and lint every TaskGraph it builds. Exit 1 on "
            "error-severity findings (with --strict, on any finding)."
        ),
    )
    parser.add_argument("--strict", action="store_true", help="fail on warnings too")
    parser.add_argument("--no-races", action="store_true", help="skip the race scan")
    parser.add_argument(
        "--backend", default=None, help="assume this backend for placement rules"
    )
    parser.add_argument("--rules", action="store_true", help="print the rule catalog")
    parser.add_argument("script", nargs="?", help="script to execute and lint")
    parser.add_argument("args", nargs=argparse.REMAINDER, help="script arguments")
    opts = parser.parse_args(argv)

    if opts.rules:
        print(rule_catalog())
        return 0
    if opts.script is None:
        parser.error("a script to lint is required (or --rules)")

    registry: list[TaskGraph] = []
    orig_init = TaskGraph.__init__

    def tracking_init(self: TaskGraph, name: str = "") -> None:
        orig_init(self, name)
        if len(registry) < 1024:
            registry.append(self)

    TaskGraph.__init__ = tracking_init  # type: ignore[method-assign]
    saved_argv = sys.argv
    script_rc = 0
    try:
        sys.argv = [opts.script] + list(opts.args)
        runpy.run_path(opts.script, run_name="__main__")
    except SystemExit as exc:  # scripts exiting normally still get linted
        code = exc.code
        script_rc = code if isinstance(code, int) else (0 if code is None else 1)
    finally:
        TaskGraph.__init__ = orig_init  # type: ignore[method-assign]
        sys.argv = saved_argv
    if script_rc:
        print(
            f"repro_torch.analysis.lint: script exited with status {script_rc}; "
            "linting the graphs it built anyway",
            file=sys.stderr,
        )

    all_findings: list[Finding] = []
    seen_names: set[str] = set()
    linted = 0
    for g in registry:
        if not _lintable(g):
            continue
        # steady-state loops rebuild identical subflow graphs per pass;
        # lint each distinct (name, size) shape once
        key = f"{g.name}:{len(g.tasks)}"
        if key in seen_names:
            continue
        seen_names.add(key)
        linted += 1
        all_findings.extend(
            lint_graph(g, backend=opts.backend, races=not opts.no_races)
        )
    errors = [f for f in all_findings if f.severity == ERROR]
    if all_findings:
        print(format_findings(all_findings), file=sys.stderr)
    print(
        f"repro_torch.analysis.lint: {linted} graph(s) linted, "
        f"{len(errors)} error(s), {len(all_findings) - len(errors)} warning(s)",
        file=sys.stderr,
    )
    if errors or (opts.strict and all_findings):
        return 1
    return script_rc


if __name__ == "__main__":  # pragma: no cover - exercised via CLI in CI
    raise SystemExit(main())
