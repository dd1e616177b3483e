"""Verification facade: one call running the whole §15 static stack.

:func:`verify_graph` wraps the linter (:mod:`~repro_torch.analysis.lint`) and
the race detector (:mod:`~repro_torch.analysis.races`) into a single
:class:`Report`; ``Executor(verify="warn"|"strict")`` calls it once per
graph structure before submission (re-verifying only when the graph's
§12 epoch fingerprint changes), and ``verify="strict"`` turns
error-severity findings into :class:`GraphVerificationError` *before*
any task runs. The dynamic checkers —
:class:`~repro_torch.analysis.races.RaceObserver` and
:func:`~repro_torch.analysis.fuzz.fuzz_schedules` — stay
explicit opt-ins: they execute the graph, which a pre-submission hook
must never do.
"""
from __future__ import annotations

from typing import Iterable, Optional

from ..core.graph import TaskGraph

from .lint import ERROR, Finding, format_findings, lint_graph

__all__ = ["Report", "GraphVerificationError", "verify_graph"]


class Report:
    """Findings of one :func:`verify_graph` pass over one graph."""

    def __init__(self, graph_name: str, findings: Iterable[Finding]) -> None:
        self.graph_name = graph_name
        self.findings = list(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity != ERROR]

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_if_errors(self) -> None:
        if self.errors:
            raise GraphVerificationError(self)

    def __str__(self) -> str:
        if self.ok:
            return f"graph {self.graph_name!r}: verified clean"
        head = (
            f"graph {self.graph_name!r}: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        )
        return head + "\n" + format_findings(self.findings)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Report({self.graph_name!r}, findings={len(self.findings)})"


class GraphVerificationError(RuntimeError):
    """Raised by ``Executor(verify="strict")`` for error-severity findings."""

    def __init__(self, report: Report) -> None:
        super().__init__(str(report))
        self.report = report


def verify_graph(
    graph: TaskGraph,
    *,
    backend: Optional[str] = None,
    races: bool = True,
    rules: Optional[Iterable[str]] = None,
) -> Report:
    """Run the full static stack over ``graph`` and return a :class:`Report`.

    ``backend`` sharpens the placement rules (it is what
    ``Executor(verify=...)`` passes); ``races``/``rules`` forward to
    :func:`~repro_torch.analysis.lint.lint_graph`.
    """
    findings = lint_graph(graph, backend=backend, races=races, rules=rules)
    return Report(graph.name or "<anonymous>", findings)
