"""repro_torch.analysis — static & dynamic analysis over the runtime (DESIGN.md §15).

The port carries the graph-verification half (the model-analysis half,
``hlo`` and ``roofline``, is XLA and TPU code and has no copy here):

* **graph verification** (:mod:`~repro_torch.analysis.lint`,
  :mod:`~repro_torch.analysis.races`, :mod:`~repro_torch.analysis.fuzz`,
  :mod:`~repro_torch.analysis.verify`) — the §15 pre-execution verifier for
  task graphs: a rule-based linter over :meth:`TaskGraph.edges`
  introspection, a bytecode-level closure/global/attribute write-race
  detector cross-checked at runtime by :class:`RaceObserver` vector
  clocks, and a seeded schedule fuzzer asserting result identity across
  interleavings. ``Executor(verify="warn"|"strict")`` runs the whole
  stack pre-submission; ``python -m repro_torch.analysis.lint script.py`` lints
  every graph a script builds.

The verifier modules depend only on :mod:`repro_torch.core` and the stdlib
(``dis``, ``hashlib``), so ``repro_torch.analysis`` itself imports neither
torch nor the process backend. Submodule attributes resolve lazily (PEP 562) —
that keeps the package import instant *and* lets
``python -m repro_torch.analysis.lint`` run the CLI module without a stale
copy already sitting in ``sys.modules``.
"""
from typing import Any

_EXPORTS = {
    "Finding": "lint",
    "LintContext": "lint",
    "lint_graph": "lint",
    "rule_catalog": "lint",
    "detect_races": "races",
    "task_writes": "races",
    "RaceObserver": "races",
    "fuzz_schedules": "fuzz",
    "FuzzReport": "fuzz",
    "verify_graph": "verify",
    "Report": "verify",
    "GraphVerificationError": "verify",
}

__all__ = [
    "Finding",
    "LintContext",
    "lint_graph",
    "rule_catalog",
    "detect_races",
    "task_writes",
    "RaceObserver",
    "fuzz_schedules",
    "FuzzReport",
    "verify_graph",
    "Report",
    "GraphVerificationError",
]


def __getattr__(name: str) -> Any:
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
