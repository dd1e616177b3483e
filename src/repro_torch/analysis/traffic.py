"""Per-rank collective traffic and op counts of the port's steps: the
counterpart of the reference's ``repro/analysis/hlo.py``.

The reference parses the SPMD-partitioned HLO of a compiled step. The port
runs eagerly and has no HLO; its collectives are explicit calls instead:
``parallel/ctx.py``'s autograd collectives (all-gather, reduce-scatter,
all-reduce, all-to-all, each backward the adjoint collective), the model
group's max-reduce, and ``parallel/pipeline.py``'s ring exchange and
all-reduce. While a :func:`record` block is open, each of them notes one
:class:`CollectiveEvent` on this process: its kind (the HLO names), the
bytes of this rank's result and the size of its group. With no block open
(``ACTIVE`` is None) a collective does one comparison more than it would
without this module, and takes no lock.

:func:`collective_traffic` applies the reference's ring model to the
events, with its formulas and keys:

  all-reduce          2 * size * (n-1)/n     (reduce-scatter + all-gather)
  all-gather          size * (n-1)/n         (size = gathered result)
  reduce-scatter      size_result * (n-1)    (operand = result * n)
  all-to-all          size * (n-1)/n
  collective-permute  size                   (point-to-point)

so the numbers are bytes over the links per rank per step.

:func:`op_histogram` counts the aten ops a block ran by family (``dot``:
the matrix products; ``convolution``), as a dispatch mode notes them into
the recorder's ``ops`` (``launch/dryrun.py``'s meter does), and the calls
of the port's kernel entry points (flash attention and the SSD scan,
forward and backward, on any device: the counterpart of
``custom-call``). There is no ``fusion``: the port's eager step fuses
nothing.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import Any, Iterable

# the Recorder of the open record() block, or None
ACTIVE = None

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# aten ops of the matrix-product family (einsum and linear reach these)
DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot", "vdot",
                     "matmul"})
CONV_OPS = frozenset({"convolution", "_convolution", "convolution_backward", "conv1d", "conv2d",
                      "conv3d"})


@dataclass(frozen=True)
class CollectiveEvent:
    kind: str  # one of KINDS
    bytes: int  # this rank's result
    group_size: int


class Recorder:
    """What one :func:`record` block saw."""

    def __init__(self) -> None:
        self.events: list = []
        self.kernels: Counter = Counter()  # kernel entry point -> calls
        self.ops: Counter = Counter()  # aten op name -> calls, where a dispatch mode notes them

    def collective(self, kind: str, result, group_size: int) -> None:
        self.events.append(CollectiveEvent(kind, result.numel() * result.element_size(),
                                           int(group_size)))

    def kernel(self, name: str) -> None:
        self.kernels[name] += 1


def note_kernel(name: str) -> None:
    """A call of the kernel entry point ``name``, noted where a block is open."""
    if ACTIVE is not None:
        ACTIVE.kernel(name)


@contextlib.contextmanager
def record():
    """Notes the collectives and kernel entry calls of this process inside
    the block into the :class:`Recorder` it yields. Blocks nest: an inner
    block's events are its own."""
    global ACTIVE
    prev, rec = ACTIVE, Recorder()
    ACTIVE = rec
    try:
        yield rec
    finally:
        ACTIVE = prev


def collective_traffic(events: Iterable[CollectiveEvent]) -> dict[str, Any]:
    """Per-rank link traffic (bytes) by collective kind, and op counts, by
    the reference's ring model (module docs)."""
    bytes_by_kind: dict[str, float] = {}
    count_by_kind: dict[str, int] = {}
    for ev in events:
        size, n = ev.bytes, max(ev.group_size, 1)
        if ev.kind == "all-reduce":
            moved = 2.0 * size * (n - 1) / n
        elif ev.kind == "all-gather":
            moved = size * (n - 1) / n
        elif ev.kind == "reduce-scatter":
            moved = size * (n - 1)
        elif ev.kind == "all-to-all":
            moved = size * (n - 1) / n
        elif ev.kind == "collective-permute":
            moved = float(size)
        else:
            raise ValueError(f"unknown collective {ev.kind!r}")
        bytes_by_kind[ev.kind] = bytes_by_kind.get(ev.kind, 0.0) + moved
        count_by_kind[ev.kind] = count_by_kind.get(ev.kind, 0) + 1
    return {
        "bytes_by_kind": bytes_by_kind,
        "count_by_kind": count_by_kind,
        "total_bytes": float(sum(bytes_by_kind.values())),
    }


def op_histogram(rec: Recorder) -> dict:
    """``dot`` and ``convolution`` aten calls and ``custom-call`` (kernel
    entry calls) of a :func:`record` block, with the calls of each entry
    point under ``kernels``."""
    dot = sum(n for name, n in rec.ops.items() if name in DOT_OPS)
    conv = sum(n for name, n in rec.ops.items() if name in CONV_OPS)
    return {"dot": dot, "convolution": conv, "custom-call": sum(rec.kernels.values()),
            "kernels": dict(rec.kernels)}
