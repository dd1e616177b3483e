"""repro_torch.parallel — the parallelism layer on ``torch.distributed``,
ported from ``repro.parallel`` (the mesh context, the logical-axis sharding
rules, ZeRO, the sharded step functions and the pipeline scheduled by the
paper's simulator)."""
from .ctx import ParallelCtx
from .pipeline import build_pipelined_loss, forward_tick_table
from .sharding import (
    DEFAULT_RULES,
    NamedSharding,
    estimate_padding_waste,
    param_specs,
    placements,
    rules_for,
    shardings,
    spec_for,
    zero_specs,
)

__all__ = [
    "ParallelCtx",
    "build_pipelined_loss",
    "forward_tick_table",
    "DEFAULT_RULES",
    "NamedSharding",
    "estimate_padding_waste",
    "param_specs",
    "placements",
    "rules_for",
    "shardings",
    "spec_for",
    "zero_specs",
]
