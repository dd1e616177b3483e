"""repro_torch.parallel — the parallelism layer on ``torch.distributed``,
ported from ``repro.parallel`` (the mesh context, the logical-axis sharding
rules, ZeRO and the sharded step builders; the pipeline waits for a later
slice)."""
from .ctx import ParallelCtx
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
