"""repro_torch.serve — the continuous-batching inference engine on the
port's task-graph thread pool, ported from ``repro.serve`` (DESIGN.md §7,
§13).

``kv.py`` owns the KV-cache layout knowledge as two cache pools — the flat
per-slot :class:`SlotKVCache` and the block-pooled :class:`PagedKVCache`;
``engine.py`` schedules prefill/decode as prioritized tasks on the
work-stealing pool, batches sequences at iteration level, streams tokens
per tick, and under page pressure preempts the youngest resident back to
its deadline-ordered admit queue.
"""
from .engine import (
    DECODE_PRIORITY,
    PREFILL_PRIORITY,
    PREFILL_SOON,
    PREFILL_URGENT,
    DeadlineExceeded,
    GenRequest,
    QueueFull,
    RequestHandle,
    ServeEngine,
)
from .kv import PagedKVCache, SlotKVCache, pad_caches_to

__all__ = [
    "ServeEngine",
    "GenRequest",
    "RequestHandle",
    "QueueFull",
    "DeadlineExceeded",
    "SlotKVCache",
    "PagedKVCache",
    "pad_caches_to",
    "PREFILL_PRIORITY",
    "PREFILL_SOON",
    "PREFILL_URGENT",
    "DECODE_PRIORITY",
]
