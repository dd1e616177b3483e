"""repro_torch.optim — AdamW, ported from ``repro.optim``."""
from .adamw import (
    AdamWConfig,
    adamw_abstract_state,
    adamw_init,
    adamw_update,
    cosine_schedule,
    decay_mask,
    global_norm,
)

__all__ = [
    "AdamWConfig",
    "adamw_abstract_state",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "decay_mask",
    "global_norm",
]
