"""repro_torch.runtime — the training loop, ported from ``repro.runtime``."""
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
