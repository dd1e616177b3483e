"""repro_torch.runtime — the training loop, ported from ``repro.runtime``."""
from .graph import GraphError, TrainGraph
from .trainer import Trainer, TrainerConfig

__all__ = ["GraphError", "TrainGraph", "Trainer", "TrainerConfig"]
