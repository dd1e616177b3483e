"""repro_torch.runtime — the training loop, ported from ``repro.runtime``."""
from .graph import GraphError, StateGraph, TrainGraph
from .trainer import Trainer, TrainerConfig

__all__ = ["GraphError", "StateGraph", "TrainGraph", "Trainer", "TrainerConfig"]
