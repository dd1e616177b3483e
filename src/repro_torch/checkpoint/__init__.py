"""repro_torch.checkpoint — async atomic checkpoints on the pool, ported
from ``repro.checkpoint`` (same on-disk format)."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
