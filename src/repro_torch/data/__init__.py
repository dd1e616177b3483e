"""repro_torch.data — the token sources (a copy of ``repro.data.synthetic``,
which is jax-free) and the prefetching pipeline, ported from
``repro.data``."""
from .pipeline import Prefetcher, to_device
from .synthetic import MemmapTokens, SyntheticTokens

__all__ = ["Prefetcher", "SyntheticTokens", "MemmapTokens", "to_device"]
