"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

It stands alone: it imports ``torch``, numpy and the standard library, and
nothing of JAX or of the reference package, whose jax-free modules it keeps
its own copies of (``core``, ``configs``, ``dist``, ``analysis``). Its entry
points run on the GPU (``cuda:0``) unless the caller passes another device.

The model surface mirrors ``repro.models`` and the serving surface
``repro.serve``.
"""
from .models import Model, build_model, init_params, stack_plan
from .serve import PagedKVCache, ServeEngine, SlotKVCache

__all__ = [
    "Model",
    "PagedKVCache",
    "ServeEngine",
    "SlotKVCache",
    "build_model",
    "init_params",
    "stack_plan",
]
