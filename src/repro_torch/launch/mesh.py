"""Device meshes over the initialised ``torch.distributed`` world, ported
from the reference's ``repro/launch/mesh.py``.

Functions, not constants: importing this module touches no process group.
The caller initialises the world (``init_process_group`` with its own
address, world size and rank) before building a mesh. The device type is
the caller's: ``"cuda"`` unless asked for ``"cpu"``; with ``"cuda"`` and no
GPU it raises, and it never falls back to gloo on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' for a CPU mesh")
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed (init_process_group) before a mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks); raises
    unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for n in shape:
        want *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(f"the production mesh {shape} needs {want} ranks; the world has {have}")
    return _mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A ``(world // model, model)`` mesh with axes ``("data", "model")``."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n == 0 or n % model:
        raise ValueError(f"a world of {n} ranks does not split into model={model}")
    return _mesh((n // model, model), ("data", "model"), device_type)


def batch_axes_of(mesh) -> tuple:
    return tuple(ax for ax in mesh.mesh_dim_names if ax in ("pod", "data"))
