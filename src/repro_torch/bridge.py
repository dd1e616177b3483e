"""Parameters from the reference package's tree, for parity tests.

The reference's ``Model.init`` returns a nested dict whose layer groups are
scan-stacked: every leaf under ``layers/s0/...`` has a leading ``(L, ...)``
dim. :func:`params_from_jax` takes that tree with numpy leaves (the caller
converts; this module imports no JAX) and returns the port's
:class:`~repro_torch.models.common.ParamTree`, splitting stacked leaves into
one entry per layer. bf16 leaves pass through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import DTYPES, ParamTree
from .models.lm import check_supported, stack_plan
from .tree import tree_map


def params_from_jax(cfg, tree: dict, device="cpu") -> ParamTree:
    check_supported(cfg)
    dtype = DTYPES[cfg.dtype]

    def conv(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device).to(dtype)

    out = {k: tree_map(conv, v) for k, v in tree.items() if k != "layers"}
    layers = {}
    for grp in stack_plan(cfg):
        group = tree_map(conv, tree["layers"][grp.name])
        if grp.kind == "scan":
            group = [tree_map(lambda t, i=i: t[i], group) for i in range(grp.count)]
        layers[grp.name] = group
    out["layers"] = layers
    return ParamTree(out)
