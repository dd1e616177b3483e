"""Parameters from the reference package's tree, for parity tests.

The reference's ``Model.init`` returns a nested dict whose layer groups are
scan-stacked: every leaf under ``layers/s0/...`` (and an encoder-decoder's
``enc_layers/s0/...``) has a leading ``(L, ...)`` dim. :func:`params_from_jax` takes that tree with numpy leaves (the caller
converts; this module imports no JAX) and returns the port's
:class:`~repro_torch.models.common.ParamTree`, splitting stacked leaves into
one entry per layer. Each leaf takes the shape and dtype that the port's own
parameter plan declares for it (the model dtype, or float32 for the SSM's
``a_log``, ``d_skip`` and ``dt_bias``), whatever the source array's dtype;
bf16 leaves pass through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import DTYPES, Abstract, ParamTree, resolve_device
from .models.lm import check_supported, encoder_plan, param_tree, stack_plan
from .tree import tree_map


def params_from_jax(cfg, tree: dict, device=None) -> ParamTree:
    """The port's parameters from the reference's tree, on ``device``: the
    caller's, else ``cuda:0`` (:func:`~repro_torch.models.common.resolve_device`,
    which raises without a GPU, as every entry point of the port does)."""
    device = resolve_device(device)
    check_supported(cfg)
    declared = param_tree(cfg, Abstract(DTYPES[cfg.dtype]))

    def conv(a, decl: torch.Tensor, stacked: int = 0) -> torch.Tensor:
        a = np.asarray(a)
        want = (stacked, *decl.shape) if stacked else tuple(decl.shape)
        if a.shape != want:
            raise ValueError(f"reference leaf of shape {a.shape}, the port declares {want}")
        return torch.tensor(a.astype(np.float32), device=device).to(decl.dtype)

    plans = {"layers": stack_plan(cfg), "enc_layers": encoder_plan(cfg)}
    out = {k: tree_map(conv, v, declared[k]) for k, v in tree.items() if k not in plans}
    for key, plan in plans.items():
        if plan is None:
            continue
        layers = {}
        for grp in plan:
            src, decl = tree[key][grp.name], declared[key][grp.name]
            if grp.kind == "scan":
                group = tree_map(lambda a, d: conv(a, d, grp.count), src, decl[0])
                group = [tree_map(lambda t, i=i: t[i], group) for i in range(grp.count)]
            else:
                group = tree_map(conv, src, decl)
            layers[grp.name] = group
        out[key] = layers
    return ParamTree(out)
