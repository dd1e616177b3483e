"""Shared model-building utilities: numerics, rotary embeddings, masks and
the seeded parameter initialiser.

Ported from the reference's ``repro/models/common.py``. The numerics keep
its rounding order: norms and RoPE compute in float32 and cast back to the
activation dtype. Masks use the finite ``NEG_INF`` so that a fully masked
row never turns into NaN.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda:0``.

    There is no silent CPU fallback: with no device given and no GPU
    present this raises, so a CPU run is always one the caller asked for.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)


# -- parameters -----------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested parameter tree indexed like the reference's param dict.

    ``p["attn"]["wq"]`` reads a leaf; lists (the per-layer entries of a
    layer group) become ``nn.ModuleList``s. Every leaf is a trainable
    ``nn.Parameter`` (``requires_grad=True``), so ``Model.loss`` has
    gradients for all of them; serving runs under ``torch.inference_mode``
    and builds no graph. :meth:`tree` gives the same leaves as nested dicts
    and lists, the form the optimizer and the checkpoints take.
    """

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=True))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def tree(self) -> dict:
        """The leaves (the ``nn.Parameter``s themselves) as nested dicts,
        with a list per layer group."""
        out: dict = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = [m.tree() for m in mod] if isinstance(mod, nn.ModuleList) else mod.tree()
        return out


class Init:
    """Seeded initialiser with the reference's ``Alloc("init")`` laws.

    ``normal`` is fan-in scaled (the contracted dims: ``shape[0]`` for
    matrices, every dim but the last above that — so a layer-stacked leaf
    counts its stacking dim, exactly as the reference does), ``embed`` is a
    normal times ``scale``, ``zeros`` and ``ones`` are constant, ``ssm_dt``
    is the Mamba dt bias (softplus-inverse of a log-uniform dt in [0.001,
    0.1)) and ``ssm_a`` the log of a uniform A in [1, 16). Draws come from
    one ``torch.Generator`` in call order, so one seed gives one model.
    ``dtype`` overrides the model dtype for one leaf, as the reference keeps
    the SSM's per-head ``a_log``, ``d_skip`` and ``dt_bias`` in float32.
    """

    def __init__(self, generator: torch.Generator, device, dtype: torch.dtype) -> None:
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(
        self,
        shape: Sequence[int],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        shape = tuple(shape)
        dtype = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init in ("ssm_dt", "ssm_a"):
            u = torch.rand(shape, generator=self.generator, device=self.device)
            if init == "ssm_a":  # A in [1, 16), stored as its log
                return torch.log(1.0 + 15.0 * u).to(dtype)
            lo, hi = 0.001, 0.1
            dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if init == "normal":
            if scale is None:
                fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
                scale = fan_in**-0.5
        elif init == "embed":
            scale = scale or 1.0
        else:
            raise ValueError(f"unknown init {init!r}")
        x = torch.randn(shape, generator=self.generator, device=self.device, dtype=torch.float32)
        return (x * scale).to(dtype)


class StackedInit:
    """Prepends a ``layers`` dim to every param, as the reference's
    ``StackedAlloc`` does, so the fan-in law sees the same shape."""

    def __init__(self, init: Init, num_layers: int) -> None:
        self._init, self._L = init, num_layers

    def param(
        self,
        shape: Sequence[int],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        return self._init.param((self._L, *shape), init, scale, dtype)


def init_params(cfg, generator: torch.Generator, device, dtype: torch.dtype) -> ParamTree:
    """Random parameters for ``cfg``: the reference's shapes and init laws,
    drawn from ``generator`` on ``device``."""
    from .lm import param_tree  # the layer plan lives with the model

    return ParamTree(param_tree(cfg, Init(generator, device, dtype)))


# -- numerics ------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# -- rotary embeddings -----------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., :, None, None].float() * inv  # (..., S, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- masks ------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask_bias(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    prefix_len: Optional[int] = None,
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Additive attention bias, f32: 0 = attend, NEG_INF = masked.

    q_pos: (..., Sq) absolute positions, with an optional leading batch of
    lanes; k_pos: (Sk,). window: sliding-window radius (keys within
    [q-window+1, q]). prefix_len: positions < prefix_len attend
    bidirectionally. valid_len: scalar or (...,) per lane — keys at
    positions >= valid_len are masked (decode with a partially filled
    cache). Returns (..., Sq, Sk).
    """
    q = q_pos[..., :, None].long()
    k = k_pos.long()
    ok = k <= q
    if prefix_len is not None:
        ok = ok | (k < prefix_len)
    if window is not None:
        ok = ok & (k > q - window)
        if prefix_len is not None:
            ok = ok | ((k < prefix_len) & (k > q - window))
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=k.device).long()
        ok = ok & (k < vl[..., None, None])
    zero = torch.zeros((), dtype=torch.float32, device=k.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))
