"""ParallelCtx: the runtime handle models use to stay mesh-aware, ported
from the reference's ``repro/parallel/ctx.py``.

It carries the mesh and its axis-name conventions, this rank's place on it,
and the collectives the sharded model runs. ``ctx=None`` everywhere means
single-device execution, with no collective and no DTensor on the path.

The reference leaves the collectives to GSPMD and its ``shard_map``; here
every rank holds its local shards as plain tensors and the model issues
named collectives on them. The collectives are autograd functions whose
backward is their adjoint (an all-gather's is a reduce-scatter, an
all-reduce's an all-reduce, an all-to-all's the reverse all-to-all). So
every rank differentiates its own share of the loss (the shares sum to the
loss, :meth:`Model.loss`), and a parameter's gradient is complete once it
is summed over the mesh axes its spec does not shard (the train step does
that, ``parallel.steps``). A collective over a group of one rank is skipped.

The sharded parameters carry their spec as the attribute ``mesh_spec``
(``parallel.steps.shard_params``); :meth:`gather` and :meth:`take` read it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import mesh_shape


# torch renamed the flat collectives; either name takes (output, input, group=)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((_size(group) * xm.shape[0], *xm.shape[1:]))
        _all_gather_flat(out, xm, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] // _size(group), *xm.shape[1:]))
        _reduce_scatter_flat(out, xm, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """``jax.lax.all_to_all(tiled=True)``: ``x`` split into one block per
    rank along ``split``, block j sent to rank j, and the received blocks
    concatenated in rank order along ``concat``."""

    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.split, ctx.concat, ctx.group = split, concat, group
        n = _size(group)
        xm = x.movedim(split, 0)
        blocks = xm.reshape(n, xm.shape[0] // n, *xm.shape[1:]).contiguous()
        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks, group=group)
        return torch.cat([b.movedim(0, split) for b in out.unbind(0)], dim=concat)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.concat, ctx.split, ctx.group), None, None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    return x if _size(group) == 1 else _AllToAll.apply(x, split, concat, group)


@dataclass(frozen=True)
class ParallelCtx:
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)  # axes sharding the batch dim
    model_axis: str = "model"
    seq_shard: bool = True  # sequence-parallel residual stream between blocks
    expert_parallel: bool = True
    # the global batch and full sequence length of the inputs in flight (``at``)
    batch: Optional[int] = None
    seq_len: Optional[int] = None

    # -- the mesh ------------------------------------------------------------------

    @property
    def n_model(self) -> int:
        return mesh_shape(self.mesh)[self.model_axis]

    @property
    def n_batch(self) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for ax in self.batch_axes:
            n *= shape[ax]
        return n

    @property
    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    @property
    def batch_group(self):
        if len(self.batch_axes) != 1:
            raise NotImplementedError(
                "a batch over several mesh axes (the multi-pod mesh) waits for the pipeline slice"
            )
        return self.mesh.get_group(self.batch_axes[0])

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model_axis)

    @property
    def batch_rank(self) -> int:
        r = 0
        for ax in self.batch_axes:
            r = r * mesh_shape(self.mesh)[ax] + self.mesh.get_local_rank(ax)
        return r

    @property
    def world(self) -> int:
        return self.n_model * self.n_batch

    # -- activations ---------------------------------------------------------------

    def activation_spec(self, x) -> Optional[tuple]:
        """Residual-stream spec for (B, S, d) activations of the global
        shape ``x.shape``."""
        if x.ndim != 3:
            return None
        B, S, _ = x.shape
        return (self.batch_part(B), self.model_axis if self.seq_split(S) else None, None)

    def batch_part(self, B: int):
        """The batch dim's mesh axes, or None when B is too small to shard."""
        return self.batch_axes if B % self.n_batch == 0 and B >= self.n_batch else None

    def seq_split(self, S: int) -> bool:
        return self.seq_shard and S % self.n_model == 0 and S >= self.n_model

    def at(self, B: int, S: int) -> "ParallelCtx":
        """This ctx for inputs of global batch ``B`` and sequence ``S``."""
        return dataclasses.replace(self, batch=B, seq_len=S)

    @property
    def seq_sharded(self) -> bool:
        """Whether the residual stream in flight is split over model."""
        return self.seq_len is not None and self.seq_split(self.seq_len)

    @property
    def batch_sharded(self) -> bool:
        return self.batch is not None and self.batch_part(self.batch) is not None

    def local_batch(self, x):
        """This rank's rows of a global input (a tensor or an array)."""
        if not self.batch_sharded or self.n_batch == 1:
            return x
        size = x.shape[0] // self.n_batch
        return x[self.batch_rank * size : (self.batch_rank + 1) * size]

    def copies(self, seq_split: bool) -> int:
        """Ranks that hold each token of the inputs in flight: the model
        group's where the tokens are not split over it, times the batch
        axes' where the batch is not split."""
        return (1 if seq_split else self.n_model) * (1 if self.batch_sharded else self.n_batch)

    def batch_spec(self, ndim: int = 2) -> tuple:
        return (self.batch_axes, *([None] * (ndim - 1)))

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's block of ``x`` along ``dim``."""
        n = self.n_model
        if n == 1:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, self.model_rank * size, size)

    def constrain_activations(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) activations, whole along S, to the residual stream's
        layout: this rank's block of the sequence where it is split."""
        return self.chunk(x, 1) if x.ndim == 3 and self.seq_sharded else x

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream whole along S (an all-gather where split)."""
        return all_gather(x, 1, self.model_group) if self.seq_sharded else x

    def seq_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over the model group, whole along S, to the residual
        stream's layout: a reduce-scatter over S where split, else an
        all-reduce."""
        if self.seq_sharded:
            return reduce_scatter(x, 1, self.model_group)
        return all_reduce(x, self.model_group)

    def model_all_to_all(self, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
        """:func:`all_to_all` over the model group."""
        return all_to_all(x, split, concat, self.model_group) if self.n_model > 1 else x

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.model_group)

    def model_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(x, dim, self.model_group)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.batch_group)

    def batch_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sums over the batch axes, this rank keeping its block along ``dim``."""
        return reduce_scatter(x, dim, self.batch_group)

    def batch_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(x, dim, self.batch_group)

    def model_max(self, x: torch.Tensor) -> torch.Tensor:
        """An elementwise max over the model group (no gradient)."""
        if self.n_model > 1:
            x = x.detach().clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.model_group)
        return x

    def world_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over every rank (the mesh spans the world)."""
        return x if self.world == 1 else _AllReduce.apply(x, None)

    # -- sharded parameters -------------------------------------------------------

    def model_dim(self, w: torch.Tensor) -> Optional[int]:
        """The dim of ``w`` its spec shards over the model axis, or None."""
        for i, entry in enumerate(getattr(w, "mesh_spec", ())):
            if entry == self.model_axis or (isinstance(entry, tuple) and self.model_axis in entry):
                return i
        return None

    def gather(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` whole over the model axis (an all-gather where sharded)."""
        dim = self.model_dim(w)
        return w if dim is None else self.model_gather(w, dim)

    def take(self, w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This model rank's block of ``w`` along ``dim`` (``w`` whole when
        ``dim`` is None), whatever dim its spec shards: no collective when
        that is ``dim``, else an all-gather first."""
        if dim is not None and self.model_dim(w) == dim:
            return w
        full = self.gather(w)
        return full if dim is None else self.chunk(full, dim)
