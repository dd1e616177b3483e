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

A batch over several mesh axes (the multi-pod mesh's ``("pod", "data")``)
runs its batch collectives on one group over the flattened axes, rank
``pod * n_data + data`` of it; :func:`batch_group_of` creates it, once per
mesh, on every rank (``new_group`` is collective), and ``make_ctx`` passes
it in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..analysis import traffic
from .sharding import mesh_shape


# torch renamed the flat collectives; either name takes (output, input, group=)
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


_FLAT_GROUPS: dict = {}  # (id(mesh), axes) -> (mesh, group): one group per mesh


def batch_group_of(mesh, axes: Tuple[str, ...]):
    """The process group over the flattened mesh ``axes``: the group of the
    one axis among them wider than one rank, or, where several are, a group
    over all of them, its ranks in the order of the flattened index (the
    first axis outermost). Every rank calls this with the same meshes in
    the same order: the groups are created collectively, once per mesh."""
    shape = mesh_shape(mesh)
    wide = [a for a in axes if shape[a] > 1]
    if len(wide) <= 1:
        return mesh.get_group(wide[0] if wide else axes[0])
    key = (id(mesh), tuple(axes))
    if key not in _FLAT_GROUPS:
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in axes] + [i for i, a in enumerate(names) if a not in axes]
        n = 1
        for a in axes:
            n *= shape[a]
        grid = mesh.mesh.permute(order).reshape(n, -1)
        ranks = [grid[:, j].tolist() for j in range(grid.shape[1])]
        # a group orders its ranks by global rank: that must be the flattened index
        if any(r != sorted(r) for r in ranks):
            raise ValueError(f"the mesh's ranks do not ascend along {axes}: {ranks}")
        group, _ = dist.new_subgroups_by_enumeration(ranks)
        _FLAT_GROUPS[key] = (mesh, group)  # the mesh is kept, so its id is not reused
    return _FLAT_GROUPS[key][1]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((_size(group) * xm.shape[0], *xm.shape[1:]))
        _all_gather_flat(out, xm, group=group)
        if traffic.ACTIVE is not None:
            traffic.ACTIVE.collective("all-gather", out, _size(group))
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
        if traffic.ACTIVE is not None:
            traffic.ACTIVE.collective("reduce-scatter", out, _size(group))
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
        if traffic.ACTIVE is not None:
            traffic.ACTIVE.collective("all-reduce", out, _size(group))
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
        if traffic.ACTIVE is not None:
            traffic.ACTIVE.collective("all-to-all", out, _size(group))
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
    # decode: the global length of MLA's latent caches, which are split over
    # the sequence where the model axis divides it (``parallel.steps``)
    cache_len: Optional[int] = None
    # the group over the batch axes (``batch_group_of``): make_ctx's
    group: object = dataclasses.field(default=None, compare=False, repr=False)

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
        if self.group is None:
            raise ValueError("the batch axes' group comes from parallel.steps.make_ctx")
        return self.group

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

    def batch_sum_except(self, x: torch.Tensor, sharded: set) -> torch.Tensor:
        """Sums over the batch axes that are not in ``sharded`` (a
        parameter's spec that puts ``data`` on a dim is already whole over
        it, deepseek-v2's expert hidden dim: only ``pod`` is summed)."""
        rest = [a for a in self.batch_axes if a not in sharded]
        if len(rest) == len(self.batch_axes):
            return self.batch_sum(x)
        for a in rest:
            x = all_reduce(x, self.mesh.get_group(a))
        return x

    def axis_gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """``x`` whole along ``dim`` over the mesh axis ``axis`` (an
        all-gather; its adjoint reduce-scatters the gradient back)."""
        return all_gather(x, dim, self.mesh.get_group(axis))

    def seq_split_of(self, S: int) -> bool:
        """Whether a cache of ``S`` positions is split over the model axis
        along its sequence (MLA's latents in ``cache_specs``)."""
        return self.n_model > 1 and S % self.n_model == 0 and S >= self.n_model

    def model_max(self, x: torch.Tensor) -> torch.Tensor:
        """An elementwise max over the model group (no gradient)."""
        if self.n_model > 1:
            x = x.detach().clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.model_group)
            if traffic.ACTIVE is not None:
                traffic.ACTIVE.collective("all-reduce", x, self.n_model)
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
