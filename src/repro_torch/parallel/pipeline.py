"""Pipeline parallelism driven by the paper's task-graph scheduler, ported
from the reference's ``repro/parallel/pipeline.py`` onto ``torch.distributed``.

The schedule comes from the paper's machinery (DESIGN.md §2): the
(microbatch × stage) forward grid is a dependency-counted task graph;
:func:`repro_torch.core.schedule.simulate` executes it with the paper's
policy and emits the tick table ``stage s works on microbatch (t - s) at
tick t``. Each rank of the mesh axis (``pod``) is one stage and holds that
stage's parameters; the microbatched inputs and targets are replicated.
At every tick a rank applies its stage when the table says so (an idle
tick skips the stage: the reference computes it and masks it out, with the
same result) and hands its activation to the next stage around the ring
(the last→0 edge is ignored, because stage 0 always reads fresh input).

The backward is a mirrored pipeline, and it must pair every send with a
receive on every rank. Plain autograd would not: it runs a node's backward
only where the node reaches the rank's loss, so stage 0 (whose share of the
loss is a constant 0) and the ignored last→0 edge would never send, and
their partners would wait forever. So each rank's whole tick loop is one
``torch.autograd.Function`` (:class:`_Ticks`). Its forward runs the ticks
and keeps each active tick's input and output (under
``torch.utils.checkpoint``, ``use_reentrant=False``, when ``remat``: only
the input is kept and the stage is recomputed in the backward). Its
backward walks the ticks in reverse; at each it exchanges gradients around
the ring (dL/d(input) to stage s−1, dL/d(output) from stage s+1) with
``dist.batch_isend_irecv``, every tick on every rank, zeros included, and
backpropagates through the stage where the tick was active. Every rank
reaches that backward, whatever of its inputs is frozen: the Function also
takes a fresh scalar that always needs a gradient and returns a zero scalar
(``anchor``) that is added to every rank's loss.

The loss is seeded once. The last stage sums ``loss_fn`` over its
microbatches; the sum is all-reduced over the axis (a sum whose backward is
the identity, :class:`_ReplicatedSum`) and divided by M, so every rank
returns the same loss, as the reference's ``psum(acc) / M``, and each
rank's cotangent of 1 reaches only its own share. A rank's gradients are
its share: its stage's parameters' are whole; a replicated leaf upstream of
``x_mb`` (an embedding) gets its gradient on stage 0 and zero elsewhere, and
the leaves ``loss_fn`` reaches get theirs on the last stage (sum over the
axis where a leaf is replicated). With one rank on the axis the exchange is
skipped, as the parallel layer's collectives are.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..analysis import traffic
from ..core.schedule import PipelineOp, SimTask, simulate
from ..tree import tree_leaves, tree_unflatten
from .sharding import mesh_shape


def forward_tick_table(num_stages: int, num_microbatches: int) -> np.ndarray:
    """mb_for[tick, stage] = microbatch index or -1, derived by simulating
    the paper's scheduler on the forward grid."""
    S, M = num_stages, num_microbatches
    tasks = []
    fid = {}
    for m in range(M):
        for s in range(S):
            fid[(m, s)] = len(tasks)
            tasks.append(
                SimTask(
                    name=f"F{m}.{s}", worker=s, priority=-float(m),
                    payload=PipelineOp("F", m, s),
                )
            )
    for m in range(M):
        for s in range(1, S):
            tasks[fid[(m, s - 1)]].successors.append(fid[(m, s)])
            tasks[fid[(m, s)]].num_predecessors += 1
    res = simulate(tasks, num_stages, allow_steal=False)
    ticks = int(round(res.makespan))
    table = -np.ones((ticks, num_stages), np.int32)
    for w, tl in enumerate(res.timelines):
        for tid, s0, _s1 in tl:
            op = tasks[tid].payload
            table[int(round(s0)), w] = op.microbatch
    return table


class _Ring:
    """This rank's place on the pipeline axis and the tick's exchange."""

    def __init__(self, mesh, axis: str) -> None:
        self.size = mesh_shape(mesh)[axis]
        self.stage = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.next = dist.get_global_rank(self.group, (self.stage + 1) % self.size)
        self.prev = dist.get_global_rank(self.group, (self.stage - 1) % self.size)

    def shift(self, send: torch.Tensor, *, forward: bool) -> torch.Tensor:
        """Send ``send`` one stage on (``forward``) or back, and return what
        arrives from the other side. Every rank calls it at every tick."""
        if self.size == 1:
            return send
        dst, src = (self.next, self.prev) if forward else (self.prev, self.next)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send.contiguous(), dst, self.group),
               dist.P2POp(dist.irecv, recv, src, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if traffic.ACTIVE is not None:
            traffic.ACTIVE.collective("collective-permute", recv, self.size)
        return recv


class _Ticks(torch.autograd.Function):
    """One rank's tick loop (module docs). Returns the last stage's output
    for every microbatch, ``(M, *mb_shape)`` (empty on the other stages),
    and the zero ``anchor``. ``always`` is a scalar that needs a gradient,
    so that the anchor needs one and the backward runs on every rank even
    where neither ``x_mb`` nor the stage's leaves need a gradient."""

    @staticmethod
    def forward(ctx, ring, table, stage, remat, always, x_mb, *leaves):
        M = x_mb.shape[0]
        s, last = ring.stage, ring.stage == ring.size - 1
        x_grad, p_grad = ctx.needs_input_grad[5], ctx.needs_input_grad[6:]
        params = [p.detach().requires_grad_(g) for p, g in zip(leaves, p_grad)]
        needs_x = s > 0 or x_grad
        buf = x_mb.new_zeros(x_mb.shape[1:])
        outs = x_mb.new_empty((M, *x_mb.shape[1:]) if last else (0,))
        saved = {}  # tick -> (stage input, stage output with its graph)
        for t in range(table.shape[0]):
            mb = int(table[t, s])
            if mb >= 0:
                x_in = x_mb[mb] if s == 0 else buf
                x_in = x_in.detach().requires_grad_(needs_x)
                with torch.enable_grad():
                    if remat:
                        out = checkpoint(stage, x_in, *params, use_reentrant=False)
                    else:
                        out = stage(x_in, *params)
                saved[t] = (x_in, out)
                out = out.detach()
                if last:
                    outs[mb] = out
            else:
                out = buf
            buf = ring.shift(out, forward=True)
        ctx.ring, ctx.table, ctx.saved, ctx.params = ring, table, saved, params
        ctx.x_meta = (x_mb.shape, x_mb.dtype, x_mb.device, x_grad)
        ctx.set_materialize_grads(False)
        if not last:
            ctx.mark_non_differentiable(outs)
        return outs, x_mb.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g_outs, _g_anchor):
        ring, table, saved, params = ctx.ring, ctx.table, ctx.saved, ctx.params
        shape, dtype, device, x_grad = ctx.x_meta
        s = ring.stage
        g_params = [None] * len(params)
        g_x_mb = torch.zeros(shape, dtype=dtype, device=device) if x_grad else None
        g_buf = torch.zeros(shape[1:], dtype=dtype, device=device)  # the final buffer's
        for t in reversed(range(table.shape[0])):
            g_out = ring.shift(g_buf, forward=False)  # from the stage that read my output
            mb = int(table[t, s])
            if mb < 0:
                g_buf = g_out  # an idle tick passed its buffer through
                continue
            if g_outs is not None:  # the last stage: the loss's share
                g_out = g_out + g_outs[mb]
            x_in, out = saved.pop(t)
            wrt = [x_in] * x_in.requires_grad + [p for p in params if p.requires_grad]
            got = (list(torch.autograd.grad(out, wrt, g_out, allow_unused=True))
                   if out.requires_grad else [None] * len(wrt))
            g_in = got.pop(0) if x_in.requires_grad else None
            for i, p in enumerate(params):
                if p.requires_grad:
                    g = got.pop(0)
                    if g is not None:
                        g_params[i] = g if g_params[i] is None else g_params[i] + g
            if s == 0:
                if g_x_mb is not None and g_in is not None:
                    g_x_mb[mb] += g_in
                g_buf = torch.zeros_like(g_buf)  # stage 0 read fresh input, not the ring
            else:
                g_buf = g_in if g_in is not None else torch.zeros_like(g_buf)
        ctx.saved = None
        return (None, None, None, None, None, g_x_mb, *g_params)


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the pipeline axis, replicated; the backward hands each rank
    its own cotangent (the loss is seeded once, not once per rank)."""

    @staticmethod
    def forward(ctx, x, ring):
        out = x.detach().clone()
        if ring.size > 1:
            dist.all_reduce(out, group=ring.group)
            if traffic.ACTIVE is not None:
                traffic.ACTIVE.collective("all-reduce", out, ring.size)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def build_pipelined_loss(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    mesh,
    *,
    axis: str = "pod",
    num_microbatches: int,
    remat: bool = True,
):
    """Returns ``(loss, table)``: ``loss(stage_params, x_mb, y_mb) -> scalar``
    and the static tick table.

    ``mesh`` is a ``DeviceMesh`` with the axis ``axis``; each rank on it is
    the stage of its place on the axis. ``stage_params``: this rank's
    stage's parameters, a tree (dicts and lists) of tensors; ``x_mb``:
    ``(M, mb, ...)`` microbatched inputs, ``y_mb``: their targets (indexed
    by microbatch), both the same on every rank. ``stage_fn(stage_params,
    x) -> x`` keeps the shape and dtype; ``loss_fn(x_final, y) -> scalar``
    is a mean over the microbatch. Every rank of the axis calls ``loss``
    and the backward of what it returns, as with any collective.
    """
    ring = _Ring(mesh, axis)
    table = forward_tick_table(ring.size, num_microbatches)  # static schedule

    def loss(stage_params, x_mb, y_mb):
        if x_mb.shape[0] != num_microbatches:
            raise ValueError(f"x_mb holds {x_mb.shape[0]} microbatches, "
                             f"the table {num_microbatches}")
        leaves = tree_leaves(stage_params)

        def stage(x, *ps):
            return stage_fn(tree_unflatten(stage_params, ps), x)

        always = torch.zeros((), device=x_mb.device, requires_grad=True)
        outs, anchor = _Ticks.apply(ring, table, stage, remat, always, x_mb, *leaves)
        acc = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        if ring.stage == ring.size - 1:  # the last stage: the finished microbatches
            for m in range(num_microbatches):
                acc = acc + loss_fn(outs[m], y_mb[m]).float()
        return _ReplicatedSum.apply(acc, ring) / num_microbatches + anchor

    return loss, table
