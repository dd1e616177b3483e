"""Sharded step builders: train step, prefill and decode step, ported from
the reference's ``repro/parallel/steps.py``.

This layer owns the specs of the params, the optimizer state (ZeRO), the
batches and the KV caches. Where the reference jits a function over global
arrays with in/out shardings, each rank here calls the returned function
with the global batch and its own shards (params from :func:`shard_params`,
the optimizer state from ``adamw_init(..., ctx=)``, caches from the
prefill): the model takes this rank's rows and runs its share
(``parallel.ctx``). The returned spec trees say which block of each global
array a rank holds; :func:`full_tensor` assembles one.

Each builder returns its step as a CUDA graph on the card
(``runtime/graph.py``), the counterpart of the reference's ``jax.jit``: the
first call on a state runs eagerly (the kernels' first-launch checks and
the NCCL communicators' start), the next is captured and every later call
replays it. A call on another state (other params, optimizer state or
caches) releases the graph and captures anew; a leaf of the state that
moves raises ``GraphError``. On the CPU the same body runs eagerly through
the same static buffers. The eager body stays as ``.body`` (the dry run
traces it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..launch.mesh import batch_axes_of
from ..models.attention import kv_cache_split
from ..models.common import ParamTree
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import adamw_abstract_state
from ..runtime.graph import StateGraph, TrainGraph
from ..tree import tree_flatten_with_keys, tree_leaves, tree_map, tree_unflatten
from .ctx import ParallelCtx, batch_group_of
from .sharding import mesh_shape, param_specs, placements, rules_for, zero_specs


def make_ctx(mesh) -> ParallelCtx:
    """The mesh's ctx, with the group over its batch axes (created on the
    first call for a mesh; every rank makes the same calls)."""
    axes = batch_axes_of(mesh)
    return ParallelCtx(mesh, batch_axes=axes, group=batch_group_of(mesh, axes))


def model_param_specs(model, mesh):
    rules = rules_for(model.cfg)
    return param_specs(model.abstract_params(), model.logical_axes(), rules, mesh)


def opt_state_specs(model, ocfg: AdamWConfig, mesh, pspecs, batch_axes):
    z = zero_specs(pspecs, model.abstract_params(), mesh, batch_axes)
    specs = {"m": z, "v": z, "count": ()}
    if ocfg.keep_master:
        specs["master"] = z
    return specs


def batch_specs(model, batch_abstract: dict, batch_axes, mesh) -> dict:
    ctx = ParallelCtx(mesh, batch_axes=batch_axes)
    out = {}
    for k, v in batch_abstract.items():
        if k == "caches":
            continue
        if v.ndim == 0:
            out[k] = ()
            continue
        out[k] = (ctx.batch_part(v.shape[0]), *([None] * (v.ndim - 1)))
    return out


def cache_specs(abstract_caches: Any, mesh, batch_axes) -> Any:
    """Specs for a (layer-group-stacked) cache tree: batch over the data
    axes; kv heads over model, else the head dim where the kv heads do not
    divide (awkward or few kv heads), else replicated; a ring's positions
    (one row per lane, where the reference keeps one row per call) the
    batch only; MLA's compressed caches shard the sequence; SSM state its
    heads (or state) dim; conv streams their channels."""
    n_model = mesh_shape(mesh)["model"]
    bpart = ParallelCtx(mesh, batch_axes=batch_axes).batch_part

    def spec(name: str, leaf) -> tuple:
        nd = leaf.ndim
        if name == "pos":  # (..., B, W): a ring's absolute positions, one row per lane
            return (*([None] * (nd - 2)), bpart(leaf.shape[-2]), None)
        if name in ("k", "v"):  # (..., B, S, KV, Dh)
            split = kv_cache_split(leaf.shape[-2], leaf.shape[-1], n_model)
            lead = [None] * (nd - 4)
            return (*lead, bpart(leaf.shape[-4]), None,
                    "model" if split == "kv_heads" else None,
                    "model" if split == "head_dim" else None)
        if name in ("ckv", "krope"):  # (..., B, S, D)
            S_len = leaf.shape[-2]
            lead = [None] * (nd - 3)
            seq_ax = "model" if (S_len % n_model == 0 and S_len >= n_model) else None
            return (*lead, bpart(leaf.shape[-3]), seq_ax, None)
        if name == "conv":  # (..., B, K, C)
            C = leaf.shape[-1]
            lead = [None] * (nd - 3)
            return (*lead, bpart(leaf.shape[-3]), None, "model" if C % n_model == 0 else None)
        if name == "state":  # (..., B, H, Pd, N)
            H, N = leaf.shape[-3], leaf.shape[-1]
            lead = [None] * (nd - 4)
            if H % n_model == 0 and H >= n_model:
                return (*lead, bpart(leaf.shape[-4]), "model", None, None)
            if N % n_model == 0 and N >= n_model:
                return (*lead, bpart(leaf.shape[-4]), None, None, "model")
            return (*lead, bpart(leaf.shape[-4]), None, None, None)
        return (bpart(leaf.shape[0]), *([None] * (nd - 1)))

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec(name, node)

    return walk(abstract_caches, None)


# -- shards ---------------------------------------------------------------------


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``."""
    shape = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        r, n = 0, 1
        for ax in entry if isinstance(entry, tuple) else (entry,):
            r, n = r * shape[ax] + mesh.get_local_rank(ax), n * shape[ax]
        size = t.shape[dim] // n
        t = t.narrow(dim, r * size, size)
    return t


def full_tensor(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The global tensor of which every rank holds its ``spec`` block (a
    collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if all(entry is None for entry in spec):
        return local
    return DTensor.from_local(local, mesh, placements(spec, mesh)).full_tensor()


def shard_params(model, params, mesh) -> ParamTree:
    """This rank's shards of the whole ``params`` (a ``ParamTree`` or its
    tree), as a ``ParamTree`` whose leaves carry their spec (``mesh_spec``)
    and ZeRO spec (``zero_spec``)."""
    pspecs = model_param_specs(model, mesh)
    zspecs = zero_specs(pspecs, model.abstract_params(), mesh, batch_axes_of(mesh))
    tree = params.tree() if isinstance(params, ParamTree) else params
    with torch.no_grad():
        local = ParamTree(tree_map(lambda t, s: local_shard(t.detach(), s, mesh).clone(),
                                   tree, pspecs))
    for p, s, z in zip(tree_leaves(local.tree()), tree_leaves(pspecs), tree_leaves(zspecs)):
        p.mesh_spec, p.zero_spec = s, z
    return local


# -- step builders ---------------------------------------------------------------


class _StepGraphs:
    """A step's graph of the state it was last called on (``runtime.graph``):
    a call on other state objects releases it and makes one anew."""

    def __init__(self, body: Callable, device) -> None:
        self.body = body  # the eager step
        self.device = torch.device(device)
        self.graph = None

    def _graph_of(self, state: dict, make: Callable) -> StateGraph:
        g = self.graph
        if g is None or any(g.state[k] is not v for k, v in state.items()):
            self.release()
            self.graph = make(state)
        return self.graph

    def stats(self) -> dict:
        """The current graph's ``stats()`` (empty before the first call)."""
        return {} if self.graph is None else self.graph.stats()

    def release(self) -> None:
        """Drop the graph and its memory pool."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None


class ShardedTrainStep(_StepGraphs):
    """``step(params, opt, batch, step) -> (params, opt, metrics)``:
    :func:`build_train_step`'s step, a :class:`TrainGraph` of the state it
    is called on. ``body(params, opt, batch, lr)`` is the eager step at
    ``lr`` (a float or a 0-d f32 tensor on the device)."""

    def __init__(self, body: Callable, lr_fn: Callable, device) -> None:
        super().__init__(body, device)
        self.lr_fn = lr_fn

    def _graph_body(self, state: dict, batch: dict, lr) -> dict:
        return self.body(state["params"], state["opt"], batch, lr)[2]

    def __call__(self, params, opt_state, batch: dict, step: int):
        graph = self._graph_of({"params": params, "opt": opt_state}, lambda st: TrainGraph(
            self._graph_body, self.lr_fn, st, self.device))
        return params, opt_state, graph(batch, step)


class ShardedPrefill(_StepGraphs):
    """``prefill(params, batch) -> (logits, caches)``: :func:`build_prefill`'s
    step, a :class:`StateGraph` of the params it is called on, each batch
    key a static input. A replay's logits and caches are cloned out of the
    static outputs (the caller's decode updates the caches in place)."""

    def _graph_body(self, state: dict, batch: dict) -> list:
        return list(self.body(state["params"], batch))

    @torch.inference_mode()
    def __call__(self, params, batch: dict):
        graph = self._graph_of({"params": params}, lambda st: StateGraph(
            self._graph_body, st, self.device))
        logits, caches = graph(batch)
        if graph.captured:
            logits, caches = logits.clone(), tree_map(torch.clone, caches)
        return logits, caches


class ShardedDecode(_StepGraphs):
    """``decode(params, tokens, caches, index) -> (logits, caches)``:
    :func:`build_decode_step`'s step, a :class:`StateGraph` of the params and
    caches it is called on, which it updates in place (the reference donates
    them); ``tokens`` and ``index`` are static inputs. A replay's logits are
    cloned out of the static output."""

    def _graph_body(self, state: dict, inputs: dict):
        return self.body(state["params"], inputs["tokens"], state["caches"], inputs["index"])[0]

    @torch.inference_mode()
    def __call__(self, params, tokens, caches, index):
        graph = self._graph_of({"params": params, "caches": caches}, lambda st: StateGraph(
            self._graph_body, st, self.device))
        logits = graph({"tokens": tokens, "index": index})
        return (logits.clone() if graph.captured else logits), caches


def build_train_step(
    model,
    mesh,
    ocfg: AdamWConfig,
    lr_fn: Callable,
    batch_abstract: dict,
):
    """Returns (step, specs, abstract state). ``step(params, opt, batch,
    step)`` (a :class:`ShardedTrainStep`) takes this rank's param shards and
    ZeRO state, updates them in place (where the reference donates its
    buffers) and returns them with the step's global metrics; ``batch`` is
    the global batch (with an encoder-decoder's ``frames`` or a VLM's
    ``patches``). ``step.body`` is the eager step, which reads no host
    value at a tensor lr."""
    ctx = make_ctx(mesh)
    batch_axes = ctx.batch_axes
    pspecs = model_param_specs(model, mesh)
    ospecs = opt_state_specs(model, ocfg, mesh, pspecs, batch_axes)
    bspecs = batch_specs(model, batch_abstract, batch_axes, mesh)

    def step_fn(params, opt_state, batch, lr):
        tree = params.tree()
        share, metrics = model.loss(params, batch, ctx)
        grads = tree_unflatten(tree, torch.autograd.grad(share, tree_leaves(tree)))
        _, _, om = adamw_update(ocfg, lr, tree, grads, opt_state, ctx=ctx)
        loss = ctx.world_sum(share.detach())
        return params, opt_state, {"loss": loss, **metrics, **om}

    abstract = {
        "params": model.abstract_params(),
        "opt": adamw_abstract_state(ocfg, model.abstract_params()),
    }
    return (ShardedTrainStep(step_fn, lr_fn, model.device),
            {"params": pspecs, "opt": ospecs, "batch": bspecs}, abstract)


def _logits_spec(model, ctx: ParallelCtx, B: int) -> tuple:
    vocab_part = "model" if model.cfg.vocab_size % ctx.n_model == 0 else None
    return (ctx.batch_part(B), None, vocab_part)


def build_prefill(model, mesh, batch_abstract: dict):
    """Returns (prefill, specs): ``prefill(params, batch)`` (a
    :class:`ShardedPrefill`) gives this rank's logits and caches, laid out
    by ``specs["logits"]`` and ``specs["caches"]``. ``batch`` holds
    ``tokens`` and, for an encoder-decoder, ``frames`` or, for a VLM,
    ``patches``, each split over the batch axes as the tokens are; a VLM's
    sequence counts its image tokens before its text."""
    ctx = make_ctx(mesh)
    batch_axes = ctx.batch_axes
    pspecs = model_param_specs(model, mesh)
    bspecs = batch_specs(model, batch_abstract, batch_axes, mesh)
    B, S = batch_abstract["tokens"].shape
    if model.cfg.family == "vlm":
        S += model.cfg.num_image_tokens
    cspecs = cache_specs(model.cache_shapes(B, S), mesh, batch_axes)

    def prefill_fn(params, batch):
        return model.prefill(params, batch, ctx)

    specs = {"params": pspecs, "batch": bspecs, "caches": cspecs,
             "logits": _logits_spec(model, ctx, B)}
    return ShardedPrefill(prefill_fn, model.device), specs


def build_decode_step(model, mesh, batch_abstract: dict):
    """decode: one token for every sequence, the caches (this rank's
    shards) updated in place (a :class:`ShardedDecode`). ``batch_abstract``
    holds ``tokens`` (B, 1), ``caches`` (the global caches, or meta tensors
    of their shapes) and ``index`` (B,); an encoder-decoder's ``frames`` or
    a VLM's ``patches`` may ride beside them (decode reads neither: the
    cross cache holds the encoded frames, the caches the patches). MLA's
    latents are split over the sequence, so the step is told their global
    length."""
    ctx = make_ctx(mesh)
    batch_axes = ctx.batch_axes
    pspecs = model_param_specs(model, mesh)
    Bt = batch_abstract["tokens"].shape[0]
    cspecs = cache_specs(batch_abstract["caches"], mesh, batch_axes)
    latent = [t for k, t in tree_flatten_with_keys(batch_abstract["caches"])
              if k.endswith("ckv")]
    if latent:
        ctx = dataclasses.replace(ctx, cache_len=latent[0].shape[-2])

    def decode_fn(params, tokens, caches, index):
        return model.decode_step(params, tokens, caches, index, ctx)

    specs = {"params": pspecs, "caches": cspecs,
             "logits": _logits_spec(model, ctx, Bt)}
    return ShardedDecode(decode_fn, model.device), specs
