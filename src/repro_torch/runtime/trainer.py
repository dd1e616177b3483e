"""Fault-tolerant training loop, ported from the reference's
``repro/runtime/trainer.py``.

Composition of the port's substrates, on one device or a mesh:
  * the train step: ``Model.loss`` through autograd, then AdamW in place,
    run by ``run`` as one CUDA graph a step on the card
    (``runtime/graph.py``, the reference's ``jax.jit(step_fn)``; on the CPU
    the same body runs eagerly through the graph's static buffers); with
    ``mesh=``, the body of ``parallel.steps.build_train_step`` (this rank's
    param shards and ZeRO state, the collectives inside the graph)
  * ThreadPool-prefetched data pipeline (repro_torch.data)
  * async atomic checkpoints + resume (repro_torch.checkpoint)
  * watchdog heartbeat + failure injection for fault-tolerance tests

The trainer owns one ``ThreadPool(4)``, shared by the prefetch lanes and
the checkpoint saves, as the reference's does. The restart loop (crash,
restore-latest, continue) is ``run_with_restarts``. The device is the
caller's, else ``cuda:0`` (raising without a GPU).

Under a mesh every rank runs the loop: each draws the global batch from the
same seeded source and the step keeps its rows. The logged metrics are
global values. Every rank takes part in a checkpoint's gather and rank 0
writes it; restore lays the saved arrays out on this trainer's mesh,
whatever mesh saved them.

Metrics are read to the host (``.item()``) only on logged steps, so the
other steps queue their work on the device without waiting for it. Each
logged row carries ``step_s``: the wall seconds per step since the previous
logged row (or the loop's start), read after the row's values, so the
device's queue is drained at both ends.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..core import ThreadPool
from ..data import Prefetcher, SyntheticTokens
from ..models import build_model
from ..models.common import resolve_device
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from ..tree import tree_leaves, tree_map, tree_unflatten
from .graph import GraphError, TrainGraph


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TrainerConfig:
    num_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    seq_len: int = 128
    global_batch: int = 8
    lr: float = 3e-4
    warmup: int = 10
    keep_checkpoints: int = 3
    prefetch_depth: int = 2
    seed: int = 0
    # AdamW's moments: "bfloat16" for very large models (the reference's rule
    # above 1e11 parameters, ``launch.dryrun.moments_dtype_for``)
    moments_dtype: str = "float32"
    # fault injection: raise at this step (once) to test restart/resume
    fail_at_step: Optional[int] = None
    heartbeat_timeout_s: float = 300.0


class Trainer:
    def __init__(
        self,
        model_cfg,
        tcfg: TrainerConfig,
        ckpt_dir: str,
        *,
        mesh=None,
        data_source=None,
        device=None,
    ) -> None:
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, device=self.device)
        self.mesh = mesh
        self.ocfg = AdamWConfig(lr=tcfg.lr, moments_dtype=tcfg.moments_dtype)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.num_steps)
        self.ctx = None
        writer = True
        if mesh is not None:
            import torch.distributed as dist

            from ..parallel.steps import build_train_step, make_ctx

            spec = {"seq_len": tcfg.seq_len, "global_batch": tcfg.global_batch, "kind": "train"}
            self._sharded_step, self.specs, _ = build_train_step(
                self.model, mesh, self.ocfg, self.lr_fn, self.model.input_specs("train", spec))
            self.ctx = make_ctx(mesh)
            writer = dist.get_rank() == 0
        self.pool = ThreadPool(4, name="trainer")
        self.ckpt = CheckpointManager(ckpt_dir, pool=self.pool, keep=tcfg.keep_checkpoints,
                                      writer=writer)
        self.data = data_source or SyntheticTokens(
            model_cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed
        )
        self._failed_once = False
        self.graph: Optional[TrainGraph] = None  # the last run's
        self.metrics_log: list[dict] = []
        # one row a `run`, a restart's too: the step it started from (0, or
        # the restored checkpoint's) and its graph's stats at its end
        self.runs: list[dict] = []
        self._heartbeat = time.monotonic()

    # -- state --------------------------------------------------------------------

    def init_state(self) -> dict:
        """``{"params": ParamTree, "opt": AdamW state, "step": int}``, the
        params from ``Model.init(seed)``; under a mesh, this rank's shards
        and ZeRO state."""
        params = self.model.init(self.tcfg.seed)
        if self.mesh is not None:
            from ..parallel.steps import shard_params

            params = shard_params(self.model, params, self.mesh)
        opt = adamw_init(self.ocfg, params.tree(), ctx=self.ctx)
        return {"params": params, "opt": opt, "step": 0}

    def _specs(self) -> dict:
        """The checkpointed tree's specs (the step's is replicated)."""
        return {"params": self.specs["params"], "opt": self.specs["opt"], "step": ()}

    def _saved(self, state: dict, step: int) -> dict:
        """The checkpointed tree: params as nested dicts, the AdamW state and
        the step (an int32 scalar, as the reference saves it); under a mesh
        the sharded leaves are DTensors of this rank's blocks."""
        tree = {"params": state["params"].tree(), "opt": state["opt"],
                "step": torch.tensor(step, dtype=torch.int32)}
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import placements

        return tree_map(
            lambda t, s: DTensor.from_local(t.detach(), self.mesh, placements(s, self.mesh))
            if any(e is not None for e in s) else t, tree, self._specs())

    def _restore(self, state: dict) -> int:
        """Load the latest checkpoint into ``state`` (params copied into the
        model's parameters in place); returns its step."""
        shardings = None
        if self.mesh is not None:
            from ..parallel.sharding import shardings as named

            shardings = named(self._specs(), self.mesh)
        tree, meta = self.ckpt.restore(self._saved(state, 0), device=self.device,
                                       shardings=shardings)
        tree = tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t, tree)
        with torch.no_grad():
            for p, saved in zip(tree_leaves(state["params"].tree()), tree_leaves(tree["params"])):
                p.copy_(saved)
        state["opt"] = tree["opt"]
        return int(meta["step"])

    def train_step(self, state: dict, batch: dict, step: int) -> dict:
        """One eager step: :meth:`step_body` at ``step``'s lr. Returns the
        step's metrics as 0-d tensors (nothing is read to the host here).
        Under a mesh, the sharded step's global metrics."""
        lr = torch.full((), float(self.lr_fn(step)), dtype=torch.float32, device=self.device)
        return self.step_body(state, batch, lr)

    def step_body(self, state: dict, batch: dict, lr: torch.Tensor) -> dict:
        """Loss and gradients by autograd, then one AdamW update of the
        params and the optimizer state in place, at ``lr`` (a 0-d f32
        tensor on the device): the body the train graph captures, with no
        host read or host value of its own. Under a mesh, the sharded
        step's body (``ShardedTrainStep.body``) on this rank's shards."""
        if self.mesh is not None:
            return self._sharded_step.body(state["params"], state["opt"], batch, lr)[2]
        params = state["params"]
        tree = params.tree()
        leaves = tree_leaves(tree)
        loss, metrics = self.model.loss(params, batch)
        grads = tree_unflatten(tree, torch.autograd.grad(loss, leaves))
        _, _, om = adamw_update(self.ocfg, lr, tree, grads, state["opt"])
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}

    def _build_step(self, state: dict) -> TrainGraph:
        """The step :meth:`run` calls as ``step_fn(batch, step)``, built
        where the reference builds its jit: :meth:`step_graph`, on one
        device or, of the sharded step, under a mesh."""
        return self.step_graph(state)

    def step_graph(self, state: dict) -> TrainGraph:
        """``state``'s train step as a graph (:class:`TrainGraph`), called
        as ``graph(batch, step)``; it replaces (and releases) the last one."""
        self.release_graph()
        self.graph = TrainGraph(self.step_body, self.lr_fn, state, self.device)
        return self.graph

    def release_graph(self) -> None:
        """Drop the last graph and its memory pool."""
        if self.graph is not None:
            self.graph.close()
            self.graph = None

    # -- run -----------------------------------------------------------------------

    def run(self, *, resume: bool = True) -> dict:
        """Train from step 0, or from the latest checkpoint with ``resume``.
        The steps run through a graph of this run's state, built after the
        restore (which replaces the optimizer state: a graph built before it
        would hold stale addresses), the last run's released first; under a
        mesh, the sharded step's graph, which every rank replays
        together."""
        self.release_graph()
        state = self.init_state()
        start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            start_step = self._restore(state)
        step_fn = self._build_step(state)
        prefetch = Prefetcher(
            self.data, pool=self.pool, depth=self.tcfg.prefetch_depth, start_step=start_step,
            device=self.device,
        )
        try:
            _synchronize(self.device)
            t_row, unlogged = time.perf_counter(), 0
            for step in range(start_step, self.tcfg.num_steps):
                self._check_heartbeat()
                if (
                    self.tcfg.fail_at_step is not None
                    and step == self.tcfg.fail_at_step
                    and not self._failed_once
                ):
                    self._failed_once = True
                    raise RuntimeError(f"injected failure at step {step}")
                batch = prefetch.get()
                metrics = step_fn(batch, step)
                unlogged += 1
                self._heartbeat = time.monotonic()
                if step % self.tcfg.log_every == 0 or step == self.tcfg.num_steps - 1:
                    row = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    now = time.perf_counter()
                    row["step"] = step
                    row["step_s"] = (now - t_row) / unlogged
                    t_row, unlogged = now, 0
                    self.metrics_log.append(row)
                if (step + 1) % self.tcfg.checkpoint_every == 0:
                    self.ckpt.save_async(
                        step + 1, self._saved(state, step + 1),
                        meta={"step": step + 1, "cursor": prefetch.cursor},
                    )
            # final checkpoint (skip if the loop just saved this step)
            if self.tcfg.num_steps % self.tcfg.checkpoint_every != 0:
                self.ckpt.save_async(
                    self.tcfg.num_steps, self._saved(state, self.tcfg.num_steps),
                    meta={"step": self.tcfg.num_steps, "cursor": prefetch.cursor},
                )
            self.ckpt.wait()
            if self.mesh is not None:  # every rank sees the committed checkpoint
                import torch.distributed as dist

                dist.barrier()
            return {"params": state["params"], "opt": state["opt"], "metrics": self.metrics_log}
        finally:
            prefetch.close()
            self.runs.append({"start_step": start_step, "graph": step_fn.stats()})

    def run_with_restarts(self, max_restarts: int = 3) -> dict:
        """The preemption loop, in-process: crash -> restore -> continue. A
        failed capture or a moved state (:class:`GraphError`) is raised at
        once: a restart would meet it again."""
        attempts = 0
        while True:
            try:
                return self.run(resume=True)
            except GraphError:
                raise
            except RuntimeError as e:
                attempts += 1
                if attempts > max_restarts:
                    raise
                self.ckpt.wait()
                print(f"[trainer] restart {attempts} after: {e}", flush=True)

    # -- watchdog ---------------------------------------------------------------------

    def _check_heartbeat(self) -> None:
        if time.monotonic() - self._heartbeat > self.tcfg.heartbeat_timeout_s:
            raise TimeoutError("watchdog: no step completed within heartbeat window")

    def close(self) -> None:
        self.release_graph()
        try:
            self.ckpt.wait(60)
        finally:
            self.pool.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
