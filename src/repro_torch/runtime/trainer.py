"""Fault-tolerant training loop, ported from the reference's
``repro/runtime/trainer.py``.

Composition of the port's substrates, on one device:
  * the train step: ``Model.loss`` through autograd, then AdamW in place
  * ThreadPool-prefetched data pipeline (repro_torch.data)
  * async atomic checkpoints + resume (repro_torch.checkpoint)
  * watchdog heartbeat + failure injection for fault-tolerance tests

The trainer owns one ``ThreadPool(4)``, shared by the prefetch lanes and
the checkpoint saves, as the reference's does. The restart loop (crash,
restore-latest, continue) is ``run_with_restarts``. The device is the
caller's, else ``cuda:0`` (raising without a GPU); ``mesh=`` raises
``NotImplementedError`` until the parallelism slice.

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
from ..tree import tree_leaves, tree_unflatten


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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=) waits for the port's parallelism slice; the port trains on "
                "one device"
            )
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, device=self.device)
        self.mesh = mesh
        self.pool = ThreadPool(4, name="trainer")
        self.ckpt = CheckpointManager(ckpt_dir, pool=self.pool, keep=tcfg.keep_checkpoints)
        self.ocfg = AdamWConfig(lr=tcfg.lr)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.num_steps)
        self.data = data_source or SyntheticTokens(
            model_cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed
        )
        self._failed_once = False
        self.metrics_log: list[dict] = []
        self._heartbeat = time.monotonic()

    # -- state --------------------------------------------------------------------

    def init_state(self) -> dict:
        """``{"params": ParamTree, "opt": AdamW state, "step": int}``, the
        params from ``Model.init(seed)``."""
        params = self.model.init(self.tcfg.seed)
        return {"params": params, "opt": adamw_init(self.ocfg, params.tree()), "step": 0}

    def _saved(self, state: dict, step: int) -> dict:
        """The checkpointed tree: params as nested dicts, the AdamW state and
        the step (an int32 scalar, as the reference saves it)."""
        return {"params": state["params"].tree(), "opt": state["opt"],
                "step": torch.tensor(step, dtype=torch.int32)}

    def _restore(self, state: dict) -> int:
        """Load the latest checkpoint into ``state`` (params copied into the
        model's parameters in place); returns its step."""
        tree, meta = self.ckpt.restore(self._saved(state, 0), device=self.device)
        with torch.no_grad():
            for p, saved in zip(tree_leaves(state["params"].tree()), tree_leaves(tree["params"])):
                p.copy_(saved)
        state["opt"] = tree["opt"]
        return int(meta["step"])

    def train_step(self, state: dict, batch: dict, step: int) -> dict:
        """Loss and gradients by autograd, then one AdamW update of the
        params and the optimizer state in place. Returns the step's metrics
        as 0-d tensors (nothing is read to the host here)."""
        params = state["params"]
        tree = params.tree()
        leaves = tree_leaves(tree)
        loss, metrics = self.model.loss(params, batch)
        grads = tree_unflatten(tree, torch.autograd.grad(loss, leaves))
        lr = float(self.lr_fn(step))
        _, _, om = adamw_update(self.ocfg, lr, tree, grads, state["opt"])
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}

    # -- run -----------------------------------------------------------------------

    def run(self, *, resume: bool = True) -> dict:
        state = self.init_state()
        start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            start_step = self._restore(state)
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
                metrics = self.train_step(state, batch, step)
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
            return {"params": state["params"], "opt": state["opt"], "metrics": self.metrics_log}
        finally:
            prefetch.close()

    def run_with_restarts(self, max_restarts: int = 3) -> dict:
        """The preemption loop, in-process: crash -> restore -> continue."""
        attempts = 0
        while True:
            try:
                return self.run(resume=True)
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
        try:
            self.ckpt.wait(60)
        finally:
            self.pool.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
