"""The single-device train step as one CUDA graph: the port's counterpart of
the reference's ``jax.jit(step_fn)`` (``Trainer._build_step`` in
``repro/runtime/trainer.py``).

Eager PyTorch launches every kernel of a train step from Python, one at
a time: thousands a step (the loss, its backward through the kernels,
the global norm and AdamW's pieces), while the card idles. The step is
captured once (:class:`repro_torch.cuda_graph.Graph`) and each replay
launches all of it with one host call.

A graph holds fixed addresses. Its static inputs are the step's lr (a 0-d
f32 tensor) and one buffer per key of the batch, made from the first
batch; each step copies its batch and lr into them. The state it updates
in place is the parameters, the f32 masters, the moments and the step
counter: before each replay their addresses (and the inputs') are checked
against the captured ones, and a moved one raises, since the graph would
go on updating the tensors it captured. The metrics are static outputs,
overwritten by the next step: read them first.

A train step changes the state, which cannot be rolled back (a copy of
deepseek-v2's 53 GB of parameters and optimizer state does not fit beside
it), so the warm-ups are real steps: the first ``WARMUP`` steps on a
``TrainGraph`` run the body eagerly, on their own batches and lrs, and
launch every kernel instantiation once (its first-launch check runs then,
which a capture forbids); the next step is captured and run by the first
replay. The cached blocks the eager steps left are released before the
capture, so the eager step's transient memory and the graph's pool are
not held together. The eager steps and the replays give the same states
bit for bit as an eager loop.

On the CPU nothing is captured: the same body runs eagerly through the
same static buffers at every step.
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from ..cuda_graph import Graph
from ..tree import tree_leaves

__all__ = ["GraphError", "TrainGraph"]


class GraphError(RuntimeError):
    """The train step's capture failed, or what a graph holds moved: no
    restart from a checkpoint mends either, so ``Trainer.run_with_restarts``
    lets it through."""


class TrainGraph:
    """One state's train step as a graph.

    ``body(state, batch, lr)`` is one step on ``state`` (updated in place)
    returning its metrics as 0-d tensors (``Trainer.step_body``);
    ``lr_fn(step)`` the step's lr. Calling the graph runs one step.
    """

    WARMUP = 1

    def __init__(self, body: Callable, lr_fn: Callable, state: dict, device) -> None:
        self.body, self.lr_fn, self.state = body, lr_fn, state
        self.device = torch.device(device)
        self.lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self.inputs: dict = {}
        self.eager_steps = 0
        self.pool_reserved_bytes = None
        self._graph = None
        self._addresses: list = []

    def _run_body(self) -> dict:
        return self.body(self.state, self.inputs, self.lr)

    def _load(self, batch: dict, step: int) -> None:
        """Copy ``batch`` (tensors) and ``step``'s lr into the static inputs
        (made from the first batch), on the caller's stream."""
        if not self.inputs:
            self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                           for k, v in batch.items()}
        have = {k: (tuple(v.shape), v.dtype) for k, v in self.inputs.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if got != have:
            raise ValueError(f"a batch of {got} for the train graph's static inputs {have}")
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        self.lr.fill_(float(self.lr_fn(step)))

    def _state_addresses(self) -> list:
        held = {"params": self.state["params"].tree(), "opt": self.state["opt"],
                "inputs": self.inputs, "lr": self.lr}
        return [t.data_ptr() for t in tree_leaves(held)]

    def __call__(self, batch: dict, step: int) -> dict:
        """One train step on ``batch`` at ``step``'s lr; its metrics."""
        self._load(batch, step)
        if self._graph is None:
            if self.eager_steps < self.WARMUP:
                self.eager_steps += 1
                return self._run_body()
            self._capture()
        if self._state_addresses() != self._addresses:
            raise GraphError(
                "the train state or the static inputs moved since the capture: the graph "
                "would not update them")
        return self._graph.replay()

    def _capture(self) -> None:
        reserved = None
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        self._addresses = self._state_addresses()
        try:
            self._graph = Graph(self._run_body, self.device, warmup=0)
        except RuntimeError as e:
            raise GraphError(f"the train step's capture failed: {e}") from e
        if reserved is not None:
            self.pool_reserved_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def stats(self) -> dict:
        """The eager warm-ups, the replays, the launches captured by kernel,
        the capture's seconds and the device memory the graph's pool holds
        (None on the CPU)."""
        out = {"eager_steps": self.eager_steps, "replays": 0, "captured_launches": {},
               "capture_s": None, "pool_reserved_bytes": self.pool_reserved_bytes}
        if self._graph is not None:
            out.update(self._graph.stats())
        return out

    def close(self) -> None:
        """Release the graph and its pool (they hold the state)."""
        self._graph = None
        self.state = self.inputs = None
