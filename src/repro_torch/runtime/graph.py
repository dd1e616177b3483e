"""A step that updates a state in place, as one CUDA graph: the single-device
train step, the port's counterpart of the reference's ``jax.jit(step_fn)``
(``Trainer._build_step`` in ``repro/runtime/trainer.py``), and the sharded
train, prefill and decode steps of ``parallel/steps.py``, the counterparts
of the reference's three ``jax.jit``s in ``repro/parallel/steps.py``.

Eager PyTorch launches every kernel of a train step from Python, one at
a time: thousands a step (the loss, its backward through the kernels,
the global norm and AdamW's pieces, under a mesh also the collectives),
while the card idles. The step is captured once
(:class:`repro_torch.cuda_graph.Graph`) and each replay launches all of it
with one host call.

A graph holds fixed addresses. Its static inputs are one buffer per key of
the inputs (the batch; a decode step's tokens and positions), made from the
first call's, and, for a train step, its lr (a 0-d f32 tensor); each call
copies its inputs into them. The state it updates in place (the
parameters, the f32 masters, the moments and the step counter; a decode
step's caches): before each replay their addresses (and the inputs') are
checked against the captured ones, and a moved one raises, since the graph
would go on updating the tensors it captured. The outputs (the metrics, the
logits, a prefill's caches) are static, overwritten by the next call: read
or clone them first.

A step changes the state, which cannot be rolled back (a copy of
deepseek-v2's 53 GB of parameters and optimizer state does not fit beside
it), so the warm-ups are real steps: the first ``WARMUP`` calls on a graph
run the body eagerly, on their own inputs, and launch every kernel
instantiation once (its first-launch check runs then, which a capture
forbids; under a mesh the NCCL communicators start then too); the next
call is captured and run by the first replay. The cached blocks the eager
steps left are released before the capture, so the eager step's transient
memory and the graph's pool are not held together. The eager steps and the
replays give the same states bit for bit as an eager loop.

Under a mesh the captured body holds the step's collectives (NCCL joins
the capture stream by events, and the backward's collectives launch from
autograd's thread into the same capture): every rank captures the same
sequence, and every rank must call the graph together, as the eager step.

On the CPU nothing is captured: the same body runs eagerly through the
same static buffers at every call.
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from ..cuda_graph import Graph
from ..tree import tree_leaves

__all__ = ["GraphError", "StateGraph", "TrainGraph"]


class GraphError(RuntimeError):
    """A step's capture failed, or what a graph holds moved: no restart
    from a checkpoint mends either, so ``Trainer.run_with_restarts`` lets it
    through."""


class StateGraph:
    """One state's step as a graph.

    ``body(state, inputs)`` is one step on ``state`` (a dict whose values
    are tensor trees or ``ParamTree``s, updated in place) reading the
    static ``inputs`` and returning its outputs, a tree of tensors. Calling
    the graph with the step's inputs runs one step.
    """

    WARMUP = 1

    def __init__(self, body: Callable, state: dict, device) -> None:
        self.body, self.state = body, state
        self.device = torch.device(device)
        self.inputs: dict = {}
        self.eager_steps = 0
        self.pool_reserved_bytes = None
        self._graph = None
        self._addresses: list = []

    @property
    def captured(self) -> bool:
        """Whether the step is captured: every call from then on replays."""
        return self._graph is not None

    def _run_body(self):
        return self.body(self.state, self.inputs)

    def _load(self, inputs: dict) -> None:
        """Copy ``inputs`` (tensors or arrays) into the static inputs (made
        from the first call's), on the caller's stream."""
        inputs = {k: torch.as_tensor(v) for k, v in inputs.items()}
        if not self.inputs:
            self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                           for k, v in inputs.items()}
        have = {k: (tuple(v.shape), v.dtype) for k, v in self.inputs.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in inputs.items()}
        if got != have:
            raise ValueError(f"inputs of {got} for the graph's static inputs {have}")
        for k, v in inputs.items():
            self.inputs[k].copy_(v)

    def _held(self) -> dict:
        """The trees whose addresses the graph holds."""
        return {"state": {k: v.tree() if hasattr(v, "tree") else v
                          for k, v in self.state.items()},
                "inputs": self.inputs}

    def _state_addresses(self) -> list:
        return [t.data_ptr() for t in tree_leaves(self._held()) if isinstance(t, torch.Tensor)]

    def __call__(self, inputs: dict):
        """One step on ``inputs``; its outputs."""
        self._load(inputs)
        return self._step()

    def _step(self):
        if self._graph is None:
            if self.eager_steps < self.WARMUP:
                self.eager_steps += 1
                return self._run_body()
            self._capture()
        if self._state_addresses() != self._addresses:
            raise GraphError(
                "the state or the static inputs moved since the capture: the graph "
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
            raise GraphError(f"the step's capture failed: {e}") from e
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


class TrainGraph(StateGraph):
    """One state's train step as a graph.

    ``body(state, batch, lr)`` is one step on ``state`` (updated in place)
    returning its metrics as 0-d tensors (``Trainer.step_body``, or the
    sharded step's body); ``lr_fn(step)`` the step's lr, which each call
    writes into the static ``lr``. Calling the graph runs one step.
    """

    def __init__(self, body: Callable, lr_fn: Callable, state: dict, device) -> None:
        super().__init__(body, state, device)
        self.lr_fn = lr_fn
        self.lr = torch.zeros((), dtype=torch.float32, device=self.device)

    def _run_body(self) -> dict:
        return self.body(self.state, self.inputs, self.lr)

    def _held(self) -> dict:
        return {**super()._held(), "lr": self.lr}

    def __call__(self, batch: dict, step: int) -> dict:
        """One train step on ``batch`` at ``step``'s lr; its metrics."""
        self._load(batch)
        self.lr.fill_(float(self.lr_fn(step)))
        return self._step()
