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
with one host call. :class:`~repro_torch.cuda_graph.StateGraph`, the step
of a state, lives beside ``Graph`` (the serve engine's exact-length
prefills use it too, without this package's trainer); :class:`TrainGraph`,
the train step with its lr, is here.

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

from typing import Callable

import torch

from ..cuda_graph import GraphError, StateGraph, release_cache

__all__ = ["GraphError", "StateGraph", "TrainGraph"]


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

    def _capture(self) -> None:
        # nothing else runs beside a train step's capture, and the eager
        # step's cached blocks, which the graph's pool cannot take and its
        # replays never use, would stay reserved beside the pool: they go
        # back to the card first (kept, they raised the train cells'
        # reserved peaks by 7-19 GB on an H100)
        if self.device.type == "cuda":
            release_cache()
        super()._capture()

    def __call__(self, batch: dict, step: int) -> dict:
        """One train step on ``batch`` at ``step``'s lr; its metrics."""
        self._load(batch)
        self.lr.fill_(float(self.lr_fn(step)))
        return self._step()
