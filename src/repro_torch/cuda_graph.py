"""One body captured as a CUDA graph and replayed: what the serve engine's
graphs (``serve/graphs.py``), the trainer's step and the sharded train,
prefill and decode steps (``runtime/graph.py``, ``parallel/steps.py``)
share, the port's counterpart of the reference's ``jax.jit``.

Eager PyTorch launches every kernel of a body from Python, one at a
time. A graph is captured once, with every shape and address fixed, and its
replay launches all of them with one host call.

:class:`Graph` is one body, captured when it is built. :class:`StateGraph`
is one state's step, captured on its second call, as ``jax.jit`` compiles on
the first use of a shape: the first call runs eagerly and is the real
answer (``runtime/graph.py`` says why), the second captures and replays,
later calls replay.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Optional

import torch

from .kernels import build
from .tree import tree_leaves, tree_map

__all__ = ["Graph", "GraphError", "StateGraph", "capture_stream", "release_cache"]

_streams = threading.local()
# one capture at a time in the process: a capture may empty the allocator's
# cache first (release_cache), which the allocator must not do while another
# thread's capture is underway, and the collector's switch, held off through
# a capture, is one for every thread
_capturing = threading.RLock()
# a capture empties the allocator's cache first when less than this share of
# the card is free (``Graph``)
LOW_FREE_SHARE = 0.25


def release_cache() -> None:
    """Collect garbage (a closed engine's graphs and their pools) and give
    the allocator's cached blocks back to the card, while no capture is
    underway in the process."""
    with _capturing:
        gc.collect()
        torch.cuda.empty_cache()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's capture stream on ``device``. One thread's
    captures follow one another, so they share it, and the cuBLAS workspace
    bound to it, which its graphs keep (their replays run on one stream, one
    after another); captures on two threads take two streams (they take
    turns: ``_capturing``)."""
    by_device = getattr(_streams, "by_device", None)
    if by_device is None:
        by_device = _streams.by_device = {}
    if device not in by_device:
        by_device[device] = torch.cuda.Stream(device)
    return by_device[device]


class Graph:
    """One body with static inputs (the tensors it reads) and static
    outputs (the tree it returns, :attr:`outputs`).

    On a CUDA device the body runs ``warmup`` times eagerly (``WARMUP``
    unless the caller ran its own warm-ups: a kernel's first launch in the
    process checks it against its plain version, which a capture forbids;
    the libraries load and the cuBLAS handles bind), then once under capture
    on a side stream, in ``thread_local`` error mode, so the work of the
    process's other threads (another engine's prefill, with its allocations
    and synchronisations) does not abort it. One thread captures at a time.
    The capture does not wait for the device first, as ``torch.cuda.graph``
    does, and collects garbage (a closed engine's graphs and their pools)
    and empties the allocator's cache first, as that always does, only when
    less than :data:`LOW_FREE_SHARE` of the card is free: the
    graph's private pool takes new segments from the card (the allocator
    neither lends it cached blocks nor frees them while a capture is
    underway), and a graph captured while an engine serves would otherwise
    stall the engine's other threads and send their next allocations to
    ``cudaMalloc``. The collector is held off during the capture (in every
    thread: it is one switch). A failed capture
    raises: there is no eager path to fall back to. ``captured_launches`` is
    what the port's kernel wrappers recorded into the capture stream, by
    kernel, from any thread (autograd runs a backward on a thread of its
    own; :func:`build.launch_tally`); each replay runs those kernels again
    without the wrappers. A replay runs on the caller's current stream: the
    engine's threads all use the default stream, so its replays run one
    after another on the device.

    On the CPU there is nothing to capture: a replay runs the body and
    copies its outputs into the static ones (the first replay's outputs
    become them), so the outputs are overwritten as a graph's are. With
    warm-ups, the body also runs once when the graph is built, as a capture
    would follow them.
    """

    WARMUP = 2

    def __init__(self, body, device: torch.device, *, warmup: Optional[int] = None) -> None:
        self.body = body
        self.replays = 0
        self.captured_launches: dict = {}
        warmup = self.WARMUP if warmup is None else warmup
        t0 = time.perf_counter()
        if device.type == "cuda":
            # the warm-ups run on the caller's stream, in order with the
            # process's other engines there: on the capture stream they would
            # run beside those engines' replays, whose cuBLAS calls use the
            # workspace bound to that same stream
            for _ in range(warmup):
                body()
            with _capturing:
                stream = capture_stream(device)
                stream.wait_stream(torch.cuda.current_stream(device))
                self.graph = torch.cuda.CUDAGraph()
                free, total = torch.cuda.mem_get_info(device)
                if free < LOW_FREE_SHARE * total:  # collect what garbage holds first
                    release_cache()
                # a graph that the collector frees during the capture (a closed
                # engine's, in a reference cycle) destroys it with a call the
                # capture forbids, and aborts it: no collection during it
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with build.launch_tally(stream) as tally, torch.cuda.stream(stream):
                        self.graph.capture_begin(capture_error_mode="thread_local")
                        try:
                            self.outputs = body()
                        finally:
                            self.graph.capture_end()
                finally:
                    if collecting:
                        gc.enable()
            self.captured_launches = dict(tally)
        else:
            self.graph = None
            self.outputs = body() if warmup else None
        self.capture_s = time.perf_counter() - t0

    def pool_bytes(self) -> Optional[int]:
        """The device memory the graph's private pool holds: its segments in
        the allocator's snapshot (None on the CPU). A pool's size is fixed
        once its capture ends: replays allocate nothing."""
        if self.graph is None:
            return None
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def replay(self):
        """Run the body once more; returns the static outputs."""
        if self.graph is not None:
            self.graph.replay()
        elif self.outputs is None:
            self.outputs = self.body()
        else:
            tree_map(lambda s, n: s.copy_(n), self.outputs, self.body())
        self.replays += 1
        return self.outputs

    def stats(self) -> dict:
        return {
            "replays": self.replays,
            "captured_launches": dict(self.captured_launches),
            "capture_s": self.capture_s,
        }


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

    ``pool_bytes`` is the device memory the graph's private pool holds, read
    once its capture ends (None before it and on the CPU).
    """

    WARMUP = 1

    def __init__(self, body: Callable, state: dict, device) -> None:
        self.body, self.state = body, state
        self.device = torch.device(device)
        self.inputs: dict = {}
        self.eager_steps = 0
        self.pool_bytes = None
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
        self._addresses = self._state_addresses()
        try:
            self._graph = Graph(self._run_body, self.device, warmup=0)
        except RuntimeError as e:
            raise GraphError(f"the step's capture failed: {e}") from e
        self.pool_bytes = self._graph.pool_bytes()

    def stats(self) -> dict:
        """The eager warm-ups, the replays, the launches captured by kernel,
        the capture's seconds and the bytes the graph's pool holds (None on
        the CPU)."""
        out = {"eager_steps": self.eager_steps, "replays": 0, "captured_launches": {},
               "capture_s": None, "pool_bytes": self.pool_bytes}
        if self._graph is not None:
            out.update(self._graph.stats())
        return out

    def close(self) -> None:
        """Release the graph and its pool (they hold the state). The pool's
        segments stay reserved by the allocator until its cache is next
        emptied: by ``torch.cuda.empty_cache``, by a capture that finds the
        card short (:class:`Graph`), or by an allocation outside a capture
        that finds no room."""
        self._graph = None
        self.state = self.inputs = None
