"""One body captured as a CUDA graph and replayed: what the serve engine's
graphs (``serve/graphs.py``) and the trainer's step (``runtime/graph.py``)
share, the port's counterpart of the reference's ``jax.jit``.

Eager PyTorch launches every kernel of a body from Python, one at a
time. A graph is captured once, with every shape and address fixed, and its
replay launches all of them with one host call.
"""
from __future__ import annotations

import gc
import threading
import time
from typing import Optional

import torch

from .kernels import build
from .tree import tree_map

__all__ = ["Graph", "capture_stream"]

_streams = threading.local()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's capture stream on ``device``. One thread's
    captures follow one another, so they share it, and the cuBLAS workspace
    bound to it, which its graphs keep (their replays run on one stream, one
    after another); captures on two threads take two streams and may
    overlap."""
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
    and synchronisations) does not abort it. The collector is held off
    during the capture (in every thread: it is one switch). A failed capture
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
            stream = capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            self.graph = torch.cuda.CUDAGraph()
            # a graph that the collector frees during the capture (a closed
            # engine's, in a reference cycle) destroys it with a call the
            # capture forbids, and aborts it: collect first, and not during
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with build.launch_tally(stream) as tally, torch.cuda.graph(
                    self.graph, stream=stream, capture_error_mode="thread_local"
                ):
                    self.outputs = body()
            finally:
                if collecting:
                    gc.enable()
            self.captured_launches = dict(tally)
        else:
            self.graph = None
            self.outputs = body() if warmup else None
        self.capture_s = time.perf_counter() - t0

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
