"""CUDA graphs of the serve engine's decode tick and bucketed prefill: the
port's counterpart of the reference's ``jax.jit`` of the tick and of
``model.prefill`` (``repro/serve/engine.py``, built once in ``__init__``).

Eager PyTorch issues every kernel of a decode step from Python, one launch
at a time: thousands a tick, while the card idles. A graph is captured
once, with every shape fixed, and its replay issues all of them with one
host call (:class:`repro_torch.cuda_graph.Graph`). Its inputs and outputs
live at fixed addresses, so each call copies its host arrays into static
input buffers (from pinned staging on the card), replays, and reads the
static outputs.

* :class:`DecodeGraph` holds one tick: ``kv.gather`` -> ``decode_step`` ->
  ``kv.scatter`` -> argmax (the flat layout decodes ``kv.buffers`` in
  place). One graph serves an engine for its lifetime, since ``max_slots``,
  ``max_len``, ``page_size`` and the layout fix every shape.
* :class:`PrefillGraphs` holds one prefill per prompt bucket, the bucket's
  length fixed and the prompt's last position read from a device index, so
  every prompt length of a bucket shares its graph.

On the CPU there is nothing to capture: both classes run the same body
through the same static buffers, and a replay runs the body again and
copies its outputs into the static ones, so the outputs are overwritten
as a graph's are.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..cuda_graph import Graph
from ..tree import tree_leaves, tree_map
from .kv import PagedKVCache, lane_view

__all__ = ["DecodeGraph", "PrefillGraphs", "read_back"]


def read_back(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, once the device has computed it. From the card it
    is copied into pinned memory asynchronously and the thread waits on an
    event: a blocking copy (``.cpu()``) holds the stream while the device
    works through what is queued before it, and stalls every launch another
    thread makes onto the stream meanwhile (the engine's eager prefills,
    beside ticks that spend most of their time waiting for the device)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host


class _StaticInputs:
    """A graph's static int64 input buffers on the device (``device[name]``),
    each with a host staging tensor (pinned for a CUDA device, so the
    upload is asynchronous) and its numpy view (``np[name]``), which the
    caller fills before :meth:`upload`. The caller synchronises before it
    fills them again (the graphs read their outputs back)."""

    def __init__(self, device: torch.device, **specs) -> None:
        self.host, self.np, self.device = {}, {}, {}
        for name, (shape, fill) in specs.items():
            host = torch.full(shape, fill, dtype=torch.long, pin_memory=device.type == "cuda")
            self.host[name], self.np[name] = host, host.numpy()
            self.device[name] = host.to(device, copy=True)

    def upload(self) -> None:
        for name, host in self.host.items():
            self.device[name].copy_(host, non_blocking=True)


class DecodeGraph:
    """The engine's decode tick over every slot lane as one graph.

    Static inputs, int64 on the model's device: ``tok`` (max_slots, 1),
    ``idx`` (max_slots,) and, for the paged layout, ``tables`` (max_slots,
    pages_per_seq) and ``dest`` (max_slots,); static output ``next``
    (max_slots, 1). Built while no slot is live: the warm-up and capture
    runs read every lane from the zero page and write it to the scratch page
    (paged), or decode garbage into the free slots (flat, and the SSM's
    slot leaves), which a join's ``kv.write`` replaces whole and decode
    masks past each lane's valid length.
    """

    def __init__(self, model, params, kv) -> None:
        dev = model.device
        n = kv.max_slots
        self.model, self.params, self.kv = model, params, kv
        self._paged = isinstance(kv, PagedKVCache)
        shapes = {"tok": ((n, 1), 0), "idx": ((n,), 0)}
        if self._paged:
            shapes["tables"] = ((n, kv.pages_per_seq), kv.ZERO_PAGE)
            shapes["dest"] = ((n,), kv.SCRATCH_PAGE)
        self.inputs = _StaticInputs(dev, **shapes)
        self._addresses = self._pool_addresses()
        with torch.inference_mode():
            self._graph = Graph(self.body, dev)

    def _pools(self) -> dict:
        return self.kv.pools if self._paged else self.kv.buffers

    def _pool_addresses(self) -> list:
        return [t.data_ptr() for t in tree_leaves(self._pools())]

    def body(self) -> dict:
        """One tick on the static inputs (what the graph holds; run eagerly,
        it is the same tick without the graph)."""
        kv, s = self.kv, self.inputs.device
        caches = kv.gather(kv.pools, s["tables"]) if self._paged else kv.buffers
        logits, _ = self.model.decode_step(self.params, s["tok"], lane_view(caches), s["idx"])
        if self._paged:
            kv.scatter(kv.pools, caches, s["dest"], s["idx"])
        return {"next": torch.argmax(logits[:, -1], dim=-1, keepdim=True)}

    def run(self, tok_np: np.ndarray, idx_np: np.ndarray, feeds: dict) -> np.ndarray:
        """One tick: each lane's next token, ``(max_slots, 1)``. ``feeds``
        maps each live slot to its write index (:meth:`PagedKVCache.tick_inputs`)."""
        if self._pool_addresses() != self._addresses:
            raise RuntimeError("the KV pools were re-bound: the decode graph would not see them")
        h = self.inputs.np
        h["tok"][...] = tok_np
        h["idx"][...] = idx_np
        if self._paged:
            self.kv.tick_inputs(feeds, h["tables"], h["dest"])
        with torch.inference_mode():
            self.inputs.upload()
            out = self._graph.replay()["next"]
            return read_back(out).numpy().copy()  # the tick's one synchronisation

    def stats(self) -> dict:
        return self._graph.stats()


class PrefillGraphs:
    """One prefill graph per prompt bucket.

    Bucket ``b`` has static inputs ``tokens`` (1, b) and ``last_pos`` (1,)
    and returns a static cache tree and the first token. Its static outputs
    are overwritten by the next replay, so :meth:`run` clones the cache out
    and reads the first token before it lets another prompt of the bucket
    in (one lock per bucket: the prefill tasks run on several pool
    threads).
    """

    def __init__(self, model, params, buckets) -> None:
        self.model, self.params = model, params
        dev = model.device
        self._buckets: dict = {}  # bucket -> (lock, static inputs, graph)
        with torch.inference_mode():
            for b in buckets:
                inputs = _StaticInputs(dev, tokens=((1, b), 0), last_pos=((1,), b - 1))
                graph = Graph(lambda s=inputs.device: self._body(s["tokens"], s["last_pos"]),
                               dev)
                self._buckets[b] = (threading.Lock(), inputs, graph)

    def _body(self, tokens: torch.Tensor, last_pos: torch.Tensor) -> dict:
        logits, cache = self.model.prefill(self.params, {"tokens": tokens}, last_pos=last_pos)
        return {"first": torch.argmax(logits[0, -1]).reshape(1), "cache": cache}

    def run(self, tokens_np: np.ndarray, last_pos: int) -> tuple:
        """Prefill one right-padded prompt ``(1, bucket)`` whose last real
        token is at ``last_pos``: ``(cache, first_token)``, the cache a copy
        the caller owns."""
        lock, inputs, graph = self._buckets[tokens_np.shape[1]]
        with lock, torch.inference_mode():
            inputs.np["tokens"][...] = tokens_np
            inputs.np["last_pos"][0] = last_pos
            inputs.upload()
            out = graph.replay()
            cache = tree_map(torch.clone, out["cache"])
            first = int(read_back(out["first"]))  # waits for the device: the clone is done
        return cache, first

    def stats(self) -> dict:
        """Each bucket's graph, as ``prefill_<bucket>``."""
        return {f"prefill_{b}": graph.stats() for b, (_l, _i, graph) in self._buckets.items()}
