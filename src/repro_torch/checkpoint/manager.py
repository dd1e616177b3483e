"""Sharded, async, atomic checkpointing built on the paper's thread pool.

Ported from the reference's ``repro/checkpoint/manager.py`` onto the port's
own ``core`` copy, with the same save graph, template replay, retries,
``wait`` semantics and on-disk format:

    step_000042.tmp/            (written)
        manifest.json           {leaves: {key: {file, shape, dtype}}, meta}
        <leaf-path>.bin         raw little-endian bytes per leaf
    step_000042/                (atomic rename on commit)

Leaf keys are the tree's dict keys (sorted) and list indices joined by
``.``, as the reference names them. A bfloat16 leaf is written as its
16-bit patterns under the dtype string ``"bfloat16"`` and read back through
an int16 view, without ``ml_dtypes``, so a directory written by either
package loads in the other. Trees are nested dicts and lists whose leaves
are torch tensors (any device) or numpy arrays; restore gives torch
tensors on an explicit ``device`` (``cuda:0`` unless the caller passes
another).

Sharded leaves are DTensors: the save gathers each whole (a collective, in
the synchronous snapshot on the caller's thread, so it never meets the
step's collectives on another thread) and the directory holds whole arrays,
as the reference's does. Under a mesh every rank saves and one writes
(``writer``): the others join each leaf's gather and keep no host copy.
``restore(like, shardings=)`` lays each leaf out by its
:class:`~repro_torch.parallel.sharding.NamedSharding` on whatever mesh the
caller gives (elastic restore), as a DTensor of this rank's block.

Async saves run as a *dataflow* task graph on the work-stealing pool,
submitted through the :class:`~repro_torch.core.Executor` facade. The
per-leaf shard writers are a **dynamic subflow** (DESIGN.md §10): a single
``takes_runtime`` task spawns one writer per leaf *from inside the worker*,
sized by the actual leaf count of the tree being saved, and each writer
*returns* its manifest entry; the commit task receives them as a value:

    prepare -> shard{ w:leaf... -> entries }::join -> commit(+gc)

so serialization and IO overlap training. The device-to-host snapshot
runs in ``save_async`` on the caller's thread, so on the process and socket
backends the writers in the worker processes see host arrays only and
never touch the device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core import Executor, RetryPolicy, Runtime, TaskGraph, ThreadPool
from ..models.common import resolve_device
from ..tree import tree_flatten_with_keys, tree_unflatten

_SEP = "."


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as host bytes and its manifest dtype string. bfloat16 has no
    numpy dtype: its bits go out as int16, named "bfloat16". A DTensor is
    gathered whole first."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {k: _host(leaf) for k, leaf in tree_flatten_with_keys(tree, _SEP)}


def _join_gathers(tree: Any) -> None:
    """This rank's part in gathering every DTensor leaf of ``tree`` for the
    writer, one leaf at a time, keeping nothing (a rank that does not
    write)."""
    for _, leaf in tree_flatten_with_keys(tree, _SEP):
        if hasattr(leaf, "full_tensor"):
            leaf.detach().full_tensor()


def _le_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes()


def _entry(fname: str, arr: np.ndarray, dtype: str) -> dict:
    return {"file": fname, "shape": list(arr.shape), "dtype": dtype}


def save_pytree(tree: Any, directory: str | pathlib.Path, *, meta: Optional[dict] = None) -> None:
    """Synchronous atomic save (the async manager decomposes the same steps)."""
    directory = pathlib.Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: dict[str, Any] = {"leaves": {}, "meta": meta or {}}
    for key, (arr, dtype) in _flatten(tree).items():
        fname = key.replace("/", "_") + ".bin"
        (tmp / fname).write_bytes(_le_bytes(arr))
        manifest["leaves"][key] = _entry(fname, arr, dtype)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    tmp.rename(directory)  # commit point


def _read_leaf(directory: pathlib.Path, info: dict, device) -> torch.Tensor:
    raw = bytearray((directory / info["file"]).read_bytes())
    if info["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype="<i2").reshape(info["shape"])
        return torch.from_numpy(arr).view(torch.bfloat16).to(device)
    arr = np.frombuffer(raw, dtype=np.dtype(info["dtype"]).newbyteorder("<")).reshape(info["shape"])
    return torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=False)).to(device)


def load_pytree(directory: str | pathlib.Path, like: Any, *, device=None,
                shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (its leaves name the keys to
    read; their values are not used), every leaf a tensor on ``device``:
    the caller's, else ``cuda:0``, raising without a GPU. ``shardings``
    (a tree like ``like`` of ``NamedSharding`` or None) re-shards a leaf
    onto its mesh: a DTensor holding this rank's block."""
    device = resolve_device(device)
    directory = pathlib.Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    keys = [k for k, _ in tree_flatten_with_keys(like, _SEP)]
    if shardings is None:
        flat = [None] * len(keys)
    else:
        from torch.distributed.tensor import distribute_tensor

        flat = [sh for _, sh in tree_flatten_with_keys(shardings, _SEP)]
        if len(flat) != len(keys):
            raise ValueError(f"{len(flat)} shardings for {len(keys)} leaves")
    leaves = []
    for k, sh in zip(keys, flat):
        t = _read_leaf(directory, manifest["leaves"][k], device)
        # every rank read the whole array: each keeps its block, no scatter,
        # one leaf whole at a time
        leaves.append(t if sh is None else distribute_tensor(t, sh.mesh, sh.placements(),
                                                             src_data_rank=None))
    return tree_unflatten(like, leaves)


class CheckpointManager:
    """Async checkpoints with atomic commit, keep-k GC and resume.

    ``backend`` selects the execution backend for an owned pool (the
    :class:`~repro_torch.core.Executor` switch: ``"thread"``,
    ``"process"``, ``"socket"`` or ``"serial"``; ignored when ``pool`` is
    given).

    The save graph's *shape* is save-invariant (prepare → shard →
    commit; the per-leaf writers are runtime-sized by the spawner), so
    the manager builds it once and feeds each save's payload through a
    slot dict the task bodies read at run time. Sequential saves then
    replay the captured :class:`~repro_torch.core.ReplayPlan` (DESIGN.md §12)
    instead of building + wiring a fresh graph per step. Overlapping
    saves keep their old semantics: while the template graph is still
    draining a save, the next one runs on a disposable one-off graph.

    ``saves`` records each committed save: its ``step``, ``bytes`` (the
    leaves' payload), ``snapshot_s`` (the device-to-host copy inside
    ``save_async``) and ``seconds`` (``save_async`` called to commit done).
    """

    def __init__(
        self,
        root: str | pathlib.Path,
        *,
        pool: Optional[ThreadPool] = None,
        backend: Optional[str] = None,
        keep: int = 3,
        write_retries: int = 2,
        writer: bool = True,
    ) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        if pool is not None and backend is not None:
            # same contract as Executor: never silently ignore backend=
            raise ValueError("pass either backend= or pool=, not both")
        if pool is not None:
            self.pool = pool
            self._own_pool = False
            self._exec = Executor(pool=self.pool)
        else:
            self._exec = Executor(2, backend=backend, name="ckpt")
            self.pool = self._exec.pool
            self._own_pool = True
        self.keep = keep
        # False on every rank of a mesh but one: it gathers, writes nothing
        self.writer = writer
        # §14: shard writes are idempotent (same bytes, same file), so
        # transient IO failures retry with a short backoff before the save
        # graph surfaces the error
        self._write_retry = (
            RetryPolicy(max_attempts=1 + write_retries, backoff=0.01, retry_on=OSError)
            if write_retries > 0
            else None
        )
        self._pending: list = []
        self.saves: list[dict] = []
        # §12 steady-state template: one cached save graph, replayed per
        # save; the payload slots are what each pass's bodies read.
        self._tpl_graph: Optional[TaskGraph] = None
        self._tpl_state: dict[str, Any] = {}
        self._tpl_busy: Optional[Any] = None  # run future of the template's save

    # -- save -----------------------------------------------------------------

    def save_async(self, step: int, tree: Any, *, meta: Optional[dict] = None) -> None:
        """Snapshot NOW (device->host, blocking only for the copy), then
        serialize + write + commit + gc in the background as a task graph."""
        t0 = time.perf_counter()
        if not self.writer:
            _join_gathers(tree)
            return
        flat = _flatten(tree)
        # unique tmp per save: concurrent saves of the same step (or a crashed
        # writer's leftovers) can never corrupt each other; commit is a rename
        payload = {
            "flat": flat,
            "directory": self.root / f"step_{step:08d}",
            "tmp": self.root
            / f"step_{step:08d}.tmp{id(tree) & 0xffff:x}{int(time.time() * 1e3) & 0xffff:x}",
            "meta": meta or {},
            "step": step,
            "t0": t0,
            "snapshot_s": time.perf_counter() - t0,
        }
        self._pending.append(self._run_save(payload))

    def _run_save(self, payload: dict) -> Any:
        """Route a save through the cached template graph when it is idle
        (replayed from the second save on), or a disposable graph when an
        earlier save is still draining the template."""
        if self._tpl_graph is None:
            self._tpl_state = dict(payload)
            self._tpl_graph = self._build_save_graph(self._tpl_state)
            self._tpl_busy = fut = self._exec.run(self._tpl_graph)
            return fut
        busy = self._tpl_busy
        if busy is None or busy.done():
            self._tpl_state.clear()
            self._tpl_state.update(payload)
            self._tpl_busy = fut = self._exec.run(self._tpl_graph)
            return fut
        return self._exec.run(self._build_save_graph(dict(payload)))

    def _build_save_graph(self, state: dict) -> TaskGraph:
        """prepare -> shard{ v:leaf -> w:leaf ... }::join -> commit(+gc),
        with every save-specific value read from ``state`` at run time so
        the same graph object serves save after save."""

        def prepare():
            tmp = state["tmp"]
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

        def write_leaf(tmp: pathlib.Path, key: str, leaf: tuple) -> tuple[str, dict]:
            arr, dtype = leaf
            fname = key.replace("/", "_") + ".bin"
            (tmp / fname).write_bytes(_le_bytes(arr))
            return key, _entry(fname, arr, dtype)

        # Shard writers as a dynamic subflow (DESIGN.md §10): one writer
        # per leaf, spawned inside the worker and sized by the leaf count
        # of THIS pass's tree — the runtime sizing is exactly what lets a
        # replayed pass (§12) save a differently-shaped tree through the
        # same plan. Each leaf array reaches its writer along a dataflow
        # edge from a pinned-local value task — on the process backend
        # that routes the bytes through the §11 shared-memory arena
        # instead of pickling them into the writer's wire (and keeps
        # wiring cost flat: the array itself is never serialized with the
        # function).
        def shard(rt: Runtime):
            tmp = state["tmp"]
            writers = []
            for key, arr in state["flat"].items():
                val = rt.add(lambda a=arr: a, name=f"v:{key[:24]}", affinity="local")
                w = rt.then(
                    val,
                    lambda a, k=key, t=tmp: write_leaf(t, k, a),
                    name=f"w:{key[:24]}",
                )
                w.retry_policy = self._write_retry
                w.idempotent = True  # rewriting the same bytes is safe
                writers.append(w)
            return rt.gather(writers, name="entries")

        def commit(entries: list) -> None:
            # the spawner's value IS the gathered entry list: the join
            # unwrapped the subflow task the body returned (DESIGN.md §10)
            tmp, directory = state["tmp"], state["directory"]
            manifest = {
                "leaves": dict(entries),
                "meta": {**state["meta"], "step": state["step"]},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if directory.exists():
                shutil.rmtree(directory)
            try:
                tmp.rename(directory)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # lost a same-step race
            self._gc()
            self.saves.append({
                "step": state["step"],
                "bytes": sum(arr.nbytes for arr, _ in state["flat"].values()),
                "snapshot_s": state["snapshot_s"],
                "seconds": time.perf_counter() - state["t0"],
            })

        g = TaskGraph("ckpt-save")
        prep = g.add(prepare, name="prepare")
        shard_t = g.add(shard, name="shard", takes_runtime=True)
        shard_t.after(prep)
        g.then(shard_t, commit, name="commit")
        return g

    def wait(self, timeout: float = 600.0) -> None:
        """Block until every save queued by *this manager* has committed.

        Waits on the per-save run futures, not pool-wide quiescence — on a
        shared pool, other residents (e.g. §10 prefetch lanes looping
        inside the workers) must not fail a wait whose saves are already
        durable. Raises :class:`TimeoutError` instead of proceeding on an
        unfinished save (§10 satellite): a caller that treats "wait
        returned" as "checkpoint durable" must never be lied to by a
        silent timeout. A save that *failed* re-raises its error here;
        unfinished saves stay tracked for a retried wait.
        """
        deadline = time.monotonic() + timeout
        pending, self._pending = self._pending, []
        for i, fut in enumerate(pending):
            try:
                fut.result(max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                if not fut.done():  # genuinely still running: keep tracking
                    self._pending = pending[i:] + self._pending
                    raise TimeoutError(
                        f"checkpoint saves still in flight after {timeout}s"
                    ) from None
                # resolved while we timed out: take the save's own verdict —
                # a commit that landed microseconds late is still durable
                try:
                    fut.result(0)
                except BaseException:
                    self._pending = pending[i + 1 :] + self._pending
                    raise
            except BaseException:
                self._pending = pending[i + 1 :] + self._pending
                raise

    # -- restore ---------------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1].split(".")[0])
            for p in self.root.glob("step_*")
            if p.is_dir() and ".tmp" not in p.name and (p / "manifest.json").exists()
        )

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(
        self, like: Any, *, step: Optional[int] = None, device=None, shardings: Any = None
    ) -> tuple[Any, dict]:
        """The tree saved at ``step`` (default: the latest) in the structure
        of ``like``, on ``device`` (``cuda:0`` unless given), and its meta;
        ``shardings`` lays leaves out on a mesh (:func:`load_pytree`)."""
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        directory = self.root / f"step_{step:08d}"
        manifest = json.loads((directory / "manifest.json").read_text())
        tree = load_pytree(directory, like, device=device, shardings=shardings)
        return tree, manifest["meta"]

    # -- internals ----------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def close(self) -> None:
        try:
            self.wait(60)
        finally:
            if self._own_pool:
                self.pool.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
