"""Shared-memory arena for array edge values (DESIGN.md §11).

Large numpy/jax arrays crossing the parent↔worker boundary do not pickle
through the job pipe — the bytes go through POSIX shared memory and only a
small :class:`ArrayRef` descriptor crosses the pipe. Two segment kinds,
with different lifetimes:

* **Pooled segments** (parent → worker arguments). The parent's arena owns
  a freelist of segments bucketed by capacity; ``put`` copies the array
  into a recycled (or fresh) segment, ``recycle`` returns the segment to
  the freelist **after the job's reply arrives** — a worker reads its
  argument view zero-copy, so a segment must never be rewritten while the
  job that references it is still running. Pooled segments are unlinked
  when the arena closes (pool shutdown).

* **Ephemeral segments** (worker → parent results). The worker creates one
  segment per large result array and sends the descriptor; on receipt the
  parent copies the data out and unlinks the segment immediately. Lifetime
  is exactly send→receipt, so a result can never dangle on a segment whose
  creator died.

Attached views are only valid while the segment is: a worker body that
stows its zero-copy argument view somewhere global and reads it after the
job replied is out of contract (results are copied at encode time, so
*returning* a view is fine).

The socket transport (DESIGN.md §16) cannot share memory across hosts, so
it swaps the arena for a :class:`TransferCache` with the same duck-typed
surface (``threshold`` / ``put`` / ``get`` / ``recycle`` / ``close``):
large arrays ship inline in the frame **once**, keyed by a content hash,
and later sends of identical bytes ship only the 16-byte digest. Both
classes expose :meth:`ShmArena.stats` so pool ``stats()`` can surface
recycle/hit counters.

Doctest (same-process round trip)::

    >>> import numpy as np
    >>> from repro_torch.dist.shm_arena import ShmArena
    >>> arena = ShmArena(threshold=0)
    >>> ref = arena.put(np.arange(6, dtype=np.int32).reshape(2, 3))
    >>> int(arena.get(ref).sum())
    15
    >>> arena.recycle(ref)   # back to the freelist for the next job
    >>> arena.close()
"""
from __future__ import annotations

import hashlib
import secrets
import threading
from multiprocessing import resource_tracker, shared_memory

import numpy as np

__all__ = ["ArrayRef", "ShmArena", "CacheRef", "TransferCache", "DEFAULT_THRESHOLD"]

DEFAULT_THRESHOLD = 32 * 1024  # bytes; below this, pickle through the pipe wins


def _unregister(name: str) -> None:
    """Drop a segment from this process's resource tracker.

    ``SharedMemory`` registers every attach with the tracker, but only the
    owning side unlinks — without this, attach-only processes warn about
    "leaked" segments at shutdown (and under ``fork`` the shared tracker
    would try to double-unlink)."""
    try:  # pragma: no cover - depends on interpreter internals
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:
        pass


class ArrayRef:
    """Descriptor of an array living in a shared-memory segment."""

    __slots__ = ("name", "shape", "dtype", "nbytes", "ephemeral")

    def __init__(
        self, name: str, shape: tuple, dtype: str, nbytes: int, ephemeral: bool
    ) -> None:
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.nbytes = nbytes
        self.ephemeral = ephemeral

    def __reduce__(self):
        return (
            ArrayRef,
            (self.name, self.shape, self.dtype, self.nbytes, self.ephemeral),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kind = "ephemeral" if self.ephemeral else "pooled"
        return f"ArrayRef({self.name}, {self.shape}, {self.dtype}, {kind})"


def _bucket(nbytes: int) -> int:
    """Segment capacity for a payload: next power of two ≥ 4 KiB, so
    recycled segments fit future arrays of similar size."""
    cap = 4096
    while cap < nbytes:
        cap <<= 1
    return cap


class ShmArena:
    """Process-shared scratch space for array edge values.

    One instance lives in the parent (owning the pooled freelist); each
    worker holds an *attach-only* instance (``attach_only=True``) that
    maps segments on demand and caches the mappings — pooled segment names
    are stable across jobs, so a steady-state worker maps no new memory.

    Parameters
    ----------
    threshold:
        Minimum ``nbytes`` for an array to travel through the arena;
        smaller arrays pickle through the pipe (cheaper than a segment
        round trip).
    attach_only:
        Worker-side mode: :meth:`put` creates ephemeral (per-result)
        segments instead of pooled ones, and :meth:`close` only drops
        local mappings — the parent owns every unlink.
    max_pooled:
        Cap on *owned* pooled segments (``None`` = unbounded). Once the
        cap is reached and the matching freelist bucket is empty, ``put``
        degrades to an ephemeral segment instead of blocking or growing —
        concurrent jobs stay deadlock-free at the cost of one extra copy
        per overflow (visible as ``ephemeral_created`` in :meth:`stats`).
    """

    def __init__(
        self,
        threshold: int = DEFAULT_THRESHOLD,
        *,
        attach_only: bool = False,
        max_pooled: int | None = None,
    ) -> None:
        self.threshold = threshold
        self._attach_only = attach_only
        self._max_pooled = max_pooled
        self._lock = threading.Lock()
        self._free: dict[int, list[shared_memory.SharedMemory]] = {}
        self._owned: dict[str, shared_memory.SharedMemory] = {}  # name -> seg
        # freelist key per segment: the *requested* bucket capacity, NOT
        # seg.size — the OS may page-round the mapping (macOS: 16 KiB), and
        # a recycle keyed on the rounded size would never match a checkout
        self._caps: dict[str, int] = {}
        self._attached: dict[str, shared_memory.SharedMemory] = {}
        self._closed = False
        if not attach_only:
            # the owner's resource tracker runs before any worker forks, so
            # every worker shares it: a worker's attach then registers a
            # name the owner already holds, and must not unregister it
            resource_tracker.ensure_running()
        self._counts = {
            "pooled_created": 0,
            "pooled_reused": 0,
            "pooled_recycled": 0,
            "ephemeral_created": 0,
            "ephemeral_unlinked": 0,
        }

    # -- write side -----------------------------------------------------------

    def put(self, array: np.ndarray) -> ArrayRef:
        """Copy ``array`` into a segment; returns the descriptor to ship.

        Parent side: a pooled segment (recycled via :meth:`recycle` once
        the referencing job completes). Worker side: a fresh ephemeral
        segment the parent will unlink on receipt.
        """
        arr = np.ascontiguousarray(array)
        seg = None if self._attach_only else self._checkout(_bucket(arr.nbytes))
        if seg is None:
            # worker side, or pooled capacity exhausted (max_pooled):
            # one-shot segment, unlinked by the receiving get()
            seg = shared_memory.SharedMemory(
                create=True, size=max(1, arr.nbytes), name=f"repro_r_{secrets.token_hex(8)}"
            )
            with self._lock:
                self._counts["ephemeral_created"] += 1
            ephemeral = True
        else:
            ephemeral = False
        view = np.ndarray(arr.shape, dtype=arr.dtype, buffer=seg.buf)
        view[...] = arr
        ref = ArrayRef(seg.name, tuple(arr.shape), str(arr.dtype), arr.nbytes, ephemeral)
        if ephemeral:
            # local mapping no longer needed; the parent copies + unlinks
            seg.close()
            _unregister(seg.name)
        return ref

    def _checkout(self, cap: int) -> shared_memory.SharedMemory | None:
        """A free or fresh pooled segment, or ``None`` at the ``max_pooled``
        cap (the caller falls back to an ephemeral segment)."""
        with self._lock:
            free = self._free.get(cap)
            if free:
                self._counts["pooled_reused"] += 1
                return free.pop()
            if self._max_pooled is not None and len(self._owned) >= self._max_pooled:
                return None  # strict cap — checked under the same lock as creation
            seg = shared_memory.SharedMemory(
                create=True, size=cap, name=f"repro_a_{secrets.token_hex(8)}"
            )
            self._owned[seg.name] = seg
            self._caps[seg.name] = cap
            self._counts["pooled_created"] += 1
        return seg

    def recycle(self, ref: ArrayRef) -> None:
        """Release a segment whose job is over: pooled refs go back to the
        freelist (the next job may rewrite them immediately — the caller
        guarantees the referencing job has replied); ephemeral refs are
        unlinked on the spot. The ephemeral case is the *failed-send*
        path: a result pack that never reached the parent would otherwise
        strand its ``repro_r_*`` segments until reboot (``get`` is the
        delivery-side release).
        """
        if ref.ephemeral:
            try:
                seg = shared_memory.SharedMemory(name=ref.name)
            except FileNotFoundError:  # already delivered + unlinked
                return
            try:
                seg.unlink()
            except Exception:
                pass
            seg.close()
            with self._lock:
                self._counts["ephemeral_unlinked"] += 1
            return
        with self._lock:
            seg = self._owned.get(ref.name)
            if seg is not None:
                self._free.setdefault(self._caps[ref.name], []).append(seg)
                self._counts["pooled_recycled"] += 1

    # -- read side ------------------------------------------------------------

    def get(self, ref: ArrayRef) -> np.ndarray:
        """Materialize an array from its descriptor.

        Pooled refs return a **zero-copy read view** (valid until the job
        replies); ephemeral refs are copied out and their segment unlinked
        on the spot (the receipt that ends the result's shm lifetime).
        """
        if ref.ephemeral:
            seg = shared_memory.SharedMemory(name=ref.name)
            try:
                view = np.ndarray(ref.shape, dtype=np.dtype(ref.dtype), buffer=seg.buf)
                out = np.array(view)  # own the bytes before the segment dies
            finally:
                try:
                    seg.unlink()  # receipt ends the result's shm lifetime
                except Exception:
                    pass
                seg.close()
            with self._lock:
                self._counts["ephemeral_unlinked"] += 1
            return out
        seg = self._attached.get(ref.name)
        if seg is None:
            seg = self._owned.get(ref.name)
        if seg is None:
            seg = shared_memory.SharedMemory(name=ref.name)  # the owner unlinks it
            with self._lock:
                self._attached[ref.name] = seg
        return np.ndarray(ref.shape, dtype=np.dtype(ref.dtype), buffer=seg.buf)

    # -- introspection ----------------------------------------------------------

    def stats(self) -> dict:
        """Segment-lifecycle counters (all monotonic except the gauges).

        Keys: ``pooled_created`` / ``pooled_reused`` / ``pooled_recycled``
        (freelist round trips), ``ephemeral_created`` / ``ephemeral_unlinked``
        (one-shot segments — worker results and ``max_pooled`` overflow),
        plus gauges ``pooled_segments`` (owned) and ``free_segments``
        (currently idle in the freelist).
        """
        with self._lock:
            out = dict(self._counts)
            out["pooled_segments"] = len(self._owned)
            out["free_segments"] = sum(len(v) for v in self._free.values())
        return out

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Drop mappings; the owning side also unlinks its pooled segments."""
        if self._closed:
            return
        self._closed = True
        for seg in self._attached.values():
            try:
                seg.close()
            except Exception:
                pass
        self._attached.clear()
        for seg in self._owned.values():
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass
        self._owned.clear()
        self._caps.clear()
        self._free.clear()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class CacheRef:
    """Descriptor of an array travelling the socket transport (§16).

    ``data`` carries the raw bytes exactly once — the first time a given
    content digest crosses a connection; repeats ship ``data=None`` and
    the receiver resolves the digest from its side of the
    :class:`TransferCache`.
    """

    __slots__ = ("digest", "shape", "dtype", "nbytes", "data")

    def __init__(
        self, digest: str, shape: tuple, dtype: str, nbytes: int, data: bytes | None
    ) -> None:
        self.digest = digest
        self.shape = shape
        self.dtype = dtype
        self.nbytes = nbytes
        self.data = data

    def __reduce__(self):
        return (CacheRef, (self.digest, self.shape, self.dtype, self.nbytes, self.data))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kind = "inline" if self.data is not None else "cached"
        return f"CacheRef({self.digest[:8]}, {self.shape}, {self.dtype}, {kind})"


class TransferCache:
    """Per-connection content-addressed stand-in for :class:`ShmArena`.

    Shared memory cannot cross hosts, so the socket transport ships large
    arrays inline in the job frame — but only the first time. ``put``
    hashes the bytes (+ dtype + shape) with ``blake2b`` and, when the
    digest was already sent over this connection, returns a
    :class:`CacheRef` carrying just the digest; the peer's ``get``
    resolves it from the bytes it stored at first receipt. In-order
    framing guarantees the data-carrying frame lands before any
    digest-only reference to it.

    Lifetime is the connection's: each (re)connected worker gets a fresh
    cache on both ends, so a respawn can never resolve a digest the new
    peer does not hold. Entries are never evicted — the cache lives
    exactly as long as its connection, and workloads re-sending the same
    large arrays are the point of the cache. ``recycle`` (the
    ``wire.py`` partial-failure hook) un-marks a digest whose inline
    frame was never delivered; delivered refs are *not* recycled (that
    would defeat the cache — the asymmetry with :meth:`ShmArena.recycle`
    is deliberate).

    Doctest (both ends of one connection)::

        >>> import numpy as np
        >>> from repro_torch.dist.shm_arena import TransferCache
        >>> tx, rx = TransferCache(threshold=0), TransferCache(threshold=0)
        >>> a = np.arange(6, dtype=np.int32)
        >>> first = tx.put(a)          # bytes ride the frame
        >>> first.data is None
        False
        >>> again = tx.put(a)          # digest only
        >>> again.data is None
        True
        >>> int(rx.get(first).sum()), int(rx.get(again).sum())
        (15, 15)
        >>> tx.stats()["hits"], tx.stats()["misses"]
        (1, 1)
    """

    def __init__(self, threshold: int = DEFAULT_THRESHOLD) -> None:
        self.threshold = threshold
        self._lock = threading.Lock()
        self._sent: set[str] = set()  # digests the peer holds
        self._recv: dict[str, bytes] = {}  # digest -> bytes this side holds
        self._hits = 0
        self._misses = 0

    @staticmethod
    def _digest(data: bytes, dtype: str, shape: tuple) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(dtype.encode())
        h.update(repr(shape).encode())
        h.update(data)
        return h.hexdigest()

    def put(self, array: np.ndarray) -> CacheRef:
        """Encode ``array`` for the frame: inline bytes on first sight of
        this content, digest-only afterwards."""
        arr = np.ascontiguousarray(array)
        data = arr.tobytes()
        digest = self._digest(data, str(arr.dtype), tuple(arr.shape))
        with self._lock:
            if digest in self._sent:
                self._hits += 1
                return CacheRef(digest, tuple(arr.shape), str(arr.dtype), arr.nbytes, None)
            self._sent.add(digest)
            self._misses += 1
        return CacheRef(digest, tuple(arr.shape), str(arr.dtype), arr.nbytes, data)

    def get(self, ref: CacheRef) -> np.ndarray:
        """Materialize an array from its descriptor, remembering inline
        bytes for future digest-only refs. Always returns a fresh
        writable array (no zero-copy views — nothing shares the buffer)."""
        if ref.data is not None:
            with self._lock:
                self._recv[ref.digest] = ref.data
            buf = ref.data
        else:
            with self._lock:
                buf = self._recv.get(ref.digest)
            if buf is None:
                raise KeyError(
                    f"transfer cache has no bytes for digest {ref.digest!r} — "
                    "a digest-only ref arrived before (or without) its inline frame"
                )
        return np.frombuffer(buf, dtype=np.dtype(ref.dtype)).reshape(ref.shape).copy()

    def recycle(self, ref: CacheRef) -> None:
        """Forget an *undelivered* inline ref (``wire.py`` calls this when
        a multi-arg encode fails partway): its digest was optimistically
        marked sent at ``put`` time but the frame never went out, so the
        mark must not satisfy a future ``put``. Digest-only refs and
        delivered refs are no-ops."""
        if ref.data is not None:
            with self._lock:
                self._sent.discard(ref.digest)

    def stats(self) -> dict:
        """Cache effectiveness counters: ``hits`` (arrays sent as digest
        only), ``misses`` (arrays shipped inline), and the live entry
        gauges ``sent_digests`` / ``recv_digests``."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "sent_digests": len(self._sent),
                "recv_digests": len(self._recv),
            }

    def close(self) -> None:
        with self._lock:
            self._sent.clear()
            self._recv.clear()
