"""Work-stealing deques — Python adaptations of the Chase-Lev deque.

The paper (Puyda 2024, §2.1) builds its thread pool on the Chase-Lev
work-stealing deque [Chase & Lev, SPAA'05; Le et al., PPoPP'13]: each worker
owns one deque, pushes and pops at the *bottom*, and thieves steal at the
*top*. The C/C++ implementations need careful atomics and memory fences; the
paper discusses sanitizer false positives around ``std::atomic_thread_fence``
and adopts the fence-free Google Filament variant.

CPython gives us a different memory model: the GIL serializes bytecodes, so a
single ``collections.deque`` operation is atomic and sequentially consistent.
Two adaptations are provided:

* :class:`FastDeque` — the production deque. ``collections.deque`` with the
  owner operating on the right end and thieves on the left end. Under the GIL
  every operation is atomic, so this is the moral equivalent of the fence-free
  Filament implementation: no locks on any path.

* :class:`ChaseLevDeque` — a faithful *structural* port of the Chase-Lev
  ring-buffer algorithm (explicit ``top``/``bottom`` indices, growable ring).
  CPython exposes no CAS, so the single compare-and-swap that guards the
  one-element owner/thief race is replaced by a lock acquired **only** on the
  steal path and on the owner's last-element path — exactly the race the CAS
  guards in C11. The common owner push/pop path takes no lock, mirroring the
  lock-free fast path of the original.

Both classes expose ``push`` (owner, bottom), ``pop`` (owner, bottom, LIFO)
and ``steal`` (any thread, top, FIFO); ``pop``/``steal`` return :data:`EMPTY`
when nothing was taken, allowing ``None`` payloads. Chase-Lev deques are
single-producer, so non-worker submissions go through the pool's shared MPMC
inbox (a :class:`FastDeque`, whose every op is GIL-atomic) rather than into a
worker's deque — see ``pool.py``.

:class:`PriorityDeque` layers task priorities on top (DESIGN.md §3): one
inner deque per distinct priority value ("band"), scanned highest-first.
Within a band the owner still pops LIFO and thieves steal FIFO, so the
pool's policy matches the schedule simulator's ``(-priority, -recency)``
ready key exactly. Most workloads use a single band (priority 0.0), for
which there is a **single-band fast path** (DESIGN.md §9): until the first
non-zero priority is pushed, push/pop/steal devolve to the bare inner
deque — no dict lookups, no band scan. The first non-zero priority
promotes the instance to banded mode permanently.
"""
from __future__ import annotations

import threading
from collections import deque as _pydeque
from typing import Any, Callable

__all__ = ["EMPTY", "FastDeque", "ChaseLevDeque", "PriorityDeque"]


class _Empty:
    """Sentinel distinguishing 'nothing taken' from a ``None`` payload."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<EMPTY>"

    def __bool__(self) -> bool:
        return False


EMPTY = _Empty()


class FastDeque:
    """GIL-atomic work-stealing deque (the default, fence-free analogue).

    Owner pushes/pops at the right end (LIFO — depth-first execution order,
    which is what makes recursive task graphs cache-friendly); thieves steal
    at the left end (FIFO — stealing the *oldest*, typically largest, task).
    ``collections.deque.append/pop/popleft`` are each a single bytecode in
    CPython, hence atomic under the GIL, so no fences or locks are needed —
    the GIL plays the role the memory-model proofs play for the C11 code.
    """

    __slots__ = ("_q",)

    def __init__(self) -> None:
        self._q: _pydeque[Any] = _pydeque()

    def push(self, item: Any) -> None:
        """Owner-side push at the bottom (right)."""
        self._q.append(item)

    def push_external(self, item: Any) -> None:
        """Submission from a non-owner thread.

        Pushed at the *top* (left) so external work is stolen/obtained in FIFO
        order and the owner's LIFO hot path is undisturbed. Atomic under GIL.
        """
        self._q.appendleft(item)

    def pop(self) -> Any:
        """Owner-side pop at the bottom (right). Returns EMPTY if none."""
        try:
            return self._q.pop()
        except IndexError:
            return EMPTY

    def steal(self) -> Any:
        """Thief-side steal at the top (left). Returns EMPTY if none."""
        try:
            return self._q.popleft()
        except IndexError:
            return EMPTY

    def __len__(self) -> int:
        return len(self._q)


class ChaseLevDeque:
    """Structural port of the Chase-Lev growable ring-buffer deque.

    Layout follows Le et al. (PPoPP'13): ``_top`` and ``_bottom`` are
    monotonically increasing 64-bit-style indices into a power-of-two ring.
    The owner manipulates ``_bottom``; thieves advance ``_top``.

    The C11 version resolves the owner/thief race on the *last* element with a
    CAS on ``top``. CPython has no CAS, so ``_lock`` protects exactly that
    race: every steal holds it, and the owner takes it only when it observes
    ``bottom - 1 == top`` (one element left). The owner's multi-element
    push/pop path is lock-free, as in the original.
    """

    __slots__ = ("_buf", "_mask", "_top", "_bottom", "_lock")

    def __init__(self, capacity: int = 64) -> None:
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self._buf: list[Any] = [None] * capacity
        self._mask = capacity - 1
        self._top = 0
        self._bottom = 0
        self._lock = threading.Lock()

    # -- owner side ---------------------------------------------------------

    def push(self, item: Any) -> None:
        b = self._bottom
        t = self._top
        if b - t > self._mask:  # full: grow (rare; lock so thieves see a
            with self._lock:  # consistent buffer during the copy)
                self._grow()
        self._buf[b & self._mask] = item
        # Publication point. In C11 this is a release store of `bottom`;
        # under the GIL a plain store is sequentially consistent.
        self._bottom = b + 1

    def pop(self) -> Any:
        b = self._bottom - 1
        self._bottom = b  # reserve slot b (C11: relaxed store + SC fence)
        t = self._top
        if b < t:  # deque was empty
            self._bottom = t
            return EMPTY
        if b > t:  # more than one element: no race possible on slot b
            item = self._buf[b & self._mask]
            self._buf[b & self._mask] = None
            return item
        # exactly one element left: the CAS-guarded race
        with self._lock:
            t = self._top
            if t <= b:  # we won: claim it by advancing top past it
                item = self._buf[b & self._mask]
                self._buf[b & self._mask] = None
                self._top = t + 1
                self._bottom = t + 1
                return item
            self._bottom = t  # lost to a thief
            return EMPTY

    # -- thief side ----------------------------------------------------------

    def steal(self) -> Any:
        with self._lock:
            t = self._top
            if t >= self._bottom:
                return EMPTY
            item = self._buf[t & self._mask]
            self._buf[t & self._mask] = None
            self._top = t + 1
            return item

    # -- internals -----------------------------------------------------------

    def _grow(self) -> None:
        """Double the ring. Caller holds ``_lock``."""
        old, mask = self._buf, self._mask
        cap = (mask + 1) * 2
        buf = [None] * cap
        for i in range(self._top, self._bottom):
            buf[i & (cap - 1)] = old[i & mask]
        self._buf = buf
        self._mask = cap - 1

    def __len__(self) -> int:
        return max(0, self._bottom - self._top)


class PriorityDeque:
    """Priority-banded work-stealing deque with a single-band fast path.

    Items are routed to an inner deque per ``item.priority`` (items without
    the attribute land in band 0.0). ``pop``/``steal`` scan bands from the
    highest priority down; within a band the usual deque discipline applies
    (owner LIFO at the bottom, thieves FIFO at the top), reproducing the
    simulator's max-heap-on-(priority, recency) ready queue.

    **Single-band fast path (DESIGN.md §9).** Band 0.0 exists from birth
    (``_fast``) and the instance starts un-banded: while only priority 0.0
    has ever been pushed, every operation is exactly one attribute check on
    top of the bare inner deque — no dict lookup, no band scan. The first
    non-zero priority *promotes* the instance to banded mode (a one-way
    transition, taken under ``_lock``). ``_fast`` *is* band 0.0 in the
    band map, so a racing fast-path push lands in the correct band no
    matter when the promotion flag becomes visible to it.

    Concurrency: the band map only ever grows. Creating a band takes a lock;
    ``_order`` is then *replaced* (never mutated) with a freshly sorted list,
    so readers iterating a stale snapshot miss at most a band created after
    their scan began — the same transient under-observation any thief has
    against a concurrent push, and the next scan sees it. All per-band
    operations inherit the inner deque's lock-free/GIL-atomic guarantees.
    """

    __slots__ = ("_deque_cls", "_fast", "_banded", "_bands", "_order", "_lock")

    def __init__(self, deque_cls: Callable[[], Any] = None) -> None:
        self._deque_cls = deque_cls or FastDeque
        self._fast = self._deque_cls()  # band 0.0, present from birth
        self._banded = False
        self._bands: dict[float, Any] = {0.0: self._fast}
        self._order: list[float] = [0.0]  # priorities, descending
        self._lock = threading.Lock()

    @property
    def banded(self) -> bool:
        """True once a non-zero priority has promoted this instance."""
        return self._banded

    def _band(self, priority: float) -> Any:
        band = self._bands.get(priority)
        if band is None:
            with self._lock:
                band = self._bands.get(priority)
                if band is None:
                    band = self._deque_cls()
                    self._bands[priority] = band
                    self._order = sorted(self._bands, reverse=True)
                self._banded = True  # only non-0.0 priorities reach here
        return band

    def push(self, item: Any) -> None:
        """Push at the bottom of the item's priority band.

        Combined with band-scanning ``steal`` this also gives the MPMC
        inbox priority-then-FIFO ordering (higher bands drain first, arrival
        order within a band), so the external-submission path is the same
        operation.
        """
        priority = getattr(item, "priority", 0.0)
        if priority == 0.0 and not self._banded:
            self._fast.push(item)
            return
        self._band(priority).push(item)

    push_external = push

    def pop(self) -> Any:
        """Owner-side pop: highest band first, LIFO within the band."""
        if not self._banded:
            return self._fast.pop()
        for pr in self._order:
            item = self._bands[pr].pop()
            if item is not EMPTY:
                return item
        return EMPTY

    def steal(self) -> Any:
        """Thief-side steal: highest band first, FIFO within the band."""
        if not self._banded:
            return self._fast.steal()
        for pr in self._order:
            item = self._bands[pr].steal()
            if item is not EMPTY:
                return item
        return EMPTY

    def __len__(self) -> int:
        if not self._banded:
            return len(self._fast)
        # iterate the _order snapshot, not the dict: a concurrent first push
        # to a new band may grow _bands mid-iteration
        return sum(len(self._bands[p]) for p in self._order)

    def depths(self) -> dict[float, int]:
        """Per-band queue depth, highest priority first (DESIGN.md §13).

        A monitoring snapshot with the same consistency as ``__len__``:
        exact when quiesced, transiently stale against concurrent pushes.
        Empty bands are reported too — a band that existed once can refill.
        """
        if not self._banded:
            return {0.0: len(self._fast)}
        return {p: len(self._bands[p]) for p in self._order}
