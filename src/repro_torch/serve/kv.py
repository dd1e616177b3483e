"""Slot and paged KV-cache pools for continuous batching, ported from the
reference's ``repro/serve/kv.py`` (DESIGN.md §7, §13).

The host-side accounting — free lists, the zero page 0 and scratch page 1,
page tables, ``tick_inputs``, ``stats`` — carries over line for line. The
pools are device tensors updated in place (the reference rebuilds them in
donated jits), bound once and never re-bound, since the engine's decode
graph (``serve/graphs.py``) holds their addresses; ``write`` and the decode
tick mutate them and must be serialized by the caller, which the engine's
tick chain does.

Cache kinds, by leaf signature:

* ``{"k", "v"}``            GQA append cache — pad along the seq axis.
* ``{"k", "v", "pos"}``     sliding-window ring — fixed modulus ``W``; a
                            smaller prefill ring is re-laid-out into the
                            target ring by the ``slot = pos % W`` invariant.
                            ``pos`` keeps one row per lane, ``(..., B, W)``.
                            Where the window reaches ``max_len`` the slots
                            keep plain K/V, and a prefill's ring (in order,
                            as its prompt is no longer than the window) is
                            written as plain K/V (:func:`drop_rings`).
* ``{"ckv", "krope"}``      MLA compressed latents — pad along seq.
* anything else             fixed size (SSM state, static encoder K/V) —
                            pass through.

A cache pool's tree is *slot-major*: every leaf is ``(max_slots,
*leaf_b1)`` with ``leaf_b1`` the model's batch-1 cache shape. The model's
decode step takes lanes on its batch axis instead; :func:`lane_view` turns
one into the other without a copy.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_map

# ---------------------------------------------------------------------------
# per-family cache walks
# ---------------------------------------------------------------------------


def _is_gqa(node: Any) -> bool:
    return isinstance(node, dict) and "k" in node and "v" in node


def _is_mla(node: Any) -> bool:
    return isinstance(node, dict) and "ckv" in node


def _pad_seq(arr: torch.Tensor, axis: int, extra: int) -> torch.Tensor:
    shape = list(arr.shape)
    shape[axis] = extra
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _scatter_seq(
    dst: torch.Tensor, src: torch.Tensor, idx: torch.Tensor, axis: int
) -> torch.Tensor:
    """``dst`` with ``src`` scattered at positions ``idx`` along ``axis``."""
    dst.movedim(axis, 0)[idx] = src.movedim(axis, 0)
    return dst


def _grow_ring(node: dict, target_w: int) -> dict:
    """Re-lay a ring cache of modulus ``W0`` into modulus ``target_w``.

    The ring invariant is "absolute position p lives at slot p % W". A
    prefill over a prompt shorter than the window returns a ring of modulus
    ``W0 = S < W``; re-scatter each entry to ``pos % W`` and mark empty
    slots with pos = -1 (masked in decode). The stored positions are a
    contiguous run of length W0 <= W, hence distinct mod W.
    """
    pos = node["pos"]
    w0 = pos.shape[-1]
    if w0 == target_w:
        return node
    if w0 > target_w:
        raise ValueError(f"ring cache modulus {w0} exceeds slot capacity {target_w}")
    # positions are identical across any stacked (layers) prefix and lanes
    flat_pos = pos.reshape(-1, w0)[0].long()
    idx = torch.remainder(flat_pos, target_w)
    out = {}
    for key in ("k", "v"):
        arr = node[key]
        ax = arr.ndim - 3  # (..., B, W, KV, Dh)
        shape = list(arr.shape)
        shape[ax] = target_w
        out[key] = _scatter_seq(arr.new_zeros(shape), arr, idx, ax)
    dst_pos = torch.full((*pos.shape[:-1], target_w), -1, dtype=pos.dtype, device=pos.device)
    out["pos"] = _scatter_seq(dst_pos, pos, idx, pos.ndim - 1)
    return out


def pad_caches_to(caches: dict, extra: int, *, ring_w: Optional[int] = None) -> dict:
    """Grow every growable cache leaf by ``extra`` positions.

    Attention K/V and MLA latents are zero-padded along their sequence axis;
    ring buffers are re-laid to modulus ``ring_w`` when given (else passed
    through); fixed-size leaves pass through untouched. Handles
    layer-stacked leaves (leading layers dim).
    """

    def walk(node):
        if _is_gqa(node):
            if "pos" in node:  # ring buffer: fixed modulus
                return _grow_ring(node, ring_w) if ring_w is not None else node
            ax = node["k"].ndim - 3  # (..., B, S, KV, Dh): seq axis
            return {"k": _pad_seq(node["k"], ax, extra), "v": _pad_seq(node["v"], ax, extra)}
        if _is_mla(node):
            ax = node["ckv"].ndim - 2  # (..., B, S, L): seq axis
            return {
                "ckv": _pad_seq(node["ckv"], ax, extra),
                "krope": _pad_seq(node["krope"], ax, extra),
            }
        if isinstance(node, dict):
            # cross-attn caches hold static encoder K/V: never grown
            return {k: (v if k == "cross" else walk(v)) for k, v in node.items()}
        return node

    return walk(caches)


def drop_rings(caches: dict) -> dict:
    """A prefill cache's ring leaves as plain K/V, for a slot layout that
    keeps no ring (the window reaches ``max_len``: ``block_cache_shape``).

    A prefill of ``S <= max_len <= window`` tokens returns a ring of
    modulus ``S`` whose slot ``p % S = p`` holds position ``p``: its rows
    are already in position order, so dropping ``pos`` leaves the plain
    cache the slot layout expects.
    """

    def walk(node):
        if _is_gqa(node) and "pos" in node:
            return {"k": node["k"], "v": node["v"]}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(caches)


def _ring_modulus(node: Any, acc: list) -> None:
    if _is_gqa(node) and "pos" in node:
        acc.append(node["pos"].shape[-1])
    elif isinstance(node, dict):
        for v in node.values():
            _ring_modulus(v, acc)


def ring_modulus(caches: dict) -> Optional[int]:
    """Modulus of the sliding-window ring leaves, or None if there are none."""
    acc: list = []
    _ring_modulus(caches, acc)
    return acc[0] if acc else None


def _is_ssm(node: Any) -> bool:
    return isinstance(node, dict) and "conv" in node and "state" in node


# the batch axis of a model cache leaf, counted from its end
_BATCH_AX_FROM_END = {"k": 4, "v": 4, "pos": 2, "ckv": 3, "krope": 3, "conv": 3, "state": 4}


def lane_view(caches: dict) -> dict:
    """The model's decode layout of a slot-major cache tree, as views.

    A slot-major leaf ``(slots, ..., 1, *rest)`` becomes ``(..., slots,
    *rest)``: the slot axis takes the place of the batch-1 axis. That
    covers GQA K/V ``(S, KV, Dh)`` and ring positions ``(W,)``, MLA's
    latents ``(S, kv_lora)`` and ``(S, rope)``, and the SSM's conv window
    ``(K-1, C)`` and state ``(H, P, N)``, with or without a leading layers
    axis. Writes through the views land in the slot-major tensors.
    """

    def walk(node):
        if _is_gqa(node) or _is_mla(node) or _is_ssm(node):
            out = {}
            for key, leaf in node.items():
                b_ax = leaf.ndim - _BATCH_AX_FROM_END[key]
                out[key] = leaf.squeeze(b_ax).movedim(0, b_ax - 1)
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        raise NotImplementedError(f"lane_view: no cache kind holds a bare leaf {type(node)}")

    return walk(caches)


# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------


class SlotKVCache:
    """A pool of ``max_slots`` per-sequence caches sharing one buffer tree.

    Every leaf of ``buffers`` has shape ``(max_slots, *leaf_b1)`` where
    ``leaf_b1`` is the model's batch-1 cache shape at length ``max_len``
    (from ``model.cache_shapes(1, max_len)``). Allocation is a free-list;
    ``write`` pads a freshly prefilled batch-1 cache out to ``max_len`` and
    overwrites one slot in place.

    Thread safety: alloc/free/evict are lock-protected; ``write`` and the
    engine's decode tick mutate ``buffers`` and must be serialized by the
    caller (the engine's tick chain does this).
    """

    def __init__(self, model, max_slots: int, max_len: int) -> None:
        if max_slots < 1 or max_len < 1:
            raise ValueError("max_slots and max_len must be >= 1")
        self.max_slots = max_slots
        self.max_len = max_len
        self._slot_shapes = model.cache_shapes(1, max_len)
        self._buffers = tree_map(
            lambda s: torch.zeros((max_slots, *s.shape), dtype=s.dtype, device=model.device),
            self._slot_shapes,
        )
        rings: list = []
        _ring_modulus(self._slot_shapes, rings)
        self._ring_w = rings[0] if rings else None
        self._lock = threading.Lock()
        self._free = list(range(max_slots - 1, -1, -1))  # pop() -> lowest slot
        self._live: set[int] = set()
        self.allocs = 0
        self.frees = 0
        self.evictions = 0
        self.peak_live = 0
        # tokens each live slot is provisioned to hold (written prefill +
        # decode growth intent) — powers the fragmentation stat: a flat
        # slot always reserves max_len, whatever the sequence needs
        self._target_len = [0] * max_slots

    @property
    def buffers(self) -> dict:
        """The slot-major cache tree. Bound once, at construction, and
        updated only in place: the engine's decode graph holds the leaves'
        addresses, so the attribute is read-only."""
        return self._buffers

    # -- slot lifecycle -------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._live)

    def pages_for(self, length: int) -> int:
        """Pages a sequence of ``length`` tokens needs. A flat slot is one
        indivisible max_len-sized page, so the answer is always 1."""
        return 1

    def capacity_tokens(self, slot: int) -> int:
        """Token positions currently backed by storage for ``slot``."""
        return self.max_len

    def alloc(self, npages: int = 1) -> Optional[int]:
        """Claim a slot, or None when the pool is exhausted.

        ``npages`` is accepted for interface parity with
        :class:`PagedKVCache`; a flat slot always provisions max_len.
        """
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._live.add(slot)
            self.allocs += 1
            self.peak_live = max(self.peak_live, len(self._live))
            return slot

    def grow_to(self, slot: int, length: int) -> bool:
        """Extend ``slot``'s provisioned length. Flat slots pre-provision
        max_len, so growth within capacity always succeeds."""
        if length > self.max_len:
            return False
        with self._lock:
            self._target_len[slot] = max(self._target_len[slot], length)
        return True

    def free(self, slot: int) -> None:
        """Return a slot to the pool (retired sequence)."""
        with self._lock:
            if slot not in self._live:
                raise ValueError(f"slot {slot} is not live")
            self._live.remove(slot)
            self._free.append(slot)
            self._target_len[slot] = 0
            self.frees += 1

    def evict(self, slot: int) -> None:
        """Forcibly free a live slot (capacity eviction); counted separately."""
        self.free(slot)
        with self._lock:
            self.evictions += 1

    # -- data movement --------------------------------------------------------

    def write(self, slot: int, cache: dict, prefill_len: int) -> None:
        """Install a batch-1 prefill cache (length ``prefill_len``) into ``slot``.

        Caller must hold the engine's tick serialization. The cache is
        padded/re-laid out to ``max_len`` on device.
        """
        if slot not in self._live:
            raise ValueError(f"slot {slot} is not live")
        if prefill_len > self.max_len:
            raise ValueError(f"prefill length {prefill_len} exceeds max_len {self.max_len}")
        with self._lock:
            self._target_len[slot] = max(self._target_len[slot], prefill_len)
        if self._ring_w is None:
            cache = drop_rings(cache)
        padded = pad_caches_to(cache, self.max_len - prefill_len, ring_w=self._ring_w)
        tree_map(lambda b, n: b[slot].copy_(n), self.buffers, padded)

    def read_slot(self, slot: int) -> dict:
        """The batch-1 cache tree currently stored in ``slot`` (for tests)."""
        return tree_map(lambda b: b[slot], self.buffers)

    def stats(self) -> dict:
        """Lifecycle counters plus the §13 occupancy/fragmentation pair.

        For the flat layout one slot == one max_len-sized page:
        ``page_occupancy`` is slot occupancy and ``fragmentation`` is the
        fraction of provisioned token capacity the live sequences don't
        actually need — the over-allocation the paged cache exists to
        eliminate.
        """
        with self._lock:
            live = len(self._live)
            used = sum(self._target_len[s] for s in self._live)
            cap = live * self.max_len
            return {
                "max_slots": self.max_slots,
                "live": live,
                "free": len(self._free),
                "allocs": self.allocs,
                "frees": self.frees,
                "evictions": self.evictions,
                "peak_live": self.peak_live,
                "page_size": self.max_len,
                "pages_total": self.max_slots,
                "pages_live": live,
                "pages_free": len(self._free),
                "page_occupancy": live / self.max_slots,
                "fragmentation": (1.0 - used / cap) if cap else 0.0,
            }


# ---------------------------------------------------------------------------
# paged pool (DESIGN.md §13)
# ---------------------------------------------------------------------------


class _LeafSpec:
    """Per-leaf storage classification for the paged layout.

    ``kind`` is ``"page"`` for seq-growable leaves (GQA append K/V, MLA
    latents) and ``"slot"`` for fixed-size leaves (SSM state, conv streams,
    ring K/V/pos, static cross-attention K/V). ``ax`` is the sequence axis
    inside the batch-1 slot layout for page leaves.
    """

    __slots__ = ("kind", "ax")

    def __init__(self, kind: str, ax: int = -1) -> None:
        self.kind = kind
        self.ax = ax

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_LeafSpec({self.kind!r}, ax={self.ax})"


def _leaf_specs(shapes: dict) -> Any:
    """Mirror of the :func:`pad_caches_to` walk emitting a `_LeafSpec` tree
    with the exact structure of ``shapes`` (one spec per array leaf)."""

    def walk(node, static=False):
        if isinstance(node, dict):
            if not static and _is_gqa(node) and "pos" not in node:
                ax = node["k"].ndim - 3  # (..., B, S, KV, Dh)
                return {k: _LeafSpec("page", ax) for k in node}
            if not static and _is_mla(node):
                ax = node["ckv"].ndim - 2  # (..., B, S, L)
                return {k: _LeafSpec("page", ax) for k in node}
            return {k: walk(v, static or k == "cross") for k, v in node.items()}
        return _LeafSpec("slot")

    return walk(shapes)


class PagedKVCache:
    """Block-pooled KV cache: fixed-size pages, per-slot page tables.

    Storage layout (DESIGN.md §13):

    * every *growable* cache leaf lives in a page pool of shape
      ``(RESERVED + num_pages, ..., page_size, ...)`` where the sequence
      axis of the batch-1 slot layout is replaced by ``page_size`` and the
      physical page id leads;
    * *fixed-size* leaves (SSM recurrent state, conv streams, sliding-window
      rings, static encoder K/V) keep the flat ``(max_slots, ...)`` layout —
      they never grow, so paging them buys nothing;
    * two physical pages are reserved: page 0 is the **zero page** (never
      written; every unmapped page-table entry points at it, so a gathered
      logical cache is zero-padded exactly like the flat layout — the
      bit-identity invariant), page 1 is the **scratch page** (decode
      writes from inactive batch lanes land there and are never read).

    Allocation is a free-list of physical page ids; the per-slot page table
    is a host-side ``(max_slots, pages_per_seq)`` int32 array shipped to the
    device each tick (a few hundred bytes). ``write`` installs only the
    pages a prefill actually covers; ``grow_to`` appends page ids to a table
    row; ``free`` returns the row's pages. All O(pages touched).

    ``gather`` reassembles each slot's logical cache from its pages into
    fresh tensors (unmapped tail → zero page); ``scatter`` writes back, in
    place, the single page containing each lane's write index (inactive
    lanes → scratch page).

    Thread safety matches :class:`SlotKVCache`: page/slot accounting is
    lock-protected; ``write`` and the decode tick mutate ``pools`` and must
    be serialized by the caller (the engine's tick chain does this).
    """

    ZERO_PAGE = 0
    SCRATCH_PAGE = 1
    RESERVED = 2

    def __init__(
        self,
        model,
        max_slots: int,
        max_len: int,
        *,
        page_size: int = 64,
        num_pages: Optional[int] = None,
    ) -> None:
        if max_slots < 1 or max_len < 1 or page_size < 1:
            raise ValueError("max_slots, max_len and page_size must be >= 1")
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = min(page_size, max_len)
        self.pages_per_seq = math.ceil(max_len / self.page_size)
        if num_pages is None:
            num_pages = max_slots * self.pages_per_seq
        if num_pages < self.pages_per_seq:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one full sequence "
                f"({self.pages_per_seq} pages of {self.page_size} tokens)"
            )
        self.num_pages = num_pages
        self.device = model.device

        self._slot_shapes = model.cache_shapes(1, max_len)
        self._spec_tree = _leaf_specs(self._slot_shapes)
        rings: list = []
        _ring_modulus(self._slot_shapes, rings)
        self._ring_w = rings[0] if rings else None

        ps, nphys = self.page_size, self.RESERVED + num_pages

        def make_pool(spec: _LeafSpec, s) -> torch.Tensor:
            if spec.kind == "slot":
                shape = (max_slots, *s.shape)
            else:
                shape = (nphys, *s.shape[: spec.ax], ps, *s.shape[spec.ax + 1 :])
            return torch.zeros(shape, dtype=s.dtype, device=self.device)

        self._pools = tree_map(make_pool, self._spec_tree, self._slot_shapes)

        self._lock = threading.Lock()
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._live: set[int] = set()
        self._free_pages = list(range(nphys - 1, self.RESERVED - 1, -1))
        self._table = np.zeros((max_slots, self.pages_per_seq), np.int32)
        self._npages = [0] * max_slots
        self._target_len = [0] * max_slots
        self.allocs = 0
        self.frees = 0
        self.evictions = 0
        self.peak_live = 0
        self.page_allocs = 0
        self.page_frees = 0
        self.peak_pages_live = 0

    @property
    def pools(self) -> dict:
        """The page and slot pools. Bound once, at construction, and updated
        only in place: the engine's decode graph holds the leaves'
        addresses, so the attribute is read-only."""
        return self._pools

    # -- page/slot accounting -------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_live(self) -> int:
        return len(self._live)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_live(self) -> int:
        return self.num_pages - len(self._free_pages)

    def pages_for(self, length: int) -> int:
        """Pages a sequence of ``length`` tokens needs."""
        return max(1, math.ceil(length / self.page_size))

    def capacity_tokens(self, slot: int) -> int:
        """Token positions currently backed by physical pages for ``slot``."""
        return self._npages[slot] * self.page_size

    def alloc(self, npages: int = 1) -> Optional[int]:
        """Claim a slot backed by ``npages`` pages, or None when either the
        slot pool or the page pool cannot satisfy the request."""
        if npages > self.pages_per_seq:
            return None
        with self._lock:
            if not self._free_slots or len(self._free_pages) < npages:
                return None
            slot = self._free_slots.pop()
            self._live.add(slot)
            for i in range(npages):
                self._table[slot, i] = self._free_pages.pop()
            self._npages[slot] = npages
            self.allocs += 1
            self.page_allocs += npages
            self.peak_live = max(self.peak_live, len(self._live))
            self.peak_pages_live = max(self.peak_pages_live, self.pages_live)
            return slot

    def grow_to(self, slot: int, length: int) -> bool:
        """Back ``slot`` with pages covering ``length`` tokens.

        All-or-nothing: returns False (allocating nothing) when the free
        list cannot cover the missing pages — the engine's page-pressure
        preemption path. O(pages appended).
        """
        if length > self.max_len:
            return False
        need = self.pages_for(length)
        with self._lock:
            if slot not in self._live:
                raise ValueError(f"slot {slot} is not live")
            have = self._npages[slot]
            extra = need - have
            if extra <= 0:
                self._target_len[slot] = max(self._target_len[slot], length)
                return True
            if len(self._free_pages) < extra:
                return False
            for i in range(have, need):
                self._table[slot, i] = self._free_pages.pop()
            self._npages[slot] = need
            self._target_len[slot] = max(self._target_len[slot], length)
            self.page_allocs += extra
            self.peak_pages_live = max(self.peak_pages_live, self.pages_live)
            return True

    def free(self, slot: int) -> None:
        """Return a slot and all its pages to the pools (O(pages held))."""
        with self._lock:
            if slot not in self._live:
                raise ValueError(f"slot {slot} is not live")
            self._live.remove(slot)
            self._free_slots.append(slot)
            npg = self._npages[slot]
            for i in range(npg):
                self._free_pages.append(int(self._table[slot, i]))
            self._table[slot, :] = self.ZERO_PAGE
            self._npages[slot] = 0
            self._target_len[slot] = 0
            self.page_frees += npg
            self.frees += 1

    def evict(self, slot: int) -> None:
        """Forcibly free a live slot (capacity eviction); counted separately."""
        self.free(slot)
        with self._lock:
            self.evictions += 1

    # -- data movement --------------------------------------------------------

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long, device=self.device)

    def write(self, slot: int, cache: dict, prefill_len: int) -> None:
        """Install a batch-1 prefill cache (length ``prefill_len``) into
        ``slot``'s pages. Only ``ceil(prefill_len / page_size)`` pages are
        touched; the caller must hold the engine's tick serialization."""
        if prefill_len > self.max_len:
            raise ValueError(f"prefill length {prefill_len} exceeds max_len {self.max_len}")
        npg = self.pages_for(prefill_len)
        with self._lock:
            if slot not in self._live:
                raise ValueError(f"slot {slot} is not live")
            if self._npages[slot] < npg:
                raise ValueError(
                    f"slot {slot} holds {self._npages[slot]} pages, prefill needs {npg}"
                )
            page_ids = self._index(self._table[slot, :npg])
            self._target_len[slot] = max(self._target_len[slot], prefill_len)
        ps = self.page_size
        if self._ring_w is None:
            cache = drop_rings(cache)
        grown = pad_caches_to(cache, npg * ps - prefill_len, ring_w=self._ring_w)

        def up(spec: _LeafSpec, pool: torch.Tensor, leaf: torch.Tensor) -> None:
            if spec.kind == "slot":
                pool[slot].copy_(leaf)
            else:
                pool[page_ids] = leaf.unflatten(spec.ax, (npg, ps)).movedim(spec.ax, 0)

        tree_map(up, self._spec_tree, self.pools, grown)

    def gather(self, pools, tables: torch.Tensor):
        """Reassemble the ``(max_slots, ...)`` logical cache tree from pages.

        ``tables`` is the device copy of the page table. Unmapped entries
        point at the zero page, so the result is bit-identical to the flat
        slot layout. Page leaves come back as fresh tensors; slot leaves
        are the pools themselves.
        """

        def g(spec: _LeafSpec, pool: torch.Tensor) -> torch.Tensor:
            if spec.kind == "slot":
                return pool
            pages = pool[tables].movedim(1, 1 + spec.ax)  # (slots, *pre, P, page, *post)
            return pages.flatten(1 + spec.ax, 2 + spec.ax)

        return tree_map(g, self._spec_tree, pools)

    def scatter(self, pools, updated, dest_ids: torch.Tensor, idx: torch.Tensor):
        """Write each lane's touched page back into the pools, in place.

        ``updated`` is the decoded cache tree in the logical ``(max_slots,
        ...)`` layout; a decode step only writes position ``idx[slot]``, so
        the single page containing it is taken from each lane and written to
        physical page ``dest_ids[slot]`` (the scratch page for inactive
        lanes). Fixed-size leaves are replaced wholesale.
        """
        ps = self.page_size
        lanes = torch.arange(idx.shape[0], device=idx.device)
        page_of = idx // ps

        def s(spec: _LeafSpec, pool: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
            if spec.kind == "slot":
                if upd is not pool:
                    pool.copy_(upd)
                return pool
            ax = 1 + spec.ax
            pages = upd.unflatten(ax, (-1, ps)).movedim(ax, 1)  # (slots, P, *pre, page, *post)
            pool[dest_ids] = pages[lanes, page_of]
            return pool

        return tree_map(s, self._spec_tree, pools, updated)

    def tick_inputs(self, feed: dict, tables: np.ndarray, dest: np.ndarray) -> None:
        """Fills the caller's host-side per-tick arrays (the decode graph's
        staging buffers, any integer dtype): ``tables`` ``(max_slots,
        pages_per_seq)`` with the page table and ``dest`` ``(max_slots,)``
        with each lane's destination page.

        ``feed`` maps live slot -> write index for this tick. ``dest``
        routes each lane's written page: the physical page containing the
        write index for live lanes, the scratch page for idle lanes.
        """
        with self._lock:
            tables[...] = self._table
        dest.fill(self.SCRATCH_PAGE)
        for slot, fi in feed.items():
            dest[slot] = tables[slot, fi // self.page_size]

    def read_slot(self, slot: int) -> dict:
        """The batch-1 logical cache currently mapped by ``slot`` (tests)."""
        gathered = self.gather(self.pools, self._index(self._table))
        return tree_map(lambda b: b[slot], gathered)

    def stats(self) -> dict:
        """Lifecycle counters plus §13 page-occupancy and fragmentation.

        ``page_occupancy``: fraction of the usable page pool currently
        mapped by live sequences. ``fragmentation``: fraction of the token
        capacity inside those live pages that no sequence needs (internal
        fragmentation — bounded by ``page_size - 1`` tokens per sequence,
        versus up to ``max_len - prompt`` per sequence for the flat layout).
        """
        with self._lock:
            live_pages = self.num_pages - len(self._free_pages)
            used = sum(self._target_len[s] for s in self._live)
            cap = live_pages * self.page_size
            return {
                "max_slots": self.max_slots,
                "live": len(self._live),
                "free": len(self._free_slots),
                "allocs": self.allocs,
                "frees": self.frees,
                "evictions": self.evictions,
                "peak_live": self.peak_live,
                "page_size": self.page_size,
                "pages_total": self.num_pages,
                "pages_live": live_pages,
                "pages_free": len(self._free_pages),
                "page_allocs": self.page_allocs,
                "page_frees": self.page_frees,
                "peak_pages_live": self.peak_pages_live,
                "page_occupancy": live_pages / self.num_pages,
                "fragmentation": (1.0 - used / cap) if cap else 0.0,
            }
