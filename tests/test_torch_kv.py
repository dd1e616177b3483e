"""The port's KV-cache pools (``repro_torch.serve.kv``): slot and page
accounting, the per-family pad walks, ring re-layout, and the bit-identity
of the paged layout with the flat one through prefill writes and a decode
tick. Mirrors ``tests/serve/test_kv.py`` on reduced tinyllama at float32;
the SSM leaves (slot-major, never paged) on reduced mamba2 and hymba."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.lm import extend_caches
from repro_torch.serve.kv import (
    PagedKVCache,
    SlotKVCache,
    drop_rings,
    lane_view,
    pad_caches_to,
    ring_modulus,
)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


def _tiny_model(**overrides):
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", **overrides)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _prefill(model, params, S, seed):
    cfg = model.cfg
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, S))
    return model.prefill(params, {"tokens": tokens})[1]


def _tick_inputs(paged, feeds):
    """The paged pool's per-tick page table and destination pages, filled
    into fresh arrays."""
    tables = np.zeros((paged.max_slots, paged.pages_per_seq), np.int64)
    dest = np.zeros((paged.max_slots,), np.int64)
    paged.tick_inputs(feeds, tables, dest)
    return tables, dest


def _leaves_equal(a, b) -> bool:
    if isinstance(a, dict):
        return all(_leaves_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# slot lifecycle
# ---------------------------------------------------------------------------


def test_alloc_free_exhaustion():
    _cfg, model, _params = _tiny_model()
    kv = SlotKVCache(model, max_slots=3, max_len=8)
    slots = [kv.alloc() for _ in range(3)]
    assert sorted(slots) == [0, 1, 2]
    assert kv.alloc() is None  # exhausted
    assert kv.num_free == 0 and kv.num_live == 3
    kv.free(1)
    assert kv.alloc() == 1  # freed slot is reused
    with pytest.raises(ValueError):
        kv.free(7)  # never allocated


def test_eviction_is_counted_and_reusable():
    _cfg, model, _params = _tiny_model()
    kv = SlotKVCache(model, max_slots=2, max_len=8)
    a = kv.alloc()
    kv.evict(a)
    assert kv.stats()["evictions"] == 1
    assert kv.alloc() == a
    assert kv.stats()["allocs"] == 2
    assert kv.stats()["peak_live"] == 1


# ---------------------------------------------------------------------------
# pad walks
# ---------------------------------------------------------------------------


def test_pad_gqa_and_passthrough():
    node = {
        "attn": {"k": torch.ones(2, 1, 4, 2, 3), "v": torch.ones(2, 1, 4, 2, 3)},
        "ssm": {"state": torch.ones(1, 2, 3, 4), "conv": torch.ones(1, 8, 4)},
        "cross": {"k": torch.ones(1, 5, 2, 3), "v": torch.ones(1, 5, 2, 3)},
    }
    out = pad_caches_to(node, 3)
    assert out["attn"]["k"].shape == (2, 1, 7, 2, 3)  # stacked seq pad
    assert torch.equal(out["attn"]["k"][:, :, 4:], torch.zeros(2, 1, 3, 2, 3))
    assert out["ssm"]["state"].shape == (1, 2, 3, 4)  # fixed-size passthrough
    assert out["cross"]["k"].shape == (1, 5, 2, 3)  # static encoder K/V


def test_pad_mla():
    node = {"attn": {"ckv": torch.ones(1, 4, 6), "krope": torch.ones(1, 4, 2)}}
    out = pad_caches_to(node, 2)
    assert out["attn"]["ckv"].shape == (1, 6, 6)
    assert out["attn"]["krope"].shape == (1, 6, 2)
    assert torch.equal(out["attn"]["ckv"][:, 4:], torch.zeros(1, 2, 6))
    assert torch.equal(out["attn"]["ckv"][:, :4], torch.ones(1, 4, 6))


def test_ring_growth_relayout():
    # ring of modulus 3 holding positions [0, 1, 2] grows to modulus 5:
    # entry at position p must land at slot p % 5, empty slots pos == -1
    k = torch.arange(3, dtype=torch.float32).reshape(1, 3, 1, 1)
    pos = torch.tensor([[0, 1, 2]], dtype=torch.int32)  # one row per lane
    node = {"attn": {"k": k, "v": k + 10, "pos": pos}}
    out = pad_caches_to(node, 0, ring_w=5)["attn"]
    assert ring_modulus({"attn": out}) == 5
    assert out["pos"].tolist() == [[0, 1, 2, -1, -1]]
    assert out["k"].ravel().tolist() == [0, 1, 2, 0, 0]
    assert out["v"].ravel().tolist() == [10, 11, 12, 0, 0]
    with pytest.raises(ValueError):
        pad_caches_to(node, 0, ring_w=2)  # shrink is invalid


def test_drop_rings_leaves_plain_kv_in_position_order():
    """A prefill ring of modulus S (S <= window) holds position p at slot p:
    without its ``pos`` it is the plain cache of those S positions, ready
    to pad; plain K/V and other leaves pass through."""
    k = torch.arange(3, dtype=torch.float32).reshape(1, 3, 1, 1)
    pos = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    node = {"s0": {"attn": {"k": k, "v": k + 10, "pos": pos},
                   "ssm": {"state": torch.ones(1, 2, 3, 4), "conv": torch.ones(1, 8, 4)}},
            "s1": {"attn": {"k": k, "v": k}}}
    out = drop_rings(node)
    assert set(out["s0"]["attn"]) == {"k", "v"} and ring_modulus(out) is None
    assert out["s0"]["attn"]["k"] is k
    assert out["s0"]["ssm"]["state"] is node["s0"]["ssm"]["state"]
    padded = pad_caches_to(out, 2)["s0"]["attn"]
    assert padded["v"].ravel().tolist() == [10, 11, 12, 0, 0]


def test_lane_view_moves_slots_onto_the_batch_axis():
    k = torch.arange(3 * 2 * 1 * 4 * 1 * 1, dtype=torch.float32).reshape(3, 2, 1, 4, 1, 1)
    pos = torch.arange(3 * 2 * 1 * 4, dtype=torch.int32).reshape(3, 2, 1, 4)
    view = lane_view({"s0": {"attn": {"k": k, "v": k, "pos": pos}}})["s0"]["attn"]
    assert view["k"].shape == (2, 3, 4, 1, 1) and view["pos"].shape == (2, 3, 4)
    assert torch.equal(view["k"][1, 2], k[2, 1, 0])
    view["k"][0, 1, 3] = -1.0  # a view: writes land in the slot-major tensor
    assert k[1, 0, 0, 3].item() == -1.0


# ---------------------------------------------------------------------------
# write/read roundtrip through a real prefill
# ---------------------------------------------------------------------------


def test_write_roundtrip_matches_prefill():
    _cfg, model, params = _tiny_model()
    S, MAX = 6, 12
    cache = _prefill(model, params, S, seed=1)
    kv = SlotKVCache(model, max_slots=2, max_len=MAX)
    slot = kv.alloc()
    kv.write(slot, cache, S)
    got = kv.read_slot(slot)["s0"]["attn"]
    for key in ("k", "v"):
        assert torch.equal(got[key][:, :, :S], cache["s0"]["attn"][key])
        assert not got[key][:, :, S:].any()  # padded with zeros


def test_write_rejects_dead_slot_and_overflow():
    _cfg, model, params = _tiny_model()
    cache = _prefill(model, params, 4, seed=0)
    kv = SlotKVCache(model, max_slots=1, max_len=8)
    with pytest.raises(ValueError):
        kv.write(0, cache, 4)  # not allocated
    slot = kv.alloc()
    with pytest.raises(ValueError):
        kv.write(slot, cache, 9)  # exceeds max_len


# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------


def test_paged_page_accounting():
    _cfg, model, _params = _tiny_model()
    kv = PagedKVCache(model, max_slots=3, max_len=24, page_size=8)
    assert kv.pages_per_seq == 3 and kv.num_pages == 9
    s = kv.alloc(kv.pages_for(5))  # 5 tokens -> 1 page
    assert kv.capacity_tokens(s) == 8 and kv.pages_live == 1
    assert kv.grow_to(s, 17)  # 3 pages
    assert kv.capacity_tokens(s) == 24
    assert not kv.grow_to(s, 25)  # beyond max_len
    t = kv.alloc(2)
    assert kv.pages_live == 5 and kv.free_pages == 4
    kv.free(t)
    assert kv.pages_live == 3 and kv.free_pages == 6
    st = kv.stats()
    assert st["page_allocs"] == 5 and st["page_frees"] == 2
    assert st["peak_pages_live"] == 5
    # pools: zero + scratch pages reserved ahead of the usable ones
    assert kv.pools["s0"]["attn"]["k"].shape == (2 + 9, 3, 1, 8, 2, 16)


def test_paged_grow_is_all_or_nothing():
    _cfg, model, _params = _tiny_model()
    kv = PagedKVCache(model, max_slots=2, max_len=16, page_size=4, num_pages=4)
    a = kv.alloc(1)
    b = kv.alloc(2)
    assert kv.free_pages == 1
    assert not kv.grow_to(a, 12)  # needs 2 more, only 1 free
    assert kv.capacity_tokens(a) == 4  # nothing was taken
    assert kv.grow_to(a, 8)
    assert kv.free_pages == 0
    kv.free(b)
    assert kv.grow_to(a, 12)  # freed pages are reusable
    assert kv.alloc(1) == b  # the slot too


def test_paged_validates_sizing():
    _cfg, model, _params = _tiny_model()
    with pytest.raises(ValueError):  # pool cannot hold one full sequence
        PagedKVCache(model, max_slots=2, max_len=16, page_size=4, num_pages=3)
    kv = PagedKVCache(model, max_slots=1, max_len=6, page_size=64)
    assert kv.page_size == 6  # clamped to max_len
    assert kv.alloc(kv.pages_per_seq + 1) is None


def test_paged_occupancy_and_fragmentation_stats():
    _cfg, model, _params = _tiny_model()
    MAX = 32
    flat = SlotKVCache(model, max_slots=2, max_len=MAX)
    paged = PagedKVCache(model, max_slots=2, max_len=MAX, page_size=8)
    for kv in (flat, paged):
        st = kv.stats()
        assert st["pages_live"] == 0 and st["page_occupancy"] == 0.0
        assert st["fragmentation"] == 0.0
    fs = flat.alloc()
    flat.grow_to(fs, 10)
    st = flat.stats()
    assert st["page_size"] == MAX and st["page_occupancy"] == 0.5
    assert st["fragmentation"] == pytest.approx(1 - 10 / 32)
    ps = paged.alloc(paged.pages_for(10))
    paged.grow_to(ps, 10)
    st = paged.stats()
    assert st["pages_live"] == 2 and st["page_occupancy"] == 2 / 8
    assert st["fragmentation"] == pytest.approx(1 - 10 / 16)
    paged.free(ps)
    assert paged.stats()["fragmentation"] == 0.0


@pytest.mark.parametrize("window", [None, 6])
def test_paged_write_read_matches_flat(window):
    """Bit-identity: a prefill written to pages and gathered back equals the
    flat slot layout exactly (zero page == zero padding); with a window
    the ring leaves stay slot-indexed in both."""
    _cfg, model, params = _tiny_model(window=window)
    S, MAX = 5, 16
    cache = _prefill(model, params, S, seed=2)
    flat = SlotKVCache(model, max_slots=2, max_len=MAX)
    paged = PagedKVCache(model, max_slots=2, max_len=MAX, page_size=4)
    fs, ps = flat.alloc(), paged.alloc(paged.pages_for(S))
    flat.write(fs, cache, S)
    paged.write(ps, cache, S)
    assert _leaves_equal(flat.read_slot(fs), paged.read_slot(ps))


def test_paged_decode_tick_matches_flat():
    """One decode step over both layouts — flat decodes in place through the
    lane view, paged gathers, decodes and scatters the touched page — leaves
    both caches bit-identical and gives identical logits."""
    _cfg, model, params = _tiny_model()
    MAX, lens = 16, (3, 7)
    flat = SlotKVCache(model, max_slots=2, max_len=MAX)
    paged = PagedKVCache(model, max_slots=2, max_len=MAX, page_size=4)
    feeds = {}
    for i, S in enumerate(lens):
        cache = _prefill(model, params, S, seed=10 + i)
        fs, ps = flat.alloc(), paged.alloc(paged.pages_for(S + 1))
        assert fs == ps == i
        flat.write(fs, cache, S)
        paged.write(ps, cache, S)
        feeds[i] = S
    tok = torch.tensor([[5], [9]])
    idx = torch.tensor(lens)
    logits_f, _ = model.decode_step(params, tok, lane_view(flat.buffers), idx)
    tables, dest = _tick_inputs(paged, feeds)
    gathered = paged.gather(paged.pools, torch.as_tensor(tables, dtype=torch.long))
    logits_p, _ = model.decode_step(params, tok, lane_view(gathered), idx)
    paged.scatter(paged.pools, gathered, torch.as_tensor(dest, dtype=torch.long), idx)
    assert torch.equal(logits_f, logits_p)
    for slot in range(2):
        assert _leaves_equal(flat.read_slot(slot), paged.read_slot(slot))
    assert flat.read_slot(1)["s0"]["attn"]["k"][:, 0, 7].any()  # the new row landed


def test_paged_write_validates():
    _cfg, model, params = _tiny_model()
    cache = _prefill(model, params, 4, seed=0)
    kv = PagedKVCache(model, max_slots=1, max_len=8, page_size=4)
    with pytest.raises(ValueError):
        kv.write(0, cache, 4)  # not allocated
    slot = kv.alloc(1)
    with pytest.raises(ValueError):
        kv.write(slot, cache, 9)  # exceeds max_len
    with pytest.raises(ValueError):
        kv.write(slot, cache, 8)  # needs 2 pages, slot holds 1


# ---------------------------------------------------------------------------
# SSM leaves: slot-indexed, viewed onto the decode batch axis
# ---------------------------------------------------------------------------


def test_lane_view_maps_ssm_leaves_without_a_copy():
    """State ``(slots, L, 1, H, P, N)`` -> ``(L, slots, H, P, N)`` and conv
    ``(slots, L, 1, K-1, C)`` -> ``(L, slots, K-1, C)``; a single (global)
    layer's leaves have no layers axis. Writes land in the slot-major pool."""
    state = torch.arange(3 * 2 * 4 * 2 * 3, dtype=torch.float32).reshape(3, 2, 1, 4, 2, 3)
    conv = torch.arange(3 * 2 * 3 * 5, dtype=torch.float32).reshape(3, 2, 1, 3, 5)
    g_state = torch.zeros(3, 1, 4, 2, 3)
    g_conv = torch.zeros(3, 1, 3, 5)
    view = lane_view({
        "s0": {"ssm": {"conv": conv, "state": state}},
        "g1": {"ssm": {"conv": g_conv, "state": g_state}},
    })
    s, g = view["s0"]["ssm"], view["g1"]["ssm"]
    assert s["state"].shape == (2, 3, 4, 2, 3) and s["conv"].shape == (2, 3, 3, 5)
    assert g["state"].shape == (3, 4, 2, 3) and g["conv"].shape == (3, 3, 5)
    assert torch.equal(s["state"][1, 2], state[2, 1, 0])
    assert s["state"].data_ptr() == state.data_ptr()  # views, not copies
    s["state"][0, 1].copy_(torch.full((4, 2, 3), -1.0))  # lane 1 of layer 0
    s["conv"][1, 2, 0, 4] = -2.0
    g["state"][2] = 7.0
    assert (state[1, 0, 0] == -1.0).all() and not (state[0] == -1.0).any()
    assert conv[2, 1, 0, 0, 4].item() == -2.0
    assert (g_state[2] == 7.0).all() and not g_state[:2].any()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_decode_tick_writes_through_the_lane_view(arch):
    """One decode step over a flat and a paged pool: both write each lane's
    conv window and state into its own slot and agree bit for bit."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX, lens = 16, (3, 11)
    flat = SlotKVCache(model, max_slots=2, max_len=MAX)
    paged = PagedKVCache(model, max_slots=2, max_len=MAX, page_size=4)
    feeds = {}
    for i, S in enumerate(lens):
        cache = _prefill(model, params, S, seed=20 + i)
        flat.write(flat.alloc(), cache, S)
        paged.write(paged.alloc(paged.pages_for(S + 1)), cache, S)
        feeds[i] = S
    grp = next(g.name for g in model.plan if g.kind == "scan")
    before = flat.read_slot(1)[grp]["ssm"]["state"].clone()
    tok, idx = torch.tensor([[5], [9]]), torch.tensor(lens)
    logits_f, _ = model.decode_step(params, tok, lane_view(flat.buffers), idx)
    tables, dest = _tick_inputs(paged, feeds)
    gathered = paged.gather(paged.pools, torch.as_tensor(tables, dtype=torch.long))
    logits_p, _ = model.decode_step(params, tok, lane_view(gathered), idx)
    paged.scatter(paged.pools, gathered, torch.as_tensor(dest, dtype=torch.long), idx)
    assert torch.equal(logits_f, logits_p)
    for slot in range(2):
        assert _leaves_equal(flat.read_slot(slot), paged.read_slot(slot))
    after = flat.read_slot(1)[grp]["ssm"]["state"]
    assert not torch.equal(after, before)  # the step landed in slot 1's pool row
    # and it is what a batch-1 decode of that sequence alone computes
    alone = extend_caches(_prefill(model, params, lens[1], seed=21), MAX - lens[1],
                          window=cfg.window)
    logits_1, _ = model.decode_step(params, [[9]], alone, [lens[1]])
    torch.testing.assert_close(logits_f[1:], logits_1, atol=1e-5, rtol=1e-5)


def test_paged_pool_without_page_leaves():
    """mamba2 keeps no growable leaf: every pool is slot-major, and the
    pages are accounting only — alloc, write, gather, grow, free still work."""
    cfg = get_reduced("mamba2-1.3b").replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    kv = PagedKVCache(model, max_slots=2, max_len=16, page_size=4, num_pages=5)
    state = kv.pools["s0"]["ssm"]["state"]
    assert state.shape == (2, cfg.num_layers, 1, 8, 16, 16)  # slots, no page axis
    cache = _prefill(model, params, 6, seed=3)
    slot = kv.alloc(kv.pages_for(6))
    assert kv.pages_live == 2
    kv.write(slot, cache, 6)
    got = kv.read_slot(slot)["s0"]["ssm"]
    assert torch.equal(got["state"], cache["s0"]["ssm"]["state"])
    assert torch.equal(got["conv"], cache["s0"]["ssm"]["conv"])
    tables, _dest = _tick_inputs(kv, {slot: 6})
    gathered = kv.gather(kv.pools, torch.as_tensor(tables, dtype=torch.long))
    assert gathered["s0"]["ssm"]["state"] is state  # slot leaves are the pool itself
    assert kv.grow_to(slot, 16) and kv.pages_live == 4
    assert kv.alloc(2) is None  # one page left
    kv.free(slot)
    assert kv.pages_live == 0 and kv.num_free == 2
