"""The serve engine's graphs (``repro_torch.serve.graphs``) on the CPU, on
reduced tinyllama, mamba2 and hymba at float32. There is nothing to capture
here: the decode tick and each bucket's prefill run the same bodies through
the same static buffers as on the card, and a replay overwrites the static
outputs as a graph's does. So these tests hold everything but the capture:
the buffers and pools stay bound for a whole run, the zero page stays zero,
the warm-up's writes into free slots are harmless, ``prefill`` with a device
index for ``last_pos`` equals the int form and the JAX package's, two
prompts of one bucket keep their own caches, and the first-launch guard
refuses to run inside a capture. The on-card half is in
``tests/test_torch_gpu.py``."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.models.lm import extend_caches
from repro_torch.serve import PagedKVCache, ServeEngine, SlotKVCache
from repro_torch.serve.graphs import DecodeGraph
from repro_torch.tree import tree_leaves

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "hymba-1.5b"]


def _model(arch, seed=0):
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(seed)


def _jax_pair(arch):
    jcfg = jax_get_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, model, params


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]


def sequential_decode(model, params, prompt, budget, width):
    logits, caches = model.prefill(params, {"tokens": prompt[None, :]})
    caches = extend_caches(caches, width - int(prompt.size), window=model.cfg.window)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(budget - 1):
        logits, caches = model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
        out.append(int(torch.argmax(logits[0, -1])))
    return out


class _HeldEngine(ServeEngine):
    """``hold_first_tick=n``: the first decode tick waits until ``n``
    prefilled sequences wait to join. ``preempt_at=t``: before the tick that
    follows ``t`` decode steps, the youngest resident is preempted (once)."""

    def __init__(self, *args, hold_first_tick=0, preempt_at=None, **kw):
        super().__init__(*args, **kw)
        self._hold = hold_first_tick
        self._preempt_at = preempt_at

    def _tick_body(self):
        deadline = time.monotonic() + 60
        while self._hold:
            with self._lock:
                if len(self._joinq) >= self._hold:
                    self._hold = 0
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("the held prefills never arrived")
            time.sleep(1e-3)
        with self._lock:
            if self._preempt_at == self._ticks and self._active:
                self._preempt_locked(max(self._active.values(), key=lambda s: s.p.order))
                self._preempt_at = None
        super()._tick_body()


def _page_pools(kv):
    """The page leaves of a paged pool (the slot leaves have no zero page)."""
    specs = tree_leaves(kv._spec_tree)
    return [pool for spec, pool in zip(specs, tree_leaves(kv.pools)) if spec.kind == "page"]


# -- static buffers and pools --------------------------------------------------------


@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_decode_graph_keeps_its_buffers_and_pools_for_a_whole_run(kv_layout):
    """Every tick replays the decode graph on the same static inputs and
    outputs and the same pools (same ``data_ptr``), and the replays equal
    the ticks; the tokens equal the sequential decode's."""
    cfg, model, params = _model("tinyllama-1.1b")
    prompts = _prompts(cfg, 1, [3, 9, 5, 7])
    budgets = [6, 4, 7, 5]
    refs = [sequential_decode(model, params, p, b, 24) for p, b in zip(prompts, budgets)]
    with ServeEngine(model, params, max_slots=2, max_len=24, page_size=4, kv_layout=kv_layout,
                     prefill_buckets=(8, 16), device="cpu") as engine:
        graph = engine._decode_graph
        pools = engine.kv.pools if kv_layout == "paged" else engine.kv.buffers

        def addresses():
            return ([t.data_ptr() for t in graph.inputs.device.values()]
                    + [graph._graph.outputs["next"].data_ptr()]
                    + [t.data_ptr() for t in tree_leaves(pools)])

        seen, replay = [], graph._graph.replay

        def recording_replay():
            seen.append(addresses())
            return replay()

        graph._graph.replay = recording_replay
        before = addresses()
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
        assert addresses() == before
        with pytest.raises(AttributeError):  # read-only: bound once
            setattr(engine.kv, "pools" if kv_layout == "paged" else "buffers", pools)
    assert seen and all(a == before for a in seen)
    assert stats["graphs"]["decode"]["replays"] == stats["ticks"] == len(seen)
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


def test_decode_graph_refuses_a_rebound_pool_leaf():
    """A pool leaf replaced behind the graph's back would decouple a captured
    graph from the cache silently; the tick raises instead."""
    _cfg, model, params = _model("tinyllama-1.1b")
    kv = PagedKVCache(model, max_slots=2, max_len=16, page_size=4)
    graph = DecodeGraph(model, params, kv)
    tok, idx = np.zeros((2, 1), np.int64), np.zeros((2,), np.int64)
    graph.run(tok, idx, {})
    leaf = kv.pools["s0"]["attn"]
    leaf["k"] = leaf["k"].clone()
    with pytest.raises(RuntimeError, match="re-bound"):
        graph.run(tok, idx, {})


# -- the zero page and the warm-up's writes -------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_zero_page_stays_zero_through_capture_and_preemption_at_every_tick(arch):
    """The warm-up and capture runs read the zero page and write the scratch
    page; serving then preempts the youngest resident after each number of
    decode steps in turn (a resume re-prefills exactly). The zero page reads
    all zeros after construction and after every run, and the tokens equal
    the sequential decode's."""
    cfg, model, params = _model(arch)
    MAX_LEN = 24
    prompts = _prompts(cfg, 5, [5, 6])
    budgets = [9, 8]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    for tick in range(1, budgets[1] - 1):
        with _HeldEngine(model, params, max_slots=2, max_len=MAX_LEN, page_size=4, device="cpu",
                         hold_first_tick=2, preempt_at=tick) as engine:
            zero = PagedKVCache.ZERO_PAGE
            pages = _page_pools(engine.kv)
            assert pages and all(not p[zero].any() for p in pages)
            outs = engine.generate(prompts, budgets, timeout=120)
            stats = engine.stats()
            assert all(not p[zero].any() for p in pages), f"preempted at tick {tick}"
        assert stats["preemptions"] == 1
        for ref, out in zip(refs, outs):
            assert list(map(int, out)) == ref, f"preempted at tick {tick}"


@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_garbage_left_in_free_slots_is_never_read(arch, kv_layout):
    """The warm-up runs decode every lane, so they leave values in free
    slots (flat layout, SSM state, rings) and in the scratch page. Finite
    garbage of any kind there is harmless: a join's ``kv.write`` replaces a
    slot whole, and decode masks every position past a lane's valid length.
    Every pool (but the zero page) is filled with random values before the
    requests come; the tokens still equal the sequential decode's."""
    cfg, model, params = _model(arch)
    MAX_LEN = 20
    prompts = _prompts(cfg, 2, [5, 11, 3])
    budgets = [6, 4, 5]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ServeEngine(model, params, max_slots=2, max_len=MAX_LEN, page_size=4,
                     kv_layout=kv_layout, device="cpu") as engine:
        kv = engine.kv
        pools = kv.pools if kv_layout == "paged" else kv.buffers
        if kv_layout == "flat":
            # the warm-up wrote into the free slots (it decoded token 0 at 0)
            assert any(t.any() for t in tree_leaves(pools) if t.is_floating_point())
        g = torch.Generator().manual_seed(0)
        page = set(map(id, _page_pools(kv))) if kv_layout == "paged" else set()
        for t in tree_leaves(pools):
            junk = (torch.randn(t.shape, generator=g) if t.is_floating_point()
                    else torch.randint(-1, MAX_LEN, t.shape, generator=g))
            start = PagedKVCache.RESERVED - 1 if id(t) in page else 0  # keep the zero page
            t[start:] = junk[start:].to(t.dtype)
        outs = engine.generate(prompts, budgets, timeout=120)
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


# -- the bucketed prefill --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_pos_as_a_device_index_equals_the_int_and_jax(arch):
    """``prefill(last_pos=tensor)`` (what a bucket's graph reads) gives the
    int form's logits and cache exactly, and the JAX package's within 1e-5,
    on the reference's weights."""
    cfg, jmodel, jparams, model, params = _jax_pair(arch)
    tokens = _prompts(cfg, 3, [12])[0][None]
    for last in (4, 11):
        want_logits, _ = jmodel.prefill(jparams, {"tokens": tokens}, last_pos=last)
        by_int, cache_int = model.prefill(params, {"tokens": tokens}, last_pos=last)
        by_idx, cache_idx = model.prefill(params, {"tokens": tokens},
                                          last_pos=torch.tensor([last]))
        assert torch.equal(by_idx, by_int)
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(cache_idx), tree_leaves(cache_int)))
        np.testing.assert_allclose(by_idx.numpy(), np.asarray(want_logits), atol=1e-5, rtol=0)


def test_two_prompts_of_one_bucket_keep_their_own_caches():
    """Both prompts of bucket 8 are prefilled (through the bucket's static
    buffers, whose outputs the second replay overwrites) before either joins
    the batch; each gets its own tokens, equal to the JAX engine's and the
    port's sequential decode. Without the clone out of the static cache the
    first would decode from the second's."""
    cfg, jmodel, jparams, model, params = _jax_pair("tinyllama-1.1b")
    prompts = _prompts(cfg, 11, [5, 7])
    budgets = [6, 5]
    kw = dict(max_slots=2, max_len=24, page_size=4, prefill_buckets=(8, 16))
    refs = [sequential_decode(model, params, p, b, 24) for p, b in zip(prompts, budgets)]
    with _HeldEngine(model, params, device="cpu", hold_first_tick=2, **kw) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    with JaxServeEngine(jmodel, jparams, **kw) as engine:
        want = engine.generate(prompts, budgets, timeout=300)
    assert stats["graphs"]["prefill_8"]["replays"] == 2
    assert stats["graphs"]["prefill_16"]["replays"] == 0
    for ref, out, w in zip(refs, outs, want):
        assert list(map(int, out)) == ref == list(map(int, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_stats_name_every_graph(arch):
    """``stats()["graphs"]``: the decode graph (replays == ticks) and, where
    the family buckets its prompts, one prefill graph per bucket (replays ==
    bucketed prefills); captured launches are empty on the CPU, where no
    kernel launches."""
    cfg, model, params = _model(arch)
    buckets = (8, 16) if ServeEngine.supports_prefill_buckets(cfg) else None
    with ServeEngine(model, params, max_slots=2, max_len=24, prefill_buckets=buckets,
                     device="cpu") as engine:
        engine.generate(_prompts(cfg, 4, [3, 10, 6]), 3, timeout=120)
        stats = engine.stats()
    graphs = stats["graphs"]
    want = {"decode"} | ({"prefill_8", "prefill_16"} if buckets else set())
    assert set(graphs) == want
    assert graphs["decode"]["replays"] == stats["ticks"] > 0
    if buckets:
        assert graphs["prefill_8"]["replays"] == 2 and graphs["prefill_16"]["replays"] == 1
    assert all(g["captured_launches"] == {} and g["capture_s"] >= 0 for g in graphs.values())


def test_slot_pool_graph_decodes_in_place():
    """The flat layout's graph decodes ``kv.buffers`` in place: a tick's new
    K/V row lands in the slot's buffer at its write index."""
    cfg, model, params = _model("tinyllama-1.1b")
    kv = SlotKVCache(model, max_slots=2, max_len=16)
    graph = DecodeGraph(model, params, kv)
    slot = kv.alloc()
    cache = model.prefill(params, {"tokens": _prompts(cfg, 6, [5])[0][None]})[1]
    kv.write(slot, cache, 5)
    tok, idx = np.array([[7], [0]], np.int64), np.array([5, 0], np.int64)
    before = kv.buffers["s0"]["attn"]["k"][slot, :, 0, 5].clone()
    nxt = graph.run(tok, idx, {slot: 5})
    assert nxt.shape == (2, 1) and 0 <= nxt[0, 0] < cfg.vocab_size
    assert not torch.equal(kv.buffers["s0"]["attn"]["k"][slot, :, 0, 5], before)


# -- the kernel wrappers inside a capture ---------------------------------------------------


def test_first_launch_guard_raises_inside_a_capture(monkeypatch):
    """An instantiation not yet checked, reached while the stream captures,
    raises before its check would synchronise (the check is never skipped);
    one already checked passes through."""
    guard = build.FirstLaunchGuard("k", lambda got, want: abs(got - want))
    calls = []

    def case():
        calls.append(1)
        return (lambda: 1.0), 1.0

    monkeypatch.setattr(build, "capturing", lambda: False)
    guard.check("checked", case)
    monkeypatch.setattr(build, "capturing", lambda: True)
    guard.check("checked", case)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        guard.check("new", case)
    assert calls == [1] and guard.checked == {"checked"}


def test_launch_tally_counts_this_threads_launches_and_captures_count_in_it_only(monkeypatch):
    """``count_launch`` adds to the wrapper's count where the kernel runs,
    and to the capture stream's tally while this thread captures into it
    (the launches a graph's replays repeat); a launch captured into another
    stream (another engine's capture) stays out of it."""

    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    def wrapper():
        pass

    wrapper.launches = 0
    capturing = {"on": False}
    current = {"stream": Stream(1)}
    monkeypatch.setattr(build, "capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: current["stream"])
    build.count_launch(wrapper, "k")  # outside any tally
    with build.launch_tally(Stream(1)) as tally:
        build.count_launch(wrapper, "k")  # runs now: not captured
        capturing["on"] = True
        build.count_launch(wrapper, "k")
        build.count_launch(wrapper, "j")
        current["stream"] = Stream(2)
        build.count_launch(wrapper, "k")  # captured into another stream
    assert tally == {"k": 1, "j": 1}
    assert wrapper.launches == 2  # the two outside the capture
