"""The port's serving engine (``repro_torch.serve.ServeEngine``) on reduced
tinyllama, mamba2 and hymba at float32: continuous batching equals the
port's sequential single-request decode token for token, preempt/resume is
bit-identical, the engine's tokens equal the reference JAX engine's on the
same prompts and weights, recurrent-state families refuse prefill buckets,
and the engine refuses to pick a device it does not have.

Tests whose claim rests on an interleaving of the engine's threads pin it
with :class:`_ScriptedEngine` rather than hope for it: a prefill's time on a
loaded host is not bounded, so whether two sequences are resident together
is otherwise a matter of luck."""
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
from repro_torch.models import build_model
from repro_torch.models.lm import extend_caches
from repro_torch.core import ThreadPool
from repro_torch.serve import ServeEngine

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)


class _ScriptedEngine(ServeEngine):
    """:class:`ServeEngine` with the timing of its threads pinned.

    ``hold_first_tick=n``: the first decode tick waits until ``n`` prefilled
    sequences wait to join, so they start decoding together. ``after={rid:
    rids}``: request ``rid``'s first prefill waits until every request in
    ``rids`` has finished. ``preempt_at=t``: before the decode tick that
    follows ``t`` decode steps, the youngest resident is preempted (once).
    """

    def __init__(self, *args, hold_first_tick=0, after=None, preempt_at=None, **kw):
        super().__init__(*args, **kw)
        self._hold = hold_first_tick
        self._after = after or {}
        self._preempt_at = preempt_at
        self._finished: set = set()
        self._finished_cv = threading.Condition()

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

    def _prefill_one(self, p):
        wait = set(self._after.get(p.handle.rid, ()))
        if wait and not p.tokens:
            with self._finished_cv:
                if not self._finished_cv.wait_for(lambda: wait <= self._finished, 60):
                    raise TimeoutError(f"requests {wait} never finished")
        super()._prefill_one(p)

    def _resolve(self, retired):
        super()._resolve(retired)
        with self._finished_cv:
            self._finished.update(seq.handle.rid for seq, _ in retired)
            self._finished_cv.notify_all()


@pytest.fixture(scope="module")
def tiny():
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def sequential_decode(model, params, prompt, budget, width):
    """The single-request path, provisioned at ``width`` KV capacity (the
    engine's max_len) so both programs mask identically."""
    logits, caches = model.prefill(params, {"tokens": prompt[None, :]})
    caches = extend_caches(caches, width - int(prompt.size), window=model.cfg.window)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(budget - 1):
        logits, caches = model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_continuous_batching_matches_single_request_decode(tiny, kv_layout):
    cfg, model, params = tiny
    MAX_LEN = 28
    rng = np.random.default_rng(0)
    prompts = _prompts(cfg, 1, rng.integers(3, 13, size=6))
    budgets = [int(b) for b in rng.integers(2, 9, size=6)]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ServeEngine(
        model, params, max_slots=3, max_len=MAX_LEN, prefill_buckets=(8, 16),
        kv_layout=kv_layout, device="cpu",
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["completed"] == 6
    assert stats["kv"]["peak_live"] <= 3


@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_sliding_window_ring_serving_matches_single_request_decode(kv_layout):
    """Ring caches (window shorter than some prompts) stay slot-indexed in
    both layouts; each lane keeps its own ring positions."""
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", window=6)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    prompts = _prompts(cfg, 2, [3, 9, 5, 12])
    budgets = [8, 5, 9, 6]
    refs = [sequential_decode(model, params, p, b, 24) for p, b in zip(prompts, budgets)]
    with ServeEngine(
        model, params, max_slots=2, max_len=24, page_size=4, kv_layout=kv_layout, device="cpu"
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


def test_page_pressure_preempts_and_resumes_bit_identical(tiny):
    cfg, model, params = tiny
    MAX_LEN = 24
    prompts = _prompts(cfg, 5, [5, 5, 5])
    budgets = [12, 11, 10]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    # 2 residents x 6 pages/seq would need 12 pages; 6 forces preemption
    # once the first two decode together
    with _ScriptedEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, num_pages=6, device="cpu",
        hold_first_tick=2,
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["preemptions"] >= 1
    assert stats["completed"] == 3
    assert stats["kv"]["pages_live"] == 0


def test_engine_tokens_equal_the_reference_engine():
    jcfg = jax_get_reduced("tinyllama-1.1b").replace(dtype="float32")
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = _prompts(cfg, 7, [6, 11, 4, 9])
    budgets = [6, 4, 7, 5]
    kw = dict(max_slots=2, max_len=24, page_size=4)
    with JaxServeEngine(jmodel, jparams, **kw) as engine:
        want = engine.generate(prompts, budgets, timeout=300)
    with ServeEngine(model, params, device="cpu", **kw) as engine:
        got = engine.generate(prompts, budgets, timeout=120)
    for w, g in zip(want, got):
        assert list(map(int, g)) == list(map(int, w))


def test_capacity_eviction_truncates(tiny):
    cfg, model, params = tiny
    with ServeEngine(model, params, max_slots=1, max_len=10, device="cpu") as engine:
        h = engine.submit(np.arange(4, dtype=np.int32), max_new_tokens=50)
        out = h.result(120)
        stats = engine.stats()
    assert h.truncated and len(out) == 7  # feeds at positions 4..9
    assert stats["truncations"] == 1 and stats["kv"]["evictions"] == 1


def test_streaming_iterator_matches_result(tiny):
    cfg, model, params = tiny
    with ServeEngine(model, params, max_slots=2, max_len=16, device="cpu") as engine:
        h = engine.submit(_prompts(cfg, 3, [5])[0], 6)
        streamed = list(h)
        assert streamed == list(map(int, h.result(120)))
        assert h.ttft is not None and len(h.token_times) == 6


def test_latency_marks_split_ttft(tiny):
    """submit <= prefill start <= prefill done <= first token for every
    request; with one slot, later requests wait for it after their prefill."""
    cfg, model, params = tiny
    with ServeEngine(model, params, max_slots=1, max_len=16, device="cpu") as engine:
        handles = [engine.submit(p, 4) for p in _prompts(cfg, 4, [5, 6, 7])]
        for h in handles:
            h.result(120)
    for h in handles:
        assert h.submit_t <= h.prefill_start_t <= h.prefill_done_t <= h.first_token_t
        assert h.ttft == pytest.approx(h.first_token_t - h.submit_t)


def test_engine_without_device_raises_without_gpu(tiny):
    _cfg, model, params = tiny
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)


def test_engine_refuses_a_model_on_another_device(tiny):
    _cfg, model, params = tiny
    with pytest.raises(ValueError):
        ServeEngine(model, params, device="meta")


SSM_ARCHS = ["mamba2-1.3b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_family_matches_single_request_decode(arch):
    """Recurrent-state caches (no bucketing) through the engine: its tokens
    equal the port's sequential decode and the JAX engine's, on the
    reference's weights. Hymba's prompts straddle its window of 8."""
    jcfg = jax_get_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    MAX_LEN = 20
    prompts = _prompts(cfg, 1, [5, 11, 3])
    budgets = [6, 4, 5]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ServeEngine(model, params, max_slots=2, max_len=MAX_LEN, device="cpu") as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
    with JaxServeEngine(jmodel, jparams, max_slots=2, max_len=MAX_LEN) as engine:
        want = engine.generate(prompts, budgets, timeout=300)
    for ref, out, w in zip(refs, outs, want):
        assert list(map(int, out)) == ref == list(map(int, w))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_page_pressure_preempts_and_resumes_bit_identical(arch):
    """A preempted sequence resumes by an exact-length re-prefill, which
    rebuilds its conv window and state; mamba2 holds no page leaves at all,
    so only the page accounting forces the preemption. The first two
    sequences start decoding together: if one ran alone (its neighbour's
    prefill slow on a loaded host), the pages would never run out
    (:func:`test_ssm_residents_that_never_overlap_are_not_preempted`)."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX_LEN = 24
    prompts = _prompts(cfg, 5, [5, 5, 5])
    budgets = [12, 11, 10]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with _ScriptedEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, num_pages=6, device="cpu",
        hold_first_tick=2,
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["preemptions"] >= 1
    assert stats["completed"] == 3
    assert stats["kv"]["pages_live"] == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_residents_that_never_overlap_are_not_preempted(arch):
    """The interleaving the page-pressure test must not meet: each sequence
    decodes alone (request 2's prefill waits for request 0, request 1's for
    both), so no two hold pages together and nothing is preempted. The
    tokens still equal the sequential decode's; only ``preemptions`` stays
    0, the assert that failed when the timing happened this way by chance."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX_LEN = 24
    prompts = _prompts(cfg, 5, [5, 5, 5])
    budgets = [12, 11, 10]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ThreadPool(4, name="scripted") as pool, _ScriptedEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, num_pages=6, device="cpu",
        pool=pool, after={1: (0, 2), 2: (0,)},
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["preemptions"] == 0
    assert stats["completed"] == 3 and stats["kv"]["pages_live"] == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_resume_after_preemption_at_every_tick_matches_sequential_decode(arch):
    """A sequence preempted after any number of its decode steps (1 to the
    last before it finishes) resumes by a chunked re-prefill of prompt +
    generated prefix; its tokens still equal the stepped recurrence of the
    sequential decode, at every tick."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX_LEN = 24
    prompt = _prompts(cfg, 8, [6])[0]
    budget = 9
    ref = sequential_decode(model, params, prompt, budget, MAX_LEN)
    for tick in range(1, budget - 1):
        with _ScriptedEngine(
            model, params, max_slots=2, max_len=MAX_LEN, page_size=4, device="cpu",
            preempt_at=tick,
        ) as engine:
            out = engine.submit(prompt, budget).result(120)
            stats = engine.stats()
        assert list(map(int, out)) == ref, f"preempted at tick {tick}"
        assert stats["preemptions"] == 1 and stats["kv"]["pages_live"] == 0


@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_window_reaching_max_len_serves_like_sequential_decode(kv_layout):
    """Reduced hymba (window 8) at ``max_len=8``: the slots keep plain K/V
    (no ring), while each prefill returns a ring of its prompt's length.
    The engine lays it out as plain K/V; its tokens equal the port's
    sequential decode (the JAX engine fails on this cache write)."""
    cfg = get_reduced("hymba-1.5b").replace(dtype="float32")
    assert cfg.window == 8
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX_LEN = 8
    prompts = _prompts(cfg, 6, [3, 5, 2])
    budgets = [5, 4, 6]  # prompt + budget - 1 <= max_len: no truncation
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ServeEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, kv_layout=kv_layout,
        device="cpu",
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["truncations"] == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_buckets_are_rejected_for_recurrent_state(arch):
    """Pad tokens would run through the SSM's recurrence (and hymba's
    window), so neither family may bucket its prompts."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    assert not ServeEngine.supports_prefill_buckets(cfg)
    with pytest.raises(ValueError, match="prefill_buckets"):
        ServeEngine(model, model.init(0), prefill_buckets=(8, 16), device="cpu")
