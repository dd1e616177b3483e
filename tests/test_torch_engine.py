"""The port's serving engine (``repro_torch.serve.ServeEngine``) on reduced
tinyllama, mamba2 and hymba at float32: continuous batching equals the
port's sequential single-request decode token for token, preempt/resume is
bit-identical, the engine's tokens equal the reference JAX engine's on the
same prompts and weights, recurrent-state families refuse prefill buckets,
and the engine refuses to pick a device it does not have."""
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
from repro_torch.serve import ServeEngine


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
    with ServeEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, num_pages=6, device="cpu"
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
    so only the page accounting forces the preemption."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    MAX_LEN = 24
    prompts = _prompts(cfg, 5, [5, 5, 5])
    budgets = [12, 11, 10]
    refs = [sequential_decode(model, params, p, b, MAX_LEN) for p, b in zip(prompts, budgets)]
    with ServeEngine(
        model, params, max_slots=2, max_len=MAX_LEN, page_size=4, num_pages=6, device="cpu"
    ) as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["preemptions"] >= 1
    assert stats["completed"] == 3
    assert stats["kv"]["pages_live"] == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_buckets_are_rejected_for_recurrent_state(arch):
    """Pad tokens would run through the SSM's recurrence (and hymba's
    window), so neither family may bucket its prompts."""
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    assert not ServeEngine.supports_prefill_buckets(cfg)
    with pytest.raises(ValueError, match="prefill_buckets"):
        ServeEngine(model, model.init(0), prefill_buckets=(8, 16), device="cpu")
