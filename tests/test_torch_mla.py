"""The port's MLA (DeepSeek-V2 multi-head latent attention,
``repro_torch.models.attention.mla_attention``) and flash attention at a
query/key head dim other than the value's, against the reference on the
CPU at float32 (atol = rtol = 1e-4): the expanded prefill and training
form, the absorbed decode with every lane at its own position, reduced
deepseek-v2's prefill logits and compressed caches, greedy and per-lane
decode, the serve engine's tokens against sequential decode in both KV
layouts, K1's input check over its (Dqk, Dv) pairs, and the kernel's plain
versions at the reduced MLA's 24/16 against the reference's
``_attend_dense``, forward and (through ``jax.vjp``) backward. The
reference's own ``Model.init(PRNGKey(0))`` parameters cross over through
numpy; inputs come from numpy seeds. The CUDA kernel at 192/128 is held
against its plain version on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.attention import _attend_dense as jax_attend_dense
from repro.models.attention import mla_attention as jax_mla_attention
from repro.models.common import causal_mask_bias as jax_causal_mask_bias
from repro.models.lm import extend_caches as jax_extend_caches
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model
from repro_torch.models.attention import mla_attention
from repro_torch.models.lm import extend_caches
from repro_torch.serve import ServeEngine
from repro_torch.serve.kv import lane_view

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_reduced(ARCH).replace(dtype="float32")
    cfg = get_reduced(ARCH).replace(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.attention == "mla" and cfg.q_lora_rank > 0
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


def _attn(models, layer=0):
    """The attention parameters of the MoE group's ``layer`` in both packages."""
    _jm, jp, tm, tp = models
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["s1"]["attn"])
    return tm.cfg, jl, tp["layers"]["s1"][layer]["attn"]


def _x(cfg, seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_expanded_prefill_matches_reference(models):
    """The prefill and training form: keys and values expanded per head out
    of the latent, Dqk = nope + rope = 24 and Dv = 16 through ``attend``."""
    cfg, jl, tl = _attn(models)
    x = _x(cfg, 0, 2, 9)
    jy, jc = jax_mla_attention(cfg, jl, jnp.asarray(x), jnp.arange(9), return_cache=True)
    with torch.no_grad():
        ty, tc = mla_attention(cfg, tl, torch.from_numpy(x), torch.arange(9), return_cache=True)
    _close(ty, jy)
    assert set(tc) == {"ckv", "krope"}
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key])


def test_absorbed_decode_per_lane_matches_vmapped_reference(models):
    """Lanes at different positions in one step: each lane's RoPE position,
    cache write offset and valid length are its own, and the lane's latent
    and rotated key land in the cache in place."""
    cfg, jl, tl = _attn(models)
    W, lens = 12, (4, 9, 2)
    rng = np.random.default_rng(1)
    ckv = rng.standard_normal((len(lens), W, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((len(lens), W, cfg.qk_rope_head_dim)).astype(np.float32)
    x = _x(cfg, 2, len(lens), 1)
    idx = np.asarray(lens, np.int32)

    def one(xx, c, k, i):
        y, nc = jax_mla_attention(cfg, jl, xx[None], i[None],
                                  cache={"ckv": c[None], "krope": k[None]}, cache_index=i)
        return y[0], nc["ckv"][0], nc["krope"][0]

    jy, jckv, jkrope = jax.vmap(one)(jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(krope),
                                     jnp.asarray(idx))
    cache = {"ckv": torch.from_numpy(ckv.copy()), "krope": torch.from_numpy(krope.copy())}
    with torch.no_grad():
        ty, nc = mla_attention(cfg, tl, torch.from_numpy(x), torch.from_numpy(idx)[:, None].long(),
                               cache=cache, cache_index=torch.from_numpy(idx))
    assert nc is None  # decode writes in place
    _close(ty, jy)
    _close(cache["ckv"], jckv)
    _close(cache["krope"], jkrope)


def test_prefill_logits_and_compressed_caches_match_reference(models):
    jm, jp, tm, tp = models
    toks = _prompt(3, 11, tm.cfg.vocab_size)[None]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    _close(tl, jl)
    assert set(tc) == {"s0", "s1"}  # the leading dense layer, then the MoE layers
    for grp in ("s0", "s1"):
        for key in ("ckv", "krope"):
            _close(tc[grp]["attn"][key], jc[grp]["attn"][key])


def test_greedy_decode_matches_reference(models):
    jm, jp, tm, tp = models
    prompt, width, steps = _prompt(4, 7, tm.cfg.vocab_size), 18, 8
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt[None])})
    jc = jax_extend_caches(jc, width - prompt.size)
    tl, tc = tm.prefill(tp, {"tokens": prompt[None]})
    tc = extend_caches(tc, width - prompt.size)
    jdec = jax.jit(jm.decode_step)
    jtoks, ttoks = [], []
    for i in range(steps):
        _close(tl[:, -1], jl[:, -1])
        jt, tt = int(jnp.argmax(jl[0, -1])), int(torch.argmax(tl[0, -1]))
        jtoks.append(jt)
        ttoks.append(tt)
        idx = prompt.size + i
        jl, jc = jdec(jp, jnp.asarray([[jt]], jnp.int32), jc, jnp.asarray(idx, jnp.int32))
        tl, tc = tm.decode_step(tp, [[tt]], tc, [idx])
    assert ttoks == jtoks
    for key in ("ckv", "krope"):
        _close(tc["s1"]["attn"][key], jc["s1"]["attn"][key])


def test_model_decode_per_lane_matches_vmapped_reference(models):
    jm, jp, tm, tp = models
    width, lens = 16, (5, 9, 3)
    jcs, tcs, toks = [], [], []
    for i, n in enumerate(lens):
        prompt = _prompt(10 + i, n, tm.cfg.vocab_size)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])})
        jcs.append(jax_extend_caches(jc, width - n))
        _tl, tc = tm.prefill(tp, {"tokens": prompt[None]})
        tcs.append(extend_caches(tc, width - n))
        toks.append(int(jnp.argmax(jl[0, -1])))
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)  # (lanes, L, 1, W, ...)
    tcache = {g: {"attn": {key: torch.cat([c[g]["attn"][key] for c in tcs], dim=1)
                           for key in ("ckv", "krope")}} for g in ("s0", "s1")}
    jstep = jax.jit(jax.vmap(jm.decode_step, in_axes=(None, 0, 0, 0)))
    idx = np.asarray(lens)
    for step in range(3):
        tok = np.asarray(toks, np.int32)
        jl, jcache = jstep(jp, jnp.asarray(tok[:, None, None]), jcache, jnp.asarray(idx + step))
        tl, tcache = tm.decode_step(tp, tok[:, None], tcache, idx + step)
        _close(tl, np.asarray(jl)[:, 0])
        for key in ("ckv", "krope"):
            got = tcache["s1"]["attn"][key].transpose(0, 1)  # (lanes, L, W, ...)
            _close(got, np.asarray(jcache["s1"]["attn"][key])[:, :, 0])
        toks = [int(t) for t in torch.argmax(tl[:, -1], dim=-1)]


def test_lane_view_maps_mla_latents_without_a_copy():
    ckv = torch.arange(3 * 2 * 1 * 5 * 4, dtype=torch.float32).reshape(3, 2, 1, 5, 4)
    krope = torch.zeros(3, 2, 1, 5, 2)
    view = lane_view({"s0": {"attn": {"ckv": ckv, "krope": krope}}})["s0"]["attn"]
    assert view["ckv"].shape == (2, 3, 5, 4) and view["krope"].shape == (2, 3, 5, 2)
    assert torch.equal(view["ckv"][1, 2], ckv[2, 1, 0])
    view["krope"][0, 1, 3] = 7.0  # a decode write lands in the slot-major pool
    assert torch.equal(krope[1, 0, 0, 3], torch.full((2,), 7.0))


def sequential_decode(model, params, prompt, budget, width):
    logits, caches = model.prefill(params, {"tokens": prompt[None, :]})
    caches = extend_caches(caches, width - int(prompt.size))
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(budget - 1):
        logits, caches = model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.mark.parametrize("buckets", [(8, 16), None], ids=["bucketed", "exact-length"])
@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_engine_matches_sequential_decode(models, kv_layout, buckets):
    """The compressed latents paged (or in flat slots) and decoded through
    the lane view, by the decode graph's body and, bucketed, the prefill
    graphs'."""
    _jm, _jp, model, params = models
    rng = np.random.default_rng(9)
    prompts = [_prompt(30 + i, int(n), model.cfg.vocab_size)
               for i, n in enumerate(rng.integers(3, 14, size=5))]
    budgets = [int(b) for b in rng.integers(2, 8, size=5)]
    refs = [sequential_decode(model, params, p, b, 28) for p, b in zip(prompts, budgets)]
    with ServeEngine(model, params, max_slots=3, max_len=28, page_size=4, kv_layout=kv_layout,
                     prefill_buckets=buckets, device="cpu") as engine:
        outs = engine.generate(prompts, budgets, timeout=120)
        stats = engine.stats()
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref
    assert stats["graphs"]["decode"]["replays"] == stats["ticks"]
    if buckets:
        assert sum(g["replays"] for k, g in stats["graphs"].items()
                   if k.startswith("prefill_")) == len(prompts)


# -- K1 at Dqk != Dv ----------------------------------------------------------------


@pytest.mark.parametrize("bshd", [True, False], ids=["model-layout", "bhsd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_input_check_takes_the_four_head_dim_pairs(dtype, bshd):
    def qkv(dqk, dv):
        shapes = [(1, 8, 4, dqk), (1, 8, 2, dqk), (1, 8, 2, dv)]  # (B, S, heads, D)
        ts = [torch.empty(s, device="meta", dtype=dtype) for s in shapes]
        return ts if bshd else [t.transpose(1, 2) for t in ts]

    assert tfa.HEAD_DIM_PAIRS == ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
    for pair in tfa.HEAD_DIM_PAIRS:
        assert tfa.check_inputs(*qkv(*pair), bshd=bshd) == 8
    for pair in ((192, 192), (128, 192), (64, 128), (24, 16), (96, 96), (256, 128)):
        with pytest.raises(ValueError, match="head dims"):
            tfa.check_inputs(*qkv(*pair), bshd=bshd)


def test_design_names_the_192_128_instantiation():
    assert tfa.design(torch.bfloat16, 192, 128) == "wgmma-wide"
    assert tfa.design(torch.float32, 192, 128) == "tf32x3"
    assert tfa.design(torch.bfloat16, 64) == "wgmma"
    with pytest.raises(ValueError, match="head dims"):
        tfa.design(torch.bfloat16, 192)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.design_bwd(torch.bfloat16, 192)


# (B, H, KV, Sq, Sk, causal, k_len): the reduced MLA's 4 heads, MHA, and GQA
PLAIN_CASES = {
    "causal": (2, 4, 4, 13, 13, True, None),
    "gqa-causal": (1, 4, 2, 20, 20, True, None),
    "k_len": (1, 4, 4, 9, 16, False, 11),
}


def _mla_qkv_np(seed, B, H, KV, Sq, Sk, dqk=24, dv=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, Sq, H, dqk), (B, Sk, KV, dqk), (B, Sk, KV, dv)]]


def _jax_bias(Sq, Sk, causal, k_len):
    if causal:
        return jax_causal_mask_bias(jnp.arange(Sq), jnp.arange(Sk), valid_len=k_len)[None]
    ok = jnp.arange(Sk)[None, :] < (Sk if k_len is None else k_len)
    return jnp.where(jnp.broadcast_to(ok, (Sq, Sk)), 0.0, -1e30).astype(jnp.float32)[None]


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_versions_at_24_16_match_reference_dense_attention(name):
    """The kernel's plain forward (with its ``lse``) and the dense oracle at
    Dqk = 24, Dv = 16 against the reference's ``_attend_dense``, which the
    reduced deepseek's prefill runs: the scale is Dqk^-1/2."""
    B, H, KV, Sq, Sk, causal, k_len = PLAIN_CASES[name]
    q, k, v = _mla_qkv_np(len(name), B, H, KV, Sq, Sk)
    want = np.asarray(jax_attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       _jax_bias(Sq, Sk, causal, k_len)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, k_len=k_len)
    assert got.shape == (B, Sq, H, 16)
    _close(got, want)
    bhsd = [t.transpose(1, 2) for t in (tq, tk, tv)]
    _close(tfa.attention_ref(*bhsd, causal=causal, k_len=k_len).transpose(1, 2), want)
    o, lse = tfa.flash_attention_lse_ref(*bhsd, causal=causal, k_len=k_len)
    _close(o.transpose(1, 2), want)
    assert lse.shape == (B, H, Sq)


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_backward_at_24_16_matches_reference_vjp(name):
    """The plain backward's formulas at Dqk != Dv against ``jax.vjp`` of the
    reference's ``_attend_dense``; on the CPU the autograd function takes
    them (the card has no backward kernel at 192/128 yet)."""
    B, H, KV, Sq, Sk, causal, k_len = PLAIN_CASES[name]
    q, k, v = _mla_qkv_np(len(name) + 50, B, H, KV, Sq, Sk)
    do = np.random.default_rng(7).standard_normal((B, Sq, H, 16)).astype(np.float32)
    bias = _jax_bias(Sq, Sk, causal, k_len)
    _, vjp = jax.vjp(lambda a, b, c: jax_attend_dense(a, b, c, bias),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, k_len=k_len)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w)
