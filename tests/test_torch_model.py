"""The port's dense decoder (``repro_torch.models``) against the reference
``repro.models`` on reduced tinyllama at float32: the reference's own
``Model.init(PRNGKey(0))`` parameters cross over through numpy
(``repro_torch.bridge.params_from_jax``), the same prompts go through both,
and prefill logits and caches, greedy decode tokens and the per-lane
batched decode step are compared (atol = rtol = 1e-4). Prefill and greedy
decode also run on the other dense configs' reduced forms: phi4-mini (a
tied head, KV heads zero-padded 2 -> 16), qwen1.5 (QKV biases, here drawn
at random so that they count) and deepseek-coder (KV heads padded 2 -> 16,
RoPE theta 1e5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.lm import extend_caches as jax_extend_caches
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import Model, build_model
from repro_torch.models.lm import extend_caches

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


DENSE_ARCHS = ["tinyllama-1.1b", "phi4-mini-3.8b", "qwen1.5-4b", "deepseek-coder-33b"]


def _random_biases(tree):
    """The reference draws QKV biases as zeros: give them random values, so
    that a parity test sees them."""
    rng = np.random.default_rng(5)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                        if k in ("bq", "bk", "bv") else walk(v)) for k, v in node.items()}
        return node

    return walk(tree)


def _pair(arch="tinyllama-1.1b", **overrides):
    jcfg = jax_get_reduced(arch).replace(dtype="float32", **overrides)
    cfg = get_reduced(arch).replace(dtype="float32", **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if cfg.qkv_bias:
        jp = _random_biases(jp)
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def dense_models(request, models):
    return models if request.param == "tinyllama-1.1b" else _pair(request.param)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_init_params_have_the_reference_shapes(models):
    jm, _jp, tm, _tp = models
    ours = tm.init(seed=3)
    ref = jm.abstract_params()
    assert set(ours._modules) | set(ours._parameters) == set(ref)
    assert ours["embed"].shape == ref["embed"].shape
    assert ours["lm_head"].shape == ref["lm_head"].shape
    layers = ours["layers"]["s0"]
    assert len(layers) == tm.cfg.num_layers
    ref_layer = jax.tree.map(lambda s: s.shape[1:], ref["layers"]["s0"])
    for group, leaves in ref_layer.items():
        for name, shape in leaves.items():
            assert tuple(layers[0][group][name].shape) == shape, (group, name)
    assert not layers[0]["attn_norm"]["w"].any()  # norm weights start at zero


def test_prefill_matches_reference(dense_models):
    jm, jp, tm, tp = dense_models
    toks = _prompt(0, 12, tm.cfg.vocab_size)[None]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["s0"]["attn"][key], jc["s0"]["attn"][key])


def test_prefill_last_pos_matches_reference(models):
    """A right-padded bucket: logits at ``last_pos``, not at the end."""
    jm, jp, tm, tp = models
    toks = np.zeros((1, 16), np.int32)
    toks[0, :9] = _prompt(1, 9, tm.cfg.vocab_size)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, last_pos=jnp.asarray(8))
    tl, _ = tm.prefill(tp, {"tokens": toks}, last_pos=8)
    _close(tl, jl)


def test_greedy_decode_matches_reference(dense_models):
    jm, jp, tm, tp = dense_models
    prompt, width, steps = _prompt(2, 7, tm.cfg.vocab_size), 20, 8
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
    _close(tc["s0"]["attn"]["k"], jc["s0"]["attn"]["k"])


def test_per_lane_decode_matches_vmapped_reference(models):
    """Lanes at different positions in one batched step: each lane's RoPE
    position, cache write offset and valid length must be its own."""
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
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)  # (lanes, L, 1, W, KV, Dh)
    tcache = {"s0": {"attn": {
        key: torch.cat([c["s0"]["attn"][key] for c in tcs], dim=1) for key in ("k", "v")
    }}}  # (L, lanes, W, KV, Dh)
    jstep = jax.jit(jax.vmap(jm.decode_step, in_axes=(None, 0, 0, 0)))
    idx = np.asarray(lens)
    for step in range(3):
        tok = np.asarray(toks, np.int32)
        jl, jcache = jstep(jp, jnp.asarray(tok[:, None, None]), jcache, jnp.asarray(idx + step))
        tl, tcache = tm.decode_step(tp, tok[:, None], tcache, idx + step)
        _close(tl, np.asarray(jl)[:, 0])
        for key in ("k", "v"):
            got = tcache["s0"]["attn"][key].transpose(0, 1)  # (lanes, L, W, KV, Dh)
            _close(got, np.asarray(jcache["s0"]["attn"][key])[:, :, 0])
        toks = [int(t) for t in torch.argmax(tl[:, -1], dim=-1)]


def test_sliding_window_ring_decode_matches_reference():
    """The ring branch: a window shorter than the prompt, then decode
    through the re-laid ring."""
    jm, jp, tm, tp = _pair(window=6)
    prompt, width, steps = _prompt(4, 9, tm.cfg.vocab_size), 16, 5
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])})
    jc = jax_extend_caches(jc, width - prompt.size, window=6)
    tl, tc = tm.prefill(tp, {"tokens": prompt[None]})
    tc = extend_caches(tc, width - prompt.size, window=6)
    assert tc["s0"]["attn"]["pos"].shape == (tm.cfg.num_layers, 1, 6)
    jdec = jax.jit(jm.decode_step)
    for i in range(steps):
        _close(tl[:, -1], jl[:, -1])
        tok = int(jnp.argmax(jl[0, -1]))
        assert tok == int(torch.argmax(tl[0, -1]))
        idx = prompt.size + i
        jl, jc = jdec(jp, jnp.asarray([[tok]], jnp.int32), jc, jnp.asarray(idx, jnp.int32))
        tl, tc = tm.decode_step(tp, [[tok]], tc, [idx])
    _close(tc["s0"]["attn"]["k"], jc["s0"]["attn"]["k"])


def test_model_defaults_to_the_gpu():
    cfg = get_reduced("tinyllama-1.1b")
    if torch.cuda.is_available():
        assert Model(cfg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)


def test_bridge_defaults_to_the_gpu(models):
    """The bridge resolves its device as every entry point does: the card
    unless the caller asks for the CPU, and without a GPU the same error as
    ``build_model``."""
    jp = models[1]
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    tree = jax.tree.map(np.asarray, jp)
    if torch.cuda.is_available():
        tp = params_from_jax(cfg, tree)
        assert {t.device for t in tp.parameters()} == {torch.device("cuda", 0)}
        return
    with pytest.raises(RuntimeError) as want:
        build_model(cfg)
    with pytest.raises(RuntimeError) as got:
        params_from_jax(cfg, tree)
    assert str(got.value) == str(want.value)


def test_deepseek_training_on_the_card_waits_for_k1_bwd_at_192_128(monkeypatch):
    """(The name predates K1-bwd at 192/128, which training now takes.)
    deepseek-v2's expanded MLA runs flash attention at Dqk=192, Dv=128:
    off the CPU (meta tensors stand in for the card's), a call under
    autograd goes to the autograd function whose backward is the 192/128
    kernel (stubbed here: the kernels need the card), launching nothing
    before it and falling back to no plain version. Under no_grad the same
    call passes the input check."""
    from repro_torch.kernels import flash_attention as tfa

    cfg = get_reduced("deepseek-v2-236b").replace(
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    B, S, H = 1, 8, cfg.num_heads
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q, k = (torch.empty((B, S, H, dqk), device="meta", dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    v = torch.empty((B, S, H, cfg.v_head_dim), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    applied = []
    monkeypatch.setattr(tfa.FlashAttention, "apply", lambda *a: applied.append(a) or "applied")
    before = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    assert tfa.flash_attention(q, k, v, causal=True) == "applied" and len(applied) == 1
    assert (tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches) == before
    tfa._require_bwd_dims(q, v)  # the backward takes the pair
    with torch.no_grad():
        assert tfa.check_inputs(q, k, v, bshd=True) == S


@pytest.mark.parametrize(
    "causal,window,prefix_len",
    [(True, None, None), (True, 5, None), (True, None, 4), (True, 6, 3), (False, None, None)],
)
def test_prefill_mask_attend_matches_reference_bias(causal, window, prefix_len):
    """A prefill's mask travels as a description; the dense path builds its
    bias from it, and attends as the reference does from its explicit bias."""
    from repro.models.attention import attend as jax_attend
    from repro.models.common import causal_mask_bias as jax_causal_mask_bias
    from repro_torch.models.attention import PrefillMask, attend

    B, S, H, KV, Dh = 2, 11, 4, 2, 8
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)])
    pos = jnp.arange(S)
    if causal:
        bias = jax_causal_mask_bias(pos, pos, window=window, prefix_len=prefix_len)[None]
    else:
        bias = jnp.zeros((1, S, S), jnp.float32)
    want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias)
    mask = PrefillMask(causal=causal, window=window, prefix_len=prefix_len)
    got = attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
