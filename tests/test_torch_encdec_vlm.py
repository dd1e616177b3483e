"""The port's encoder-decoder (whisper-medium) and VLM (paligemma-3b) against
the reference ``repro.models`` on their reduced configs at float32: the
reference's own ``Model.init(PRNGKey(0))`` parameters cross over through
numpy (``repro_torch.bridge.params_from_jax``, the encoder's layer groups,
LayerNorm biases, cross-attention and the vision projection included),
frames, patches and prompts come from numpy seeds, and the tolerance is
atol = rtol = 1e-4 throughout. Covered: ``layer_norm``, ``sinusoidal_emb``,
whisper's ``dense_mlp`` and ``_cross_attention`` (prefill and the static
decode cache), GQA attention under the bidirectional and prefix-LM masks,
prefill logits and every cache leaf, a per-lane ``decode_step`` against the
reference's decode vmapped over lanes, 8 greedy tokens, the loss (over the
VLM's text only) and every gradient against ``jax.grad``; K1's plain
versions with a prefix span and at Sq != Sk against the reference's
``_attend_dense``; and, on meta tensors standing in for the card's,
attention at 192/128 refusing autograd before any launch while 256/256 and
the prefix span take the backward kernel. Training these two models is
``tests/test_torch_encdec_vlm_train.py``; the CUDA kernels at 256/256 and
the models on the card are held by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.models.attention import _attend_dense as jax_attend_dense
from repro.models.attention import gqa_attention as jax_gqa_attention
from repro.models.common import causal_mask_bias as jax_causal_mask_bias
from repro.models.common import layer_norm as jax_layer_norm
from repro.models.lm import extend_caches as jax_extend_caches
from repro.models.lm import sinusoidal_emb as jax_sinusoidal_emb
from repro.models.mlp import dense_mlp as jax_dense_mlp
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import Model, build_model
from repro_torch.models import blocks
from repro_torch.models.attention import gqa_attention
from repro_torch.models.common import layer_norm
from repro_torch.models.lm import encoder_plan, extend_caches, sinusoidal_emb, stack_plan
from repro_torch.models.mlp import dense_mlp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("whisper-medium", "paligemma-3b")


def _pair(arch):
    jcfg = jax_get_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def whisper():
    return _pair("whisper-medium")


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL, err_msg=err_msg)


def _batch(cfg, seed, B, n):
    """Tokens, and the family's frames or patches, from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _stacked(cfg, tree):
    """The port's per-layer lists stacked back into the reference's layout."""
    out = dict(tree)
    for key, plan in (("layers", stack_plan(cfg)), ("enc_layers", encoder_plan(cfg))):
        if plan is None:
            continue
        out[key] = dict(tree[key])
        for grp in plan:
            if grp.kind == "scan":
                out[key][grp.name] = tree_map(lambda *xs: np.stack(xs), *tree[key][grp.name])
    return out


def _assert_tree_close(port_tree, ref_tree, scaled=False):
    """Every leaf of the reference tree against the port's; ``scaled`` reads
    the error against max(1, max |ref|)."""
    leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert leaves
    for path, ref in leaves:
        node = port_tree
        for p in path:
            node = node[p.key]
        ref, got = np.asarray(ref), np.asarray(node)
        assert got.shape == ref.shape, (jax.tree_util.keystr(path), got.shape, ref.shape)
        if scaled:
            err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
            assert err <= TOL["atol"], (jax.tree_util.keystr(path), err)
        else:
            _close(got, ref, err_msg=jax.tree_util.keystr(path))


# -- building blocks ---------------------------------------------------------------


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoidal_emb_matches_reference(d):
    pos = np.asarray([0, 1, 7, 12, 31, 63, 100], np.int32)
    _close(sinusoidal_emb(torch.from_numpy(pos), d), jax_sinusoidal_emb(jnp.asarray(pos), d))


def test_sinusoidal_emb_over_whisper_encoder_positions_matches_float64():
    """At whisper's 1500 encoder positions an angle reaches 1499 rad, where
    one f32 ulp is 1.2e-4: two f32 computations of the same formula (the
    reference's and the port's exp may differ by an ulp of the frequency)
    differ by that much. Held against the formula in float64 instead, within
    4 ulps of the largest angle."""
    d, half = 1024, 512
    pos = np.arange(1500)
    freqs = np.exp(-np.log(10_000.0) * np.arange(half) / (half - 1))
    ang = pos[:, None] * freqs[None, :]
    want = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    got = sinusoidal_emb(torch.from_numpy(pos), d).double().numpy()
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(1499.0))


def test_dense_mlp_matches_reference(whisper):
    """whisper's GELU MLP (``gelu_mlp``: w1, b1, w2, b2), with random biases
    so that they count."""
    jm, jp, tm, tp = whisper
    rng = np.random.default_rng(1)
    jmlp = {k: np.asarray(v[0]) for k, v in jp["layers"]["s0"]["mlp"].items()}
    jmlp["b1"] = rng.standard_normal(jmlp["b1"].shape).astype(np.float32)
    jmlp["b2"] = rng.standard_normal(jmlp["b2"].shape).astype(np.float32)
    x = rng.standard_normal((2, 6, tm.cfg.d_model)).astype(np.float32)
    want = jax_dense_mlp(jm.cfg, {k: jnp.asarray(v) for k, v in jmlp.items()}, jnp.asarray(x))
    got = dense_mlp(tm.cfg, {k: torch.from_numpy(v) for k, v in jmlp.items()},
                    torch.from_numpy(x))
    _close(got, want)


def test_cross_attention_matches_reference(whisper):
    """Prefill: queries over every encoder frame, returning the projected
    frames as the cache; decode: one query against that static cache."""
    jm, jp, tm, tp = whisper
    cfg = tm.cfg
    jcross = jax.tree.map(lambda a: a[1], jp["layers"]["s0"]["cross"])
    tcross = tp["layers"]["s0"][1]["cross"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    jy, jc = jax_blocks._cross_attention(jm.cfg, jcross, jnp.asarray(x), jnp.asarray(enc),
                                         return_cache=True)
    with torch.no_grad():
        ty, tc = blocks._cross_attention(cfg, tcross, torch.from_numpy(x), torch.from_numpy(enc),
                                         return_cache=True)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    x1 = x[:, -1:]
    jy1, _ = jax_blocks._cross_attention(jm.cfg, jcross, jnp.asarray(x1), None, cache=jc)
    with torch.no_grad():
        ty1, none = blocks._cross_attention(cfg, tcross, torch.from_numpy(x1), None, cache=tc)
    _close(ty1, jy1)
    assert none is None  # decode leaves the static cache as it is


@pytest.mark.parametrize("mask", ["bidirectional", "prefix 4", "prefix 4 window 3"])
def test_gqa_attention_masks_match_reference(mask):
    """The encoder's bidirectional mask and the VLM's prefix-LM span, as a
    prefill's mask description, against the reference's explicit bias."""
    jm, jp, tm, tp = _pair("paligemma-3b") if mask != "bidirectional" else _pair("whisper-medium")
    cfg = tm.cfg
    kw = {"bidirectional": True} if mask == "bidirectional" else {"prefix_len": 4}
    if "window" in mask:
        kw["window"] = 3
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["s0"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    jy, jc = jax_gqa_attention(jm.cfg, jattn, jnp.asarray(x), jnp.asarray(pos),
                               return_cache=True, **kw)
    with torch.no_grad():
        ty, tc = gqa_attention(cfg, tp["layers"]["s0"][0]["attn"], torch.from_numpy(x),
                               torch.from_numpy(pos), return_cache=True, **kw)
    _close(ty, jy)
    for key in jc:  # a window's ring keeps one row of positions per lane here
        _close(tc[key][0] if key == "pos" else tc[key], jc[key])


# -- whole models --------------------------------------------------------------------


def test_init_params_have_the_reference_shapes(models):
    jm, _jp, tm, _tp = models
    with torch.no_grad():
        ours = _stacked(tm.cfg, tree_map(lambda t: t.numpy(), tm.init(seed=3).tree()))
    ref = jm.abstract_params()
    assert set(ours) == set(ref)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        node = ours
        for p in path:
            node = node[p.key]
        assert tuple(np.shape(node)) == leaf.shape, jax.tree_util.keystr(path)
    if tm.cfg.norm == "ln":  # LayerNorm starts at weight 1, bias 0
        norm = ours["enc_norm"]
        assert bool((norm["w"] == 1).all()) and not norm["b"].any()


def test_prefill_logits_and_every_cache_leaf_match_reference(models):
    jm, jp, tm, tp = models
    batch = _batch(tm.cfg, 0, 2, 7)
    jl, jc = jax.jit(jm.prefill)(jp, _jax(batch))
    tl, tc = tm.prefill(tp, batch)
    _close(tl, jl)
    _assert_tree_close(tc, jc)
    if tm.cfg.is_encdec:
        assert tc["s0"]["cross"]["k"].shape[2] == tm.cfg.encoder_seq
    else:
        assert tc["s0"]["attn"]["k"].shape[2] == tm.cfg.num_image_tokens + 7


def test_cache_shapes_match_reference_and_prefill(models):
    """``cache_shapes`` (whisper's with the cross cache over its encoder
    frames) against the reference's, and against a prefill's caches grown
    to the same width."""
    jm, jp, tm, tp = models
    want = jax.tree.map(lambda sd: (tuple(sd.shape), str(sd.dtype)), jm.cache_shapes(2, 24))
    got = tree_map(lambda m: (tuple(m.shape), str(m.dtype).split(".")[-1]), tm.cache_shapes(2, 24))
    assert got == want
    _tl, tc = tm.prefill(tp, _batch(tm.cfg, 4, 2, 6))
    tc = extend_caches(tc, 24 - tc["s0"]["attn"]["k"].shape[2])
    assert tree_map(lambda t: tuple(t.shape), tc) == tree_map(lambda m: tuple(m.shape),
                                                              tm.cache_shapes(2, 24))


def test_greedy_decode_matches_reference(models):
    jm, jp, tm, tp = models
    batch, width, steps = _batch(tm.cfg, 1, 1, 6), 24, 8
    jl, jc = jax.jit(jm.prefill)(jp, _jax(batch))
    tl, tc = tm.prefill(tp, batch)
    S = tc["s0"]["attn"]["k"].shape[2]
    jc = jax_extend_caches(jc, width - S)
    tc = extend_caches(tc, width - S)
    jdec = jax.jit(jm.decode_step)
    jtoks, ttoks = [], []
    for i in range(steps):
        _close(tl[:, -1], jl[:, -1])
        jt, tt = int(jnp.argmax(jl[0, -1])), int(torch.argmax(tl[0, -1]))
        jtoks.append(jt)
        ttoks.append(tt)
        jl, jc = jdec(jp, jnp.asarray([[jt]], jnp.int32), jc, jnp.asarray(S + i, jnp.int32))
        tl, tc = tm.decode_step(tp, [[tt]], tc, [S + i])
    assert ttoks == jtoks
    _assert_tree_close(tc, jc)  # the static cross cache included


def test_per_lane_decode_matches_vmapped_reference(models):
    """Lanes at different positions in one batched step: each lane's
    position (RoPE, or whisper's sinusoidal embedding), cache write offset
    and valid length, and its own frames or patches."""
    jm, jp, tm, tp = models
    width, lens = 24, (5, 9, 3)
    jcs, tcs, toks, idx = [], [], [], []
    for i, n in enumerate(lens):
        batch = _batch(tm.cfg, 10 + i, 1, n)
        jl, jc = jm.prefill(jp, _jax(batch))
        _tl, tc = tm.prefill(tp, batch)
        S = tc["s0"]["attn"]["k"].shape[2]
        jcs.append(jax_extend_caches(jc, width - S))
        tcs.append(extend_caches(tc, width - S))
        toks.append(int(jnp.argmax(jl[0, -1])))
        idx.append(S)
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)  # (lanes, L, 1, ...)
    tcache = tree_map(lambda *cs: torch.cat(cs, dim=1), *tcs)  # (L, lanes, ...)
    jstep = jax.jit(jax.vmap(jm.decode_step, in_axes=(None, 0, 0, 0)))
    idx = np.asarray(idx)
    for step in range(3):
        tok = np.asarray(toks, np.int32)
        jl, jcache = jstep(jp, jnp.asarray(tok[:, None, None]), jcache, jnp.asarray(idx + step))
        tl, tcache = tm.decode_step(tp, tok[:, None], tcache, idx + step)
        _close(tl, np.asarray(jl)[:, 0])
        got = tree_map(lambda t: t.transpose(0, 1).numpy(), tcache)  # (lanes, L, ...)
        _assert_tree_close(got, jax.tree.map(lambda a: np.asarray(a)[:, :, 0], jcache))
        toks = [int(t) for t in torch.argmax(tl[:, -1], dim=-1)]


def test_loss_and_every_gradient_match_reference(models):
    """The training loss (the VLM's over its text only) and the gradient of
    every leaf, encoder, cross-attention and vision projection included,
    against ``jax.value_and_grad``."""
    jm, jp, tm, tp = models
    batch = _batch(tm.cfg, 5, 2, 8)
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    (jloss, _), jg = jax.value_and_grad(lambda p: jm.loss(p, _jax(batch)), has_aux=True)(jp)
    loss, metrics = tm.loss(tp, batch)
    tree = tp.tree()
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert float(metrics["tokens"]) == batch["targets"].size  # the text's positions only
    gtree = _stacked(tm.cfg, tree_unflatten(tree, [g.numpy() for g in grads]))
    _assert_tree_close(gtree, jg, scaled=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_model_defaults_to_the_gpu(arch):
    cfg = get_config(arch)
    assert Model(cfg, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert Model(cfg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)


@pytest.mark.parametrize("change", [
    dict(arch="whisper-medium", use_rope=True),
    dict(arch="whisper-medium", norm="rms"),
    dict(arch="paligemma-3b", norm="ln"),
    dict(arch="paligemma-3b", num_experts=4, experts_per_token=2),
])
def test_check_supported_takes_these_two_families_and_no_variant(change):
    change = dict(change)
    cfg = get_reduced(change.pop("arch")).replace(**change)
    with pytest.raises(NotImplementedError):
        Model(cfg, device="cpu")


# -- K1's plain versions: prefix span, Sq != Sk ----------------------------------------

# (B, H, KV, Sq, Sk, Dh, causal, window, prefix_len)
PLAIN_CASES = {
    "prefix 4 Dh=16 MQA": (2, 4, 1, 13, 13, 16, True, None, 4),
    "prefix 0 Dh=16": (1, 4, 1, 9, 9, 16, True, None, 0),
    "prefix = S Dh=24": (1, 4, 2, 11, 11, 24, True, None, 11),
    "prefix 5 window 3 Dh=24": (2, 4, 2, 12, 12, 24, True, 3, 5),
    "non-causal Sq=5 Sk=12 Dh=16": (2, 4, 4, 5, 12, 16, False, None, None),
    "non-causal Sq=12 Sk=5 Dh=24": (1, 4, 2, 12, 5, 24, False, None, None),
}


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_versions_match_reference_dense_attention(name):
    """``flash_attention_ref`` (what the CUDA kernel is held against) and
    ``attention_ref`` against the reference's ``_attend_dense`` with the
    bias ``causal_mask_bias`` builds (zeros for the non-causal cases)."""
    B, H, KV, Sq, Sk, Dh, causal, window, prefix = PLAIN_CASES[name]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh)])
    if causal:
        pos = jnp.arange(Sq)
        bias = jax_causal_mask_bias(pos, jnp.arange(Sk), window=window, prefix_len=prefix)[None]
    else:
        bias = jnp.zeros((1, Sq, Sk), jnp.float32)
    want = np.asarray(jax_attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    mask = dict(causal=causal, window=window, prefix_len=prefix)
    for fn in (tfa.flash_attention_ref, tfa.attention_ref):
        got = fn(tq, tk, tv, **mask).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=fn.__name__)
    # the model-layout wrapper takes them on a CPU tensor, uncounted
    before = tfa.flash_attention_bhsd.launches
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **mask)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert tfa.flash_attention_bhsd.launches == before


def test_plain_backward_with_a_prefix_span_matches_reference_vjp():
    """On the CPU the autograd function's backward is the plain one, with
    the prefix span."""
    B, H, KV, S, Dh, prefix = 1, 4, 1, 10, 16, 4
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in [(B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, S, H, Dh)])
    pos = jnp.arange(S)
    bias = jax_causal_mask_bias(pos, pos, prefix_len=prefix)[None]
    _, vjp = jax.vjp(lambda a, b, c: jax_attend_dense(a, b, c, bias),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=True, prefix_len=prefix)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def test_prefix_len_must_not_be_negative():
    q = torch.empty((1, 8, 4, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 8, 1, 64), device="meta", dtype=torch.bfloat16)
    assert tfa.check_inputs(q, k, k, bshd=True, prefix_len=8) == 8
    with pytest.raises(ValueError, match="prefix_len"):
        tfa.check_inputs(q, k, k, bshd=True, prefix_len=-1)


# (Dqk, Dv, prefix_len, what autograd on the card does): MLA's 192/128,
# gemma's 256/256 and the prefix span at every head dim take the backward
# kernel; an unequal pair the backward has no instantiation of raises
BWD_ON_CARD = {
    "192/128 trains": (192, 128, None, "trains"),
    "192/128 with a span trains": (192, 128, 256, "trains"),
    "256/128 raises": (256, 128, None, "raises"),
    "128/192 with a span raises": (128, 192, 256, "raises"),
    "256/256 with a span trains": (256, 256, 256, "trains"),
    "256/256 trains": (256, 256, None, "trains"),
    "64/64 with a span trains": (64, 64, 4, "trains"),
}


@pytest.mark.parametrize("name", list(BWD_ON_CARD))
def test_training_on_the_card_takes_256_and_a_prefix_and_refuses_192_128(name, monkeypatch):
    """Off the CPU (meta tensors stand in for the card's), a call under
    autograd at an unequal pair other than MLA's 192/128 raises before
    anything is launched and does not fall back to the plain version (the
    name is older than the 192/128 backward, which training now takes); at
    192/128 and 256/256, or with a prefix span, it goes to the autograd
    function (stubbed here: the kernels need the card) with the span in its
    mask. Under no_grad every case the forward takes passes the input
    check."""
    dqk, dv, prefix, does = BWD_ON_CARD[name]
    q = torch.empty((1, 320, 8, dqk), device="meta", dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty((1, 320, 1, dqk), device="meta", dtype=torch.bfloat16, requires_grad=True)
    v = torch.empty((1, 320, 1, dv), device="meta", dtype=torch.bfloat16, requires_grad=True)
    applied = []
    monkeypatch.setattr(tfa.FlashAttention, "apply", lambda *a: applied.append(a) or "applied")
    before = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    if does == "raises":
        with pytest.raises(NotImplementedError, match=fr"\({dqk}, {dv}\)"):
            tfa.flash_attention(q, k, v, causal=True, prefix_len=prefix)
        assert not applied
    else:
        assert tfa.flash_attention(q, k, v, causal=True, prefix_len=prefix) == "applied"
        assert applied[0][-1] == prefix
    assert (tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches) == before
    with torch.no_grad():
        if does == "raises":  # the forward has no instantiation of these pairs either
            with pytest.raises(ValueError, match="head dims"):
                tfa.check_inputs(q, k, v, bshd=True, prefix_len=prefix)
        else:
            assert tfa.check_inputs(q, k, v, bshd=True, prefix_len=prefix) == 320


def test_design_names_the_256_instantiation():
    assert tfa.design(torch.bfloat16, 256, 256) == "wgmma-wide"
    assert tfa.design(torch.float32, 256) == "fma-f32"
    assert 256 in tfa.HEAD_DIMS
    assert tfa.design_bwd(torch.bfloat16, 256) == "wgmma-split-2wg"
    assert tfa.design_bwd(torch.float32, 256) == "fma-f32"
    with pytest.raises(ValueError, match="head_dim"):
        tfa.design_bwd(torch.bfloat16, 192)
