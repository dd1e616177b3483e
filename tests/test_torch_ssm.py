"""The port's SSM and hybrid decoders (``repro_torch.models.ssm`` and the
``ssm``/``hybrid`` branches of ``models/blocks.py``) against the reference
``repro.models`` on reduced mamba2-1.3b and reduced hymba-1.5b at float32:
the reference's own ``Model.init(PRNGKey(0))`` parameters cross over through
numpy (``repro_torch.bridge.params_from_jax``), the same prompts go through
both, and prefill logits and the ``conv``/``state`` (and attention) caches,
eight greedy decode tokens and the per-lane batched decode step are
compared (atol = rtol = 1e-4). Also: the bridge keeps the reference's float32
leaves float32 in a bf16 model, and the port's own init draws them there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.lm import extend_caches as jax_extend_caches
from repro.models.ssm import ssm_apply as jax_ssm_apply
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.lm import extend_caches
from repro_torch.models.ssm import ssm_apply

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["mamba2-1.3b", "hymba-1.5b"]
SSM_F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _pair(arch, dtype="float32"):
    jcfg = jax_get_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _close_caches(t, j):
    """Cache trees of one batch-1 sequence. A ring's positions are one row
    per lane in the port, ``(..., 1, W)``, one row per call in the reference."""
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _close_caches(t[k].select(-2, 0) if k == "pos" else t[k], j[k])
    else:
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)


def test_prefill_logits_and_caches_match_reference(models):
    jm, jp, tm, tp = models
    toks = _prompt(0, 19, tm.cfg.vocab_size)[None]  # ragged against chunk 8
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    _close(tl, jl)
    _close_caches(tc, jc)
    for grp in tc.values():
        assert grp["ssm"]["state"].dtype == torch.float32


def test_greedy_decode_matches_reference(models):
    jm, jp, tm, tp = models
    prompt, width, steps = _prompt(2, 7, tm.cfg.vocab_size), 20, 8
    window = tm.cfg.window
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt[None])})
    jc = jax_extend_caches(jc, width - prompt.size, window=window)
    tl, tc = tm.prefill(tp, {"tokens": prompt[None]})
    tc = extend_caches(tc, width - prompt.size, window=window)
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
    _close_caches(tc, jc)


def test_per_lane_decode_matches_vmapped_reference(models):
    """Lanes at different positions in one batched step: each lane's conv
    window and state (and hymba's attention rows) are its own."""
    jm, jp, tm, tp = models
    width, lens = 16, (5, 9, 3)
    window = tm.cfg.window
    jcs, tcs, toks = [], [], []
    for i, n in enumerate(lens):
        prompt = _prompt(10 + i, n, tm.cfg.vocab_size)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])})
        jcs.append(jax_extend_caches(jc, width - n, window=window))
        _tl, tc = tm.prefill(tp, {"tokens": prompt[None]})
        tcs.append(extend_caches(tc, width - n, window=window))
        toks.append(int(jnp.argmax(jl[0, -1])))
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)  # (lanes, [L,] 1, ...)
    # the port's decode layout: lanes on the batch axis, after any layers axis
    lane_ax = {g: (1 if g.startswith("s") else 0) for g in tcs[0]}
    tcache = {
        g: jax.tree.map(lambda *xs, ax=lane_ax[g]: torch.cat(xs, dim=ax), *(c[g] for c in tcs))
        for g in tcs[0]
    }
    jstep = jax.jit(jax.vmap(jm.decode_step, in_axes=(None, 0, 0, 0)))
    idx = np.asarray(lens)
    for step in range(3):
        tok = np.asarray(toks, np.int32)
        jl, jcache = jstep(jp, jnp.asarray(tok[:, None, None]), jcache, jnp.asarray(idx + step))
        tl, tcache = tm.decode_step(tp, tok[:, None], tcache, idx + step)
        _close(tl, np.asarray(jl)[:, 0])
        for g, grp in tcache.items():
            for key in ("conv", "state"):
                got = grp["ssm"][key].movedim(lane_ax[g], 0)  # (lanes, [L,] ...)
                want = np.asarray(jcache[g]["ssm"][key])
                _close(got, want.squeeze(lane_ax[g] + 1))
        toks = [int(t) for t in torch.argmax(tl[:, -1], dim=-1)]


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_block_prefill_and_decode_match_reference(arch):
    """The SSM module alone, on the first layer's parameters: prefill output
    and cache, then one decode step through the cache."""
    cfg = get_reduced(arch).replace(dtype="float32")
    jm = jax_build_model(jax_get_reduced(arch).replace(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    g = next(iter(jp["layers"]))
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"][g]["ssm"]) if g.startswith("s") \
        else jp["layers"][g]["ssm"]
    tlayer = tp["layers"][g][0]["ssm"] if g.startswith("s") else tp["layers"][g]["ssm"]
    rng = np.random.default_rng(11)
    u = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jout, jcache = jax_ssm_apply(cfg, jlayer, jnp.asarray(u), return_cache=True)
    with torch.no_grad():  # the parameters are trainable: no graph for a parity read
        tout, tcache = ssm_apply(cfg, tlayer, torch.from_numpy(u), return_cache=True)
    _close(tout, jout)
    _close_caches(tcache, jcache)
    u1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = jax_ssm_apply(cfg, jlayer, jnp.asarray(u1), cache=jcache)
    with torch.no_grad():
        tout, none = ssm_apply(cfg, tlayer, torch.from_numpy(u1), cache=tcache)
    assert none is None  # decode wrote the window and the state in place
    _close(tout, jout)
    _close_caches(tcache, jcache)


def test_bridge_keeps_reference_float32_leaves_in_a_bf16_model():
    _jm, jp, tm, tp = _pair("mamba2-1.3b", dtype="bfloat16")
    jlayers = jp["layers"]["s0"]["ssm"]
    for i, layer in enumerate(tp["layers"]["s0"]):
        for name in SSM_F32_LEAVES:
            leaf = layer["ssm"][name]
            assert leaf.dtype == torch.float32, name
            assert torch.equal(leaf, torch.from_numpy(np.array(jlayers[name][i])))
        assert layer["ssm"]["in_proj"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_takes_each_leaf_dtype_from_the_ports_plan(arch):
    """An f32 reference tree bridged into a bf16 config gets the dtypes the
    port's own init gives: bf16 but for the SSM's f32 leaves."""
    cfg = get_reduced(arch).replace(dtype="bfloat16")
    jp = jax_build_model(jax_get_reduced(arch).replace(dtype="float32")).init(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    bridged = dict(params_from_jax(cfg, tree, device="cpu").named_parameters())
    own = dict(build_model(cfg, device="cpu").init(seed=0).named_parameters())
    assert bridged.keys() == own.keys()
    for name, leaf in own.items():
        assert (bridged[name].dtype, bridged[name].shape) == (leaf.dtype, leaf.shape), name
    assert {name.rsplit(".", 1)[-1] for name, leaf in own.items()
            if leaf.dtype == torch.float32} == set(SSM_F32_LEAVES)
    with pytest.raises(ValueError, match="the port declares"):
        params_from_jax(cfg.replace(d_model=cfg.d_model * 2), tree, device="cpu")


def test_init_draws_the_reference_laws_and_dtypes():
    cfg = get_reduced("mamba2-1.3b")  # bf16
    tm = build_model(cfg, device="cpu")
    params = tm.init(seed=1)
    ref = jax_build_model(jax_get_reduced("mamba2-1.3b")).abstract_params()
    layers = params["layers"]["s0"]
    assert len(layers) == cfg.num_layers
    for name, spec in ref["layers"]["s0"]["ssm"].items():
        leaf = layers[0]["ssm"][name]
        assert tuple(leaf.shape) == spec.shape[1:], name
        assert str(leaf.dtype).split(".")[-1] == str(spec.dtype), name
    a_log = torch.stack([lp["ssm"]["a_log"] for lp in layers])
    dt_bias = torch.stack([lp["ssm"]["dt_bias"] for lp in layers])
    assert (a_log >= 0).all() and (a_log < np.log(16.0)).all()  # A in [1, 16)
    dt = torch.nn.functional.softplus(dt_bias)
    assert (dt >= 0.001 * (1 - 1e-4)).all() and (dt <= 0.1 * (1 + 1e-4)).all()
    assert torch.equal(layers[0]["ssm"]["d_skip"], torch.ones_like(layers[0]["ssm"]["d_skip"]))
