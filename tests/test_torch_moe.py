"""The port's MoE slice (``repro_torch.models.moe`` and the MoE decoders)
against the reference ``repro.models`` on the CPU at float32 (atol = rtol
= 1e-4): the configs, the router's weights, ids and aux loss, ``moe_dense``
with and without shared experts, ``Model.loss`` (ce, aux, total) and every
gradient against ``jax.value_and_grad``, prefill logits and caches and
greedy tokens on reduced granite-moe (KV heads zero-padded 2 -> 16, a tied
head) and deepseek-v2 (MLA, a leading dense layer, shared experts), the
serve engine's tokens against sequential decode in both KV layouts, and
the f32 router through the bridge. The reference's own
``Model.init(PRNGKey(0))`` parameters cross over through numpy
(``repro_torch.bridge.params_from_jax``); inputs come from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.lm import extend_caches as jax_extend_caches
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model, moe
from repro_torch.models.lm import extend_caches, stack_plan
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
_PAIRS: dict = {}


def _pair(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        jcfg = jax_get_reduced(arch).replace(dtype="float32", **overrides)
        cfg = get_reduced(arch).replace(dtype="float32", **overrides)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(cfg, device="cpu")
        tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _moe_group(cfg):
    return next(g for g in stack_plan(cfg) if g.moe)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_equal_the_reference(arch, reduced):
    get_j, get_t = (jax_get_reduced, get_reduced) if reduced else (jax_get_config, get_config)
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


def _layer_params(arch, layer=0):
    """One MoE layer's parameters in both packages: the reference's sliced
    out of its stacked group, the port's from its per-layer list."""
    jm, jp, tm, tp = _pair(arch)
    grp = _moe_group(tm.cfg)
    jl = jax.tree.map(lambda a: a[layer], jp["layers"][grp.name]["moe"])
    return tm.cfg, jl, tp["layers"][grp.name][layer]["moe"]


def _x(cfg, seed=0, B=2, S=7):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    cfg, jl, tl = _layer_params(arch)
    x = _x(cfg)
    jw, jids, jaux = jax_moe.route(cfg, jl, jnp.asarray(x))
    with torch.no_grad():
        tw, tids, taux = moe.route(cfg, tl, torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    _close(taux, jaux)
    assert tw.dtype == torch.float32 and taux.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_reference(arch):
    """Every expert on every token, gated; deepseek adds its shared experts."""
    cfg, jl, tl = _layer_params(arch, layer=1)
    assert ("shared" in tl) == (cfg.num_shared_experts > 0)
    x = _x(cfg, seed=1, B=3, S=5)
    jy, jaux = jax_moe.moe_dense(cfg, jl, jnp.asarray(x))
    with torch.no_grad():
        ty, taux = moe.moe_apply(cfg, tl, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)


def test_moe_is_per_token():
    """A token's output does not depend on the other tokens of the batch
    (the engine's pad tokens and lanes rely on it); only the aux loss,
    a batch statistic, does."""
    cfg, _jl, tl = _layer_params("granite-moe-1b-a400m")
    x = torch.from_numpy(_x(cfg, seed=2, B=2, S=6))
    with torch.no_grad():
        whole, _ = moe.moe_dense(cfg, tl, x)
        first, _ = moe.moe_dense(cfg, tl, x[:1, :3])
    torch.testing.assert_close(whole[:1, :3], first, atol=1e-6, rtol=1e-6)


def test_expert_parallel_waits_for_the_parallel_port():
    """The parallel port has landed: under a ctx ``moe_apply`` runs
    ``moe_ep``, which on one rank at a capacity where nothing drops equals
    ``moe_dense`` (the multi-rank cases: tests/test_torch_parallel.py)."""
    cfg, _jl, tl = _layer_params("granite-moe-1b-a400m")
    cfg = cfg.replace(capacity_factor=float(cfg.num_experts // cfg.experts_per_token))

    class Ctx:  # one rank: every collective is the identity
        expert_parallel, seq_sharded, n_model, model_rank, world = True, True, 1, 0, 1

        def gather(self, w):
            return w

        def take(self, w, dim):
            return w

        def world_sum(self, x):
            return x

        def model_all_to_all(self, x, split, concat):
            return x

    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(0))
    calls = []
    real = moe.moe_ep
    moe.moe_ep = lambda *a: calls.append(1) or real(*a)
    try:
        y, aux = moe.moe_apply(cfg, tl, x, ctx=Ctx())
    finally:
        moe.moe_ep = real
    want, want_aux = moe.moe_dense(cfg, tl, x)
    assert calls == [1]
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux, want_aux, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_f32_in_a_bf16_model(arch):
    """The router is an f32 leaf, as the SSM's ``a_log``: the bridge and the
    port's own init keep it f32 while the rest is bf16."""
    jcfg = jax_get_reduced(arch)
    cfg = get_reduced(arch)
    assert cfg.dtype == "bfloat16"
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    for params in (params_from_jax(cfg, tree, device="cpu"), build_model(cfg, "cpu").init(0)):
        layer = params["layers"][_moe_group(cfg).name][0]
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_gate"].dtype == torch.bfloat16
        assert layer["attn_norm"]["w"].dtype == torch.bfloat16


def test_a_large_leaf_is_drawn_in_pieces_with_the_same_law(monkeypatch):
    """A leaf above ``Init.CHUNK`` elements (deepseek-v2's stacked experts
    at full width) is drawn in pieces, so its f32 draw never holds the whole
    leaf: the same fan-in law and dtype, one seed one model."""
    from repro_torch.models.common import Init

    cfg = get_reduced("granite-moe-1b-a400m")
    monkeypatch.setattr(Init, "CHUNK", 1000)
    a, b = build_model(cfg, "cpu").init(0), build_model(cfg, "cpu").init(0)
    w = a["layers"]["s0"][0]["moe"]["w_gate"]  # a view of the (L, E, d, ff) leaf
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, b["layers"]["s0"][0]["moe"]["w_gate"])
    fan_in = cfg.num_layers * cfg.num_experts * cfg.d_model
    std = torch.stack([layer["moe"]["w_gate"] for layer in a["layers"]["s0"]]).float().std()
    assert abs(std.item() * fan_in**0.5 - 1.0) < 0.02


# -- the model ---------------------------------------------------------------------


def _stacked(cfg, tree):
    out = dict(tree)
    out["layers"] = dict(tree["layers"])
    for grp in stack_plan(cfg):
        if grp.kind == "scan":
            out["layers"][grp.name] = tree_map(lambda *xs: np.stack(xs),
                                               *tree["layers"][grp.name])
    return out


def _assert_grads_close(port_tree, ref_tree):
    """Each gradient's error read against max(1, max |ref|)."""
    for path, ref in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = port_tree
        for p in path:
            node = node[p.key]
        ref = np.asarray(ref)
        err = np.abs(np.asarray(node) - ref).max() / max(1.0, np.abs(ref).max())
        assert err <= TOL["atol"], (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_reference(arch, remat):
    jm, jp, tm, tp = _pair(arch, remat=remat)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True))(jp)
    loss, metrics = tm.loss(tp, batch)
    tree = tp.tree()
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    _close(loss.item(), float(jl))
    _close(metrics["ce"].item(), float(jaux["ce"]))
    _close(metrics["aux"].item(), float(jaux["aux"]))
    assert metrics["aux"].item() > 0.0
    _assert_grads_close(_stacked(tm.cfg, tree_unflatten(tree, [g.numpy() for g in grads])), jg)


def test_zero_padded_kv_heads_take_no_gradient():
    """granite's KV heads are zero-padded 2 -> 16 (query heads 4 -> 32):
    the pad is inert, so its weights get exactly zero gradient."""
    _jm, _jp, tm, tp = _pair("granite-moe-1b-a400m")
    cfg = tm.cfg
    assert (cfg.kv_heads_padded, cfg.heads_padded) == (16, 32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    loss, _ = tm.loss(tp, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    attn = tp["layers"]["s0"][0]["attn"]
    g = dict(zip(("wq", "wk", "wv", "wo"), torch.autograd.grad(
        loss, [attn["wq"], attn["wk"], attn["wv"], attn["wo"]])))
    assert not g["wk"][:, cfg.num_kv_heads:].any() and not g["wv"][:, cfg.num_kv_heads:].any()
    assert not g["wq"][:, cfg.num_heads:].any() and not g["wo"][cfg.num_heads:].any()
    assert g["wk"][:, : cfg.num_kv_heads].abs().max() > 0


def test_prefill_logits_and_caches_match_reference():
    jm, jp, tm, tp = _pair("granite-moe-1b-a400m")
    toks = _prompt(5, 11, tm.cfg.vocab_size)[None]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["s0"]["attn"][key], jc["s0"]["attn"][key])


def test_greedy_decode_matches_reference():
    jm, jp, tm, tp = _pair("granite-moe-1b-a400m")
    prompt, width, steps = _prompt(6, 7, tm.cfg.vocab_size), 18, 8
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


# -- serving -------------------------------------------------------------------------


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
def test_engine_matches_sequential_decode(kv_layout, buckets):
    """Continuous batching through the decode graph's body and, bucketed,
    the prefill graphs' (the pad tokens of a bucket never reach a real
    token: the MoE layer is per token, attention causal)."""
    _jm, _jp, model, params = _pair("granite-moe-1b-a400m")
    rng = np.random.default_rng(8)
    prompts = [_prompt(20 + i, int(n), model.cfg.vocab_size)
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
