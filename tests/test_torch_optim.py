"""The port's AdamW (``repro_torch.optim``) against the reference's
``repro.optim`` and a literal numpy AdamW: the update, the clip, the f32
master, the decay mask and the cosine schedule (tolerance 1e-4 unless
stated)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # fallback shim; requirements-dev.txt pins the real one
    from repro.testing import given, settings, st

from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    decay_mask,
    global_norm,
)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_adamw(cfg, lr, params, grads, m, v, count):
    """Textbook AdamW (decoupled weight decay), f32."""
    count = count + 1
    gn = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
    scale = min(1.0, cfg.grad_clip / max(gn, 1e-12)) if cfg.grad_clip else 1.0
    out_p, out_m, out_v = {}, {}, {}
    for k in params:
        g = grads[k] * scale
        m1 = cfg.b1 * m[k] + (1 - cfg.b1) * g
        v1 = cfg.b2 * v[k] + (1 - cfg.b2) * g * g
        mhat = m1 / (1 - cfg.b1**count)
        vhat = v1 / (1 - cfg.b2**count)
        step = mhat / (np.sqrt(vhat) + cfg.eps)
        if params[k].ndim >= 2 and cfg.weight_decay:
            step = step + cfg.weight_decay * params[k]
        out_p[k] = params[k] - lr * step
        out_m[k], out_v[k] = m1, v1
    return out_p, out_m, out_v


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_matches_numpy_reference(wd):
    cfg = AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=1.0, keep_master=False)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = adamw_init(cfg, tp)
    m = {k: np.zeros_like(p) for k, p in params.items()}
    v = {k: np.zeros_like(p) for k, p in params.items()}
    np_p = dict(params)
    for step in range(5):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
        adamw_update(cfg, 1e-2, tp, {k: torch.from_numpy(g) for k, g in grads.items()}, state)
        np_p, m, v = numpy_adamw(cfg, 1e-2, np_p, grads, m, v, step)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np_p[k], atol=1e-5, rtol=1e-4)
    assert int(state["count"]) == 5


@pytest.mark.parametrize("wd, clip", [(0.0, 0.0), (0.1, 0.0), (0.1, 0.5), (0.0, 0.5)])
def test_matches_reference_adamw_update(wd, clip):
    """Three updates of a tree with a matrix, a vector and a layer list,
    with the f32 master, against the reference's ``adamw_update`` (whose
    layer group is stacked: the port's list counts the stacking dim)."""
    jcfg = JaxAdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    cfg = AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    rng = np.random.default_rng(1)
    w, b = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    norm = rng.standard_normal((2, 3)).astype(np.float32)  # a 2-layer group of 1-D leaves
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b), "layers": {"norm": jnp.asarray(norm)}}
    tp = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy()),
          "layers": [{"norm": torch.from_numpy(norm[i].copy())} for i in range(2)]}
    jstate, state = jax_adamw_init(jcfg, jp), adamw_init(cfg, tp)
    for step in range(3):
        gw, gb, gn = (rng.standard_normal(a.shape).astype(np.float32) for a in (w, b, norm))
        jg = {"w": jnp.asarray(gw), "b": jnp.asarray(gb), "layers": {"norm": jnp.asarray(gn)}}
        tg = {"w": torch.from_numpy(gw), "b": torch.from_numpy(gb),
              "layers": [{"norm": torch.from_numpy(gn[i])} for i in range(2)]}
        jp, jstate, jm = jax_adamw_update(jcfg, jnp.asarray(1e-2), jp, jg, jstate)
        _, state, tm = adamw_update(cfg, 1e-2, tp, tg, state)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
    for key in ("w", "b"):
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), **TOL)
        for part in ("m", "v", "master"):
            np.testing.assert_allclose(state[part][key].numpy(), np.asarray(jstate[part][key]),
                                       **TOL)
    got_norm = np.stack([layer["norm"].numpy() for layer in tp["layers"]])
    np.testing.assert_allclose(got_norm, np.asarray(jp["layers"]["norm"]), **TOL)


def test_grad_clip_engages():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0, keep_master=False)
    p = {"w": torch.zeros((4, 4))}
    huge = {"w": torch.full((4, 4), 1e6)}
    state = adamw_init(cfg, p)
    _, _, metrics = adamw_update(cfg, 1.0, p, huge, state)
    assert float(metrics["grad_norm"]) > 1e6
    assert float(p["w"].abs().max()) <= 1.001


def test_master_weights_carry_precision():
    """bf16 params + f32 master: tiny updates accumulate in the master."""
    cfg = AdamWConfig(lr=1e-5, weight_decay=0.0, grad_clip=0.0, keep_master=True)
    p = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
    state = adamw_init(cfg, p)
    assert state["master"]["w"].dtype == torch.float32
    assert state["m"]["w"].dtype == torch.float32 and state["v"]["w"].dtype == torch.float32
    g = {"w": torch.full((8, 8), 1e-3, dtype=torch.bfloat16)}
    master0 = state["master"]["w"].double().mean().item()
    for _ in range(3):
        adamw_update(cfg, 1e-5, p, g, state)
    assert state["master"]["w"].double().mean().item() < master0
    assert p["w"].dtype == torch.bfloat16


def test_decay_mask_counts_the_reference_stacking_dim():
    """The reference decays every leaf of ndim >= 2 as it holds it: a layer
    group's leaves are stacked, so its 1-D norm weights are decayed there,
    while the unstacked final norm and single-layer groups' vectors are not
    (ROADMAP F7); the port's mask follows it."""
    tree = {"final_norm": {"w": torch.zeros(4)}, "lm_head": torch.zeros((4, 5)),
            "layers": {"s0": [{"norm": torch.zeros(4)}, {"norm": torch.zeros(4)}],
                       "g1": {"norm": torch.zeros(4), "wq": torch.zeros((4, 4))}}}
    mask = decay_mask(tree)
    assert mask["final_norm"]["w"] is False and mask["lm_head"] is True
    assert [m["norm"] for m in mask["layers"]["s0"]] == [True, True]
    assert mask["layers"]["g1"] == {"norm": False, "wq": True}


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2500), st.integers(1, 100), st.integers(200, 2000))
def test_cosine_schedule_matches_reference(step, warmup, total):
    got = float(cosine_schedule(3e-4, warmup, total, min_frac=0.1)(step))
    want = float(jax_cosine_schedule(3e-4, warmup, total, min_frac=0.1)(jnp.asarray(step)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-12)


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 500), st.integers(10, 100), st.integers(200, 2000))
def test_cosine_schedule_properties(step, warmup, total):
    lr = float(cosine_schedule(1.0, warmup, total, min_frac=0.1)(step))
    assert 0.0 <= lr <= 1.0 + 1e-6
    if step >= total:
        assert lr == pytest.approx(0.1, rel=1e-3)
    if step < warmup:
        assert lr == pytest.approx(step / warmup, rel=1e-4)


def test_global_norm():
    t = {"a": torch.ones(3) * 2.0, "b": [torch.ones(4)]}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(12 + 4))


def test_update_reads_nothing_to_the_host(monkeypatch):
    """The update stays on the device: no ``.item()`` (a host sync on the
    card) anywhere in it."""
    cfg = AdamWConfig(grad_clip=1.0)
    p = {"w": torch.ones((3, 3))}
    state = adamw_init(cfg, p)

    def refuse(self):
        raise AssertionError("adamw_update read a value to the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    adamw_update(cfg, 1e-3, p, {"w": torch.ones((3, 3))}, state)


def test_jax_tree_of_reference_matches_port_leaf_order():
    """The reference flattens dicts in sorted key order; so do the port's
    trees, which the update zips leaf by leaf."""
    from repro_torch.tree import tree_flatten_with_keys

    tree = {"b": torch.zeros(1), "a": {"z": torch.zeros(1), "c": [torch.zeros(1)] * 2}}
    keys = [k for k, _ in tree_flatten_with_keys(tree)]
    jkeys = [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 {"b": 0, "a": {"z": 0, "c": [0, 0]}})[0]]
    assert keys == jkeys
