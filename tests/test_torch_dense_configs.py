"""The head-dim-128 dense configs (phi4-mini-3.8b, qwen1.5-4b,
deepseek-coder-33b) through the port against the JAX package on the CPU,
float32, weights from the reference's ``Model.init(PRNGKey(0))`` crossed
over by ``repro_torch.bridge.params_from_jax``, inputs from a numpy seed.

- Serving: the port's ``ServeEngine`` (paged and flat KV, bucketed
  prefills) gives the same greedy tokens as the reference's sequential
  ``prefill`` + ``decode_step``, at each reduced config and again with
  ``head_dim=128``, the width the full configs give K1 (whose plain
  version stands in on CPU tensors).
- Training: the loss, every gradient and every leaf after 1 and 3 AdamW
  steps against the reference's ``jax.value_and_grad`` and ``adamw_update``
  (1e-4, as ``tests/test_torch_train.py``), with ``loss_chunk=8`` over S=32,
  so that phi4's tied head and qwen's QKV biases (drawn at random: the
  reference draws them as zeros) train through four chunks of the chunked
  cross-entropy.

The on-card forms of the same paths are ``chip_smoke.py``'s serve and
train phases of these configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.lm import extend_caches as jax_extend_caches
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.lm import stack_plan
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("phi4-mini-3.8b", "qwen1.5-4b", "deepseek-coder-33b")
# the engine's settings: two slots, KV capacity MAX_LEN, prompts padded to
# the buckets
MAX_LEN, PAGE, BUCKETS = 24, 4, (8, 16)
PROMPT_LENS, NEW = (5, 11, 14), 6
# the train cases: S over four chunks of the cross-entropy
S, CHUNK, B = 32, 8, 2


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


def _pair(arch, **overrides):
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


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


# -- serving ---------------------------------------------------------------------------

_SERVE: dict = {}


def _served(arch, head_dim):
    """The model pair at (arch, head_dim: None keeps the reduced config's)
    and the reference's greedy tokens for each prompt, by its sequential
    ``prefill`` and ``decode_step`` with the KV cache extended to the
    engine's MAX_LEN (so both mask the same positions)."""
    key = (arch, head_dim)
    if key not in _SERVE:
        jm, jp, tm, tp = _pair(arch, **({} if head_dim is None else {"head_dim": head_dim}))
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
        refs = []
        for prompt in _prompts(tm.cfg.vocab_size):
            logits, caches = prefill(jp, {"tokens": jnp.asarray(prompt[None])})
            caches = jax_extend_caches(caches, MAX_LEN - prompt.size)
            out = [int(jnp.argmax(logits[0, -1]))]
            for i in range(NEW - 1):
                logits, caches = decode(jp, jnp.asarray([[out[-1]]], jnp.int32), caches,
                                        jnp.asarray(prompt.size + i, jnp.int32))
                out.append(int(jnp.argmax(logits[0, -1])))
            refs.append(out)
        _SERVE[key] = (tm, tp, refs)
    return _SERVE[key]


@pytest.mark.parametrize("head_dim", [None, 128])
@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_reference_sequential_decode(arch, kv_layout, head_dim):
    tm, tp, refs = _served(arch, head_dim)
    if head_dim is not None:
        assert tm.cfg.head_dim == head_dim
    with ServeEngine(tm, tp, max_slots=2, max_len=MAX_LEN, page_size=PAGE,
                     prefill_buckets=BUCKETS, kv_layout=kv_layout, device="cpu") as engine:
        outs = engine.generate(_prompts(tm.cfg.vocab_size), [NEW] * len(PROMPT_LENS),
                               timeout=120)
        stats = engine.stats()
    assert [list(map(int, o)) for o in outs] == refs
    assert stats["completed"] == len(PROMPT_LENS)


# -- training ----------------------------------------------------------------------------


def _stacked(cfg, tree):
    """The port's per-layer lists stacked back into the reference's layout."""
    out = dict(tree)
    out["layers"] = dict(tree["layers"])
    for grp in stack_plan(cfg):
        if grp.kind == "scan":
            out["layers"][grp.name] = tree_map(lambda *xs: np.stack(xs),
                                               *tree["layers"][grp.name])
    return out


def _assert_tree_close(port_tree, ref_tree, scaled=False):
    """Every leaf of the reference tree against the port's (stacked) leaf;
    ``scaled`` reads the error against max(1, max |ref|)."""
    for path, ref in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = port_tree
        for p in path:
            node = node[p.key]
        ref = np.asarray(ref)
        if scaled:
            err = np.abs(np.asarray(node) - ref).max() / max(1.0, np.abs(ref).max())
            assert err <= TOL["atol"], (jax.tree_util.keystr(path), err)
        else:
            np.testing.assert_allclose(np.asarray(node), ref, **TOL,
                                       err_msg=jax.tree_util.keystr(path))


_TRAIN: dict = {}


def _trained(arch):
    """Loss and gradients of the first batch, then three AdamW steps (the
    clip engaged) in both packages: the port's and the reference's loss,
    gradients, and params, moments and masters after steps 1 and 3."""
    if arch in _TRAIN:
        return _TRAIN[arch]
    jm, jp, tm, tp = _pair(arch, loss_chunk=CHUNK)
    assert tm.cfg.remat == "full" and tm.cfg.loss_chunk == CHUNK
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5)
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5)
    src = SyntheticTokens(tm.cfg.vocab_size, S, B, seed=0)

    @jax.jit
    def jstep(p, s, batch, lr):
        (loss, _), g = jax.value_and_grad(lambda q: jm.loss(q, batch), has_aux=True)(p)
        p, s, met = jax_adamw_update(jcfg, lr, p, g, s)
        return p, s, loss, g, met["grad_norm"]

    js, ts = jax_adamw_init(jcfg, jp), adamw_init(cfg, tp.tree())
    out = {"steps": {}}
    for step in range(3):
        batch = src.batch(step)
        lr = 1e-3 * (step + 1) / 3
        jp, js, jl, jg, jn = jstep(jp, js, batch, jnp.float32(lr))
        loss, _ = tm.loss(tp, batch)
        tree = tp.tree()
        grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
        if step == 0:
            out["loss"] = (float(loss.detach()), float(jl))
            out["grads"] = (_stacked(tm.cfg, tree_map(lambda g: g.numpy(), grads)),
                            jax.tree.map(np.asarray, jg))
        _, ts, met = adamw_update(cfg, lr, tree, grads, ts)
        out["steps"].setdefault("loss", []).append((float(loss.detach()), float(jl)))
        out["steps"].setdefault("grad_norm", []).append((float(met["grad_norm"]), float(jn)))
        if step in (0, 2):
            port = tree_map(lambda t: t.detach().numpy().copy(), {"params": tp.tree(), **ts})
            out["steps"][step + 1] = (
                {k: _stacked(tm.cfg, port[k]) for k in ("params", "m", "v", "master")},
                jax.tree.map(np.asarray, {"params": jp, "m": js["m"], "v": js["v"],
                                          "master": js["master"]}),
            )
    _TRAIN[arch] = out
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_through_the_chunked_ce_match_reference(arch):
    got = _trained(arch)
    np.testing.assert_allclose(*got["loss"], **TOL)
    port, ref = got["grads"]
    _assert_tree_close(port, ref, scaled=True)
    if arch == "qwen1.5-4b":  # the random biases took a gradient
        assert all(np.abs(port["layers"]["s0"]["attn"][b]).max() > 0 for b in ("bq", "bk", "bv"))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_reference(arch, steps):
    got = _trained(arch)["steps"]
    for loss, jl in got["loss"]:
        np.testing.assert_allclose(loss, jl, **TOL)
    for norm, jn in got["grad_norm"]:
        np.testing.assert_allclose(norm, jn, **TOL)
        assert jn > 0.5  # the clip engaged
    port, ref = got[steps]
    for part in ("params", "m", "v", "master"):
        _assert_tree_close(port[part], ref[part])
