"""Training the port's encoder-decoder (whisper-medium) and VLM
(paligemma-3b) on the CPU, against the reference ``repro`` on their reduced
configs at float32: one and three AdamW train steps (``Model.loss``,
autograd and ``adamw_update`` against ``jax.value_and_grad(model.loss)`` and
the reference's ``adamw_update``) on the same batch of tokens and frames or
patches, made with numpy from a seed by the train cells' data source
(``chip_smoke.EncDecVLMTokens``, loaded from the repo root); a ``Trainer``
run with that source, checkpointed and resumed exactly; K1's plain backward
at the cross-attention's shape (non-causal, Sq != Sk) and under the
prefix-LM span against the reference's VJP; and the train phases' launch
counts (``chip_smoke._launches_per_step``) and model FLOPs
(``analysis.roofline.step_model_flops``, which ``chip_smoke.py`` imports).
The kernels themselves run on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.attention import _attend_dense as jax_attend_dense
from repro.models.common import causal_mask_bias as jax_causal_mask_bias
from repro.models.lm import stack_plan as jax_stack_plan
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.analysis.roofline import step_model_flops, visible_pairs
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model
from repro_torch.models.lm import encoder_plan, stack_plan
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map, tree_unflatten

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the tolerances of tests/test_torch_train.py::test_train_steps_match_reference
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("whisper-medium", "paligemma-3b")
TEXT = 8  # text tokens a sample


def _pair(arch):
    jcfg = jax_get_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


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


def _assert_tree_close(port_tree, ref_tree):
    leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert leaves
    for path, ref in leaves:
        node = port_tree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(np.asarray(node), np.asarray(ref), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


# -- the data source ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_data_source_is_a_function_of_the_step(arch):
    cfg = get_reduced(arch)
    src = chip_smoke.EncDecVLMTokens(cfg, TEXT, 3, seed=5)
    a, b, c = src.batch(4), chip_smoke.EncDecVLMTokens(cfg, TEXT, 3, seed=5).batch(4), src.batch(5)
    extra = "frames" if cfg.is_encdec else "patches"
    shape = ((3, cfg.encoder_seq, cfg.d_model) if cfg.is_encdec
             else (3, cfg.num_image_tokens, cfg.vision_dim))
    assert set(a) == {"tokens", "targets", extra}
    assert a[extra].shape == shape and a[extra].dtype == np.float32
    assert a["tokens"].shape == a["targets"].shape == (3, TEXT)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a[extra], c[extra])
    # the tokens are SyntheticTokens' own
    np.testing.assert_array_equal(a["tokens"], src.tokens.batch(4)["tokens"])
    with pytest.raises(ValueError, match="frames or patches"):
        chip_smoke.EncDecVLMTokens(get_reduced("tinyllama-1.1b"), TEXT, 2)


# -- train steps against the reference ------------------------------------------------------

_TRAJ: dict = {}


def _trajectory(arch):
    """Three train steps of reduced ``arch`` in both packages on the data
    source's batches (loss, grad norm, and params and AdamW state after
    steps 1 and 3), with weight decay and the clip engaged."""
    if arch in _TRAJ:
        return _TRAJ[arch]
    jm, jp, tm, tp = _pair(arch)
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5)
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.1, grad_clip=0.5)
    src = chip_smoke.EncDecVLMTokens(tm.cfg, TEXT, 2, seed=0)

    @jax.jit
    def jstep(p, s, batch, lr):
        (loss, _), g = jax.value_and_grad(lambda q: jm.loss(q, batch), has_aux=True)(p)
        p, s, met = jax_adamw_update(jcfg, lr, p, g, s)
        return p, s, loss, met["grad_norm"]

    js, ts = jax_adamw_init(jcfg, jp), adamw_init(cfg, tp.tree())
    snaps = {}
    for step in range(3):
        batch = src.batch(step)
        lr = 1e-3 * (step + 1) / 3
        jp, js, jl, jn = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.float32(lr))
        loss, _ = tm.loss(tp, batch)
        tree = tp.tree()
        grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
        _, ts, met = adamw_update(cfg, lr, tree, grads, ts)
        np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jn), **TOL)
        assert float(jn) > 0.5  # the clip engaged
        if step in (0, 2):
            port = tree_map(lambda t: t.detach().numpy().copy(), {"params": tp.tree(), **ts})
            snaps[step + 1] = (
                {k: _stacked(tm.cfg, port[k]) for k in ("params", "m", "v", "master")},
                jax.tree.map(np.asarray, {"params": jp, "m": js["m"], "v": js["v"],
                                          "master": js["master"]}),
            )
    _TRAJ[arch] = snaps
    return snaps


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, steps):
    port, ref = _trajectory(arch)[steps]
    for part in ("params", "m", "v", "master"):
        _assert_tree_close(port[part], ref[part])


# -- the Trainer with frames or patches ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_runs_with_the_data_source_and_resumes_exactly(arch, tmp_path):
    """The unchanged Trainer with the cells' data source: finite losses and
    a final checkpoint; a run crashed at step 4 and restarted from the
    step-3 checkpoint ends with params and AdamW state equal to an
    uninterrupted run's bit for bit (the source is a function of the step)."""
    cfg = get_reduced(arch).replace(dtype="float32")
    base = dict(num_steps=6, checkpoint_every=3, log_every=1, global_batch=2, lr=1e-3, seed=2)

    def trainer(name, **kw):
        src = chip_smoke.EncDecVLMTokens(cfg, TEXT, 2, seed=2)
        return Trainer(cfg, TrainerConfig(**base, **kw), str(tmp_path / name), device="cpu",
                       data_source=src)

    with trainer("a") as tr:
        ref = tr.run(resume=False)
        assert tr.ckpt.steps()[-1] == 6
    rows = ref["metrics"]
    assert len(rows) == 6 and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                  for r in rows)
    assert rows[0]["tokens"] == 2 * TEXT  # the loss is over the text only
    with trainer("b", fail_at_step=4) as tr:
        out = tr.run_with_restarts(max_restarts=1)
    for tree_a, tree_b in ((ref["params"].tree(), out["params"].tree()), (ref["opt"], out["opt"])):
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert torch.equal(a, b)


# -- phase_train's gate that every leaf trained ----------------------------------------------


def _train_bf16(arch, tmp_path, trainer_cls=Trainer):
    """Two bf16 steps of reduced ``arch`` through the Trainer, as
    ``chip_smoke.phase_train`` drives the full model: the stale leaves it
    would report, and the leaves' keys."""
    cfg = get_reduced(arch).replace(dtype="bfloat16")
    src = (chip_smoke.EncDecVLMTokens(cfg, TEXT, 2, seed=0) if arch in chip_smoke.TRAIN_TEXT
           else None)
    tcfg = TrainerConfig(num_steps=2, checkpoint_every=10, log_every=1, global_batch=2,
                         seq_len=16, lr=1e-3, seed=0)
    with trainer_cls(cfg, tcfg, str(tmp_path), device="cpu", data_source=src) as tr:
        out = tr.run(resume=False)
        stale = chip_smoke._stale_leaves(out["params"], out["opt"], tr.model.init(tcfg.seed))
    return stale, [k for k, _ in tree_flatten_with_keys(out["params"].tree())]


@pytest.mark.parametrize("arch", [arch for arch, _ in chip_smoke.TRAIN_CELLS])
def test_every_train_cell_gives_every_leaf_a_gradient(arch, tmp_path):
    """No leaf of a train cell's model is cut off from the loss: after two
    steps every leaf's first moment holds a non-zero element, every master
    moved and every bf16 leaf is its master rounded."""
    stale, keys = _train_bf16(arch, tmp_path)
    assert stale["no_grad"] == stale["unchanged"] == stale["off_master"] == [], stale
    assert len(keys) > 20


def test_a_leaf_cut_off_from_its_gradient_fails_the_gate(tmp_path):
    """whisper's cross-attention K projection with its gradient zeroed (as a
    detached projection or a K1-bwd writing zero dK would leave it): weight
    decay still moves its master, so only the first moment shows it."""
    cut = "layers.s0.0.cross.wk"

    class CutTrainer(Trainer):
        def init_state(self):
            state = super().init_state()
            leaf = dict(tree_flatten_with_keys(state["params"].tree()))[cut]
            leaf.register_hook(torch.zeros_like)
            return state

    stale, keys = _train_bf16("whisper-medium", tmp_path, CutTrainer)
    assert stale["no_grad"] == [keys.index(cut)]
    assert stale["unchanged"] == stale["off_master"] == []


# -- K1's plain backward: cross-attention and the prefix span ----------------------------------

# (B, H, KV, Sq, Sk, Dh, causal, window, prefix_len)
PLAIN_BWD_CASES = {
    "cross non-causal Sq=7 Sk=13 Dh=16": (2, 4, 4, 7, 13, 16, False, None, None),
    "cross non-causal Sq=13 Sk=5 Dh=24 GQA": (1, 4, 2, 13, 5, 24, False, None, None),
    "prefix 5 Sq=Sk=13 Dh=16 MQA": (2, 4, 1, 13, 13, 16, True, None, 5),
    "prefix 4 window 3 Sq=Sk=12 Dh=24": (1, 4, 2, 12, 12, 24, True, 3, 4),
    "prefix = S Sq=Sk=9 Dh=16": (1, 2, 1, 9, 9, 16, True, None, 9),
}


@pytest.mark.parametrize("name", list(PLAIN_BWD_CASES))
def test_plain_backward_matches_reference_vjp(name):
    """What the backward kernel is held against on the card
    (``flash_attention_bwd_ref``) and the autograd function's CPU path,
    against ``jax.vjp`` of the reference's ``_attend_dense`` with the bias
    ``causal_mask_bias`` builds (zeros for the non-causal cases)."""
    B, H, KV, Sq, Sk, Dh, causal, window, prefix = PLAIN_BWD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh), (B, Sq, H, Dh)])
    if causal:
        bias = jax_causal_mask_bias(jnp.arange(Sq), jnp.arange(Sk), window=window,
                                    prefix_len=prefix)[None]
    else:
        bias = jnp.zeros((1, Sq, Sk), jnp.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_attend_dense(a, b, c, bias),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    mask = dict(causal=causal, window=window, prefix_len=prefix)
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_lse_ref(tq, tk, tv, **mask)
    plain = tfa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **mask)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = tfa.flash_attention_bwd.launches
    auto = torch.autograd.grad(tfa.flash_attention(*ts, **mask), ts, torch.from_numpy(do))
    assert tfa.flash_attention_bwd.launches == before  # the CPU path launches nothing
    for p, a, w in zip(plain, auto, want):
        np.testing.assert_allclose(p.transpose(1, 2).numpy(), w, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(a.numpy(), w, atol=2e-5, rtol=2e-5)


# -- what the train phases count ----------------------------------------------------------------

# K1 and K1-bwd launches a step with remat "full": every attention call's
# forward twice and its backward once; whisper's 24 encoder, 24 decoder
# self- and 24 cross-attention calls, paligemma's 18 layers
LAUNCHES = {
    "whisper-medium": {"flash_attention": 144, "flash_attention_bwd": 72, "ssd": 0, "ssd_bwd": 0},
    "paligemma-3b": {"flash_attention": 36, "flash_attention_bwd": 18, "ssd": 0, "ssd_bwd": 0},
    "tinyllama-1.1b": {"flash_attention": 44, "flash_attention_bwd": 22, "ssd": 0, "ssd_bwd": 0},
    "mamba2-1.3b": {"flash_attention": 0, "flash_attention_bwd": 0, "ssd": 96, "ssd_bwd": 48},
    "hymba-1.5b": {"flash_attention": 64, "flash_attention_bwd": 32, "ssd": 64, "ssd_bwd": 32},
    "granite-moe-1b-a400m": {"flash_attention": 48, "flash_attention_bwd": 24, "ssd": 0,
                             "ssd_bwd": 0},
}


@pytest.mark.parametrize("arch", list(LAUNCHES))
def test_launches_per_step(arch):
    assert chip_smoke._launches_per_step(get_config(arch)) == LAUNCHES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_count_frames_patches_and_the_text_head(arch):
    """``step_model_flops`` on the reduced config against the count written
    out from the reference's parameter tree: encoder parameters and the
    cross-attention's K and V projections over the frames, the vision
    projection over the patches, the tied head over the text, the rest over
    the decoder's positions; attention over the encoder's, the cross's and
    the decoder's (prefix-LM) visible pairs."""
    jm, jp, tm, tp = _pair(arch)
    cfg, B, S = tm.cfg, 3, 7
    F = cfg.encoder_seq if cfg.is_encdec else 0
    P = cfg.num_image_tokens if cfg.family == "vlm" else 0
    assert cfg.tie_embeddings
    n = {k: int(sum(np.asarray(x).size for x in jax.tree.leaves(v))) for k, v in jp.items()}
    enc = n.pop("enc_layers", 0) + n.pop("enc_norm", 0)
    cross_kv = 0
    if cfg.is_encdec:
        for g in jax_stack_plan(jax_get_reduced(arch)):
            cross_kv += jp["layers"][g.name]["cross"]["wk"].size
            cross_kv += jp["layers"][g.name]["cross"]["wv"].size
    vision = n.pop("vision_proj", 0)
    head = n.pop("embed")
    rest = sum(n.values()) - cross_kv
    param_flops = 6 * B * ((enc + cross_kv) * F + vision * P + head * S + rest * (P + S))
    Sd, H, Dh = P + S, cfg.num_heads, cfg.head_dim
    if cfg.is_encdec:
        pairs = (cfg.num_layers * Sd * (Sd + 1) // 2
                 + cfg.encoder_layers * F * F
                 + cfg.num_layers * Sd * F)
    else:  # every query sees the P patches, and the text causally
        pairs = cfg.num_layers * sum(max(q + 1, P) for q in range(Sd))
    flops, _, n_pos = step_model_flops(cfg, tp, B, S)
    assert n_pos * 6 * B == param_flops
    assert flops == param_flops + 6 * B * H * 2 * Dh * pairs


def test_model_flops_of_a_dense_model_are_six_n_per_token():
    """A decoder-only model: every parameter but the untied embedding table
    over each of the S positions, and the causal pairs."""
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    tp = build_model(cfg, device="cpu").init(0)
    B, S = 2, 11
    n = sum(p.numel() for p in tp.parameters()) - cfg.vocab_size * cfg.d_model
    assert not cfg.tie_embeddings
    flops, _, n_pos = step_model_flops(cfg, tp, B, S)
    assert n_pos == n * S
    attn = 6 * cfg.num_layers * B * cfg.num_heads * 2 * cfg.head_dim * S * (S + 1) // 2
    assert flops == 6 * n * B * S + attn


@pytest.mark.parametrize("case", [
    # (Sq, Sk, causal, window, prefix_len, pairs)
    (512, 512, True, None, 256, 163_968),  # paligemma's train cell
    (448, 1500, False, None, None, 448 * 1500),  # whisper's cross-attention
    (448, 448, True, None, None, 448 * 449 // 2),  # whisper's decoder
    (6, 6, True, 2, 3, 14),  # window 2 and span 3: q0..q5 see 3, 3, 2, 2, 2, 2 keys
])
def test_visible_pairs_and_the_backward_bound(case):
    Sq, Sk, causal, window, prefix, pairs = case
    assert visible_pairs(Sq, Sk, causal, window, prefix) == pairs
    mask = tfa._mask(Sq, Sk, causal, window, None, "cpu", prefix)
    assert int(mask.expand(Sq, Sk).sum()) == pairs
    B, H, KV, Dh = 4, 8, 1, 256
    ms, by = chip_smoke._attention_bwd_bound(B, H, KV, Sq, Sk, Dh, 2, 989e12, causal=causal,
                                             prefix_len=prefix, window=window)
    t_ops = 10 * B * H * Dh * pairs / 989e12
    nbytes = 2 * (4 * B * H * Sq * Dh + 4 * B * KV * Sk * Dh) + 4 * B * H * Sq
    assert ms == pytest.approx(1e3 * max(t_ops, nbytes / chip_smoke.PEAK_BYTES))
    assert by == ("operations" if t_ops >= nbytes / chip_smoke.PEAK_BYTES else "bytes")
