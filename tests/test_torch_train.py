"""The port's training path against the reference on the CPU (float32,
tolerance 1e-4 unless stated): cross-entropy, ``Model.loss`` and every
parameter's gradient on reduced tinyllama, mamba2 and hymba; one and three
AdamW train steps; the synthetic token stream; K1's backward plain version;
the reference's trainer and prefetcher tests, ported; and the guards that
keep a kernel output without a gradient out of autograd."""
import dataclasses
import glob
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import build_model as jax_build_model
from repro.models.lm import cross_entropy as jax_cross_entropy
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ThreadPool
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.models import build_model
from repro_torch.models.attention import PrefillMask, attend
from repro_torch.models.lm import cross_entropy, stack_plan
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
ARCHS = ("tinyllama-1.1b", "mamba2-1.3b", "hymba-1.5b")


def _pair(arch, **overrides):
    jcfg = jax_get_reduced(arch).replace(dtype="float32", **overrides)
    cfg = get_reduced(arch).replace(dtype="float32", **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


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


def _grads(tm, tp, batch):
    loss, metrics = tm.loss(tp, batch)
    tree = tp.tree()
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    return loss, metrics, tree_unflatten(tree, [g.numpy() for g in grads])


# -- cross-entropy ---------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32) * 3
    targets = rng.integers(0, 17, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    want, n_want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                     None if mask is None else jnp.asarray(mask))
    got, n = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(n) == float(n_want)


@pytest.fixture(scope="module")
def tiny_chunked():
    return _pair("tinyllama-1.1b")


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_matches_reference(tiny_chunked, masked):
    jm, jp, tm, tp = tiny_chunked
    rng = np.random.default_rng(1)
    d, V = tm.cfg.d_model, tm.cfg.vocab_size
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    targets = rng.integers(0, V, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.7).astype(np.float32) if masked else None
    want, n_want = jm._chunked_ce(jp, jnp.asarray(x), jnp.asarray(targets),
                                  None if mask is None else jnp.asarray(mask), 16)
    xt = torch.from_numpy(x).requires_grad_()
    got, n = tm._chunked_ce(tp, xt, torch.from_numpy(targets),
                            None if mask is None else torch.from_numpy(mask), 16)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    assert float(n) == float(n_want)
    # the recomputed chunks' gradient is the unchunked CE's over the same positions
    (gx,) = torch.autograd.grad(got, xt)
    xs = torch.from_numpy(x[:, :32]).requires_grad_()
    full, _ = cross_entropy(tm._head(tp, xs), torch.from_numpy(targets[:, :32]),
                            None if mask is None else torch.from_numpy(mask[:, :32]))
    (gfull,) = torch.autograd.grad(full, xs)
    np.testing.assert_allclose(gx[:, :32].numpy(), gfull.numpy(), atol=1e-6)
    assert float(gx[:, 32:].abs().max()) == 0.0  # past the last whole chunk: dropped


# -- loss and gradients -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    assert tm.cfg.remat == "full"  # each layer recomputed in the backward
    batch = _batch(tm.cfg.vocab_size)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True))(jp)
    loss, metrics, grads = _grads(tm, tp, batch)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jaux["ce"]), **TOL)
    assert float(metrics["aux"]) == 0.0 and float(metrics["tokens"]) == float(jaux["tokens"])
    _assert_tree_close(_stacked(tm.cfg, grads), jg, scaled=True)


def test_loss_without_remat_and_with_chunked_ce_matches_reference():
    jm, jp, tm, tp = _pair("tinyllama-1.1b", remat="none", loss_chunk=8)
    batch = _batch(tm.cfg.vocab_size, S=24, seed=3)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 24)) < 0.8).astype(np.float32)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True))(jp)
    loss, _, grads = _grads(tm, tp, batch)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    _assert_tree_close(_stacked(tm.cfg, grads), jg, scaled=True)


def test_params_are_trainable_and_serving_builds_no_graph():
    tm = build_model(get_reduced("tinyllama-1.1b").replace(dtype="float32"), device="cpu")
    tp = tm.init(seed=0)
    assert all(p.requires_grad for p in tp.parameters())
    logits, _ = tm.prefill(tp, {"tokens": np.zeros((1, 5), np.int32)})
    assert logits.grad_fn is None and not logits.requires_grad


# -- train steps ----------------------------------------------------------------------

_TRAJ: dict = {}


def _trajectory(wd):
    """Three train steps of reduced tinyllama in both packages (loss, grad
    norm, params, AdamW state after steps 1 and 3), with the clip engaged
    (grad_clip 0.5 below the grad norm)."""
    if wd in _TRAJ:
        return _TRAJ[wd]
    jm, jp, tm, tp = _pair("tinyllama-1.1b")
    jcfg = JaxAdamWConfig(lr=1e-3, weight_decay=wd, grad_clip=0.5)
    cfg = AdamWConfig(lr=1e-3, weight_decay=wd, grad_clip=0.5)
    src = SyntheticTokens(tm.cfg.vocab_size, 16, 2, seed=0)

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
        jp, js, jl, jn = jstep(jp, js, batch, jnp.float32(lr))
        loss, _ = tm.loss(tp, batch)
        tree = tp.tree()
        grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
        _, ts, met = adamw_update(cfg, lr, tree, grads, ts)
        np.testing.assert_allclose(float(loss), float(jl), **TOL)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jn), **TOL)
        assert float(jn) > 0.5  # the clip engaged
        if step in (0, 2):
            port = tree_map(lambda t: t.detach().numpy().copy(), {"params": tp.tree(), **ts})
            snaps[step + 1] = (
                {k: _stacked(tm.cfg, port[k]) for k in ("params", "m", "v", "master")},
                jax.tree.map(np.asarray, {"params": jp, "m": js["m"], "v": js["v"],
                                          "master": js["master"]}),
            )
    _TRAJ[wd] = snaps
    return snaps


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_train_steps_match_reference(wd, steps):
    port, ref = _trajectory(wd)[steps]
    for part in ("params", "m", "v", "master"):
        _assert_tree_close(port[part], ref[part])


def test_synthetic_tokens_equal_reference_step_for_step():
    a = SyntheticTokens(101, 16, 4, seed=3)
    b = JaxSyntheticTokens(101, 16, 4, seed=3)
    for step in (0, 1, 7, 1000):
        x, y = a.batch(step), b.batch(step)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["targets"], y["targets"])


# -- K1's backward, plain version -------------------------------------------------------

# (B, H, KV, Sq, Sk, Dh, causal, window, k_len): every row sees a key
BWD_SWEEP = {
    "mha": (1, 2, 2, 64, 64, 32, True, None, None),
    "gqa": (2, 4, 2, 48, 48, 16, True, None, None),
    "mqa": (1, 4, 1, 40, 40, 16, True, None, None),
    "window8": (1, 2, 2, 50, 50, 16, True, 8, None),
    "bidirectional": (1, 2, 2, 24, 24, 16, False, None, None),
    "k_len20": (1, 2, 1, 24, 32, 16, False, None, 20),
    "causal-k_len20": (1, 2, 1, 32, 32, 16, True, None, 20),
    "rect-sk40": (2, 4, 4, 16, 40, 16, False, None, None),
    "ragged-sq37": (1, 4, 2, 37, 37, 16, True, None, None),
}


def _qkv_do(case, seed):
    B, H, KV, Sq, Sk, Dh = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, H, Sq, Dh), (B, KV, Sk, Dh), (B, KV, Sk, Dh), (B, H, Sq, Dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", list(BWD_SWEEP))
def test_bwd_plain_version_matches_autograd_and_jax(name):
    case = BWD_SWEEP[name]
    mask = dict(zip(("causal", "window", "k_len"), case[6:]))
    q, k, v, do = _qkv_do(case, seed=len(name))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = tfa.flash_attention_lse_ref(tq.detach(), tk.detach(), tv.detach(), **mask)
    got = tfa.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o, lse,
                                      torch.from_numpy(do), **mask)
    auto = torch.autograd.grad(tfa.flash_attention_ref(tq, tk, tv, **mask), (tq, tk, tv),
                               torch.from_numpy(do))
    jgrad = jax.grad(lambda a, b, c: jnp.sum(jax_attention_ref(a, b, c, **mask) * do),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, a, j in zip(got, auto, jgrad):
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


def test_bwd_wrapper_takes_model_layout_on_cpu_uncounted():
    q, k, v, do = _qkv_do(BWD_SWEEP["gqa"], seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    before = tfa.flash_attention_bwd.launches
    o, lse = tfa.flash_attention_lse(*(x.transpose(1, 2) for x in t[:3]), bshd=True)
    got = tfa.flash_attention_bwd(*(x.transpose(1, 2) for x in t[:3]), o, lse,
                                  t[3].transpose(1, 2), bshd=True)
    want = tfa.flash_attention_bwd_ref(*t[:3], o.transpose(1, 2), lse, t[3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w.numpy(), atol=1e-6)
    assert tfa.flash_attention_bwd.launches == before  # the plain version is not a launch


def test_attend_under_grad_goes_through_the_autograd_function():
    q, k, v, _ = _qkv_do(BWD_SWEEP["gqa"], seed=6)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert tfa.flash_attention(tq, tk, tv, causal=True).grad_fn is None
    # the dense path of attend keeps its own autograd (decode biases)
    bias = PrefillMask().bias(tq.shape[1], tk.shape[1], CPU)
    assert attend(tq, tk, tv, bias).grad_fn is not None


def test_raw_launches_refuse_to_run_under_autograd():
    """K1's and K2's raw launches give outputs without a gradient, so under
    autograd they raise before touching any device."""
    q, k, v, _ = _qkv_do(BWD_SWEEP["mha"], seed=7)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with pytest.raises(RuntimeError, match="no gradient"):
        tfa._launch(tq, tk, tv, causal=True, window=None, k_len=tk.shape[2])
    x = torch.zeros((1, 8, 2, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tssd._launch(x, torch.ones((1, 8, 2)), -torch.ones(2), torch.zeros((1, 8, 8)),
                     torch.zeros((1, 8, 8)), chunk=8)


# -- the trainer (the reference's tests, ported) ----------------------------------------


def tiny_cfg():
    return ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=128, remat="none", dtype="float32",
    )


def test_tiny_cfg_is_the_reference_one():
    jcfg = JaxModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=128, remat="none", dtype="float32",
    )
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tiny_cfg())


def test_loss_decreases(tmp_path):
    tcfg = TrainerConfig(num_steps=30, checkpoint_every=100, log_every=1,
                         seq_len=32, global_batch=8, lr=3e-3)
    with Trainer(tiny_cfg(), tcfg, str(tmp_path / "ckpt"), device="cpu") as tr:
        out = tr.run(resume=False)
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
    assert all(np.isfinite(l) for l in losses)
    assert set(out["metrics"][0]) == {"loss", "ce", "aux", "tokens", "grad_norm", "lr", "step",
                                      "step_s"}
    assert all(m["step_s"] > 0 for m in out["metrics"])


def test_checkpoint_commit_and_gc(tmp_path):
    tcfg = TrainerConfig(num_steps=25, checkpoint_every=5, log_every=10,
                         seq_len=16, global_batch=4, keep_checkpoints=2)
    with Trainer(tiny_cfg(), tcfg, str(tmp_path / "ckpt"), device="cpu") as tr:
        tr.run(resume=False)
        steps = tr.ckpt.steps()
    assert len(steps) <= 2
    assert steps[-1] == 25
    assert not glob.glob(str(tmp_path / "ckpt" / "*.tmp"))


def test_failure_injection_restart_resumes_exactly(tmp_path):
    """Crash at step 12, restart, resume from the step-10 checkpoint; the
    final params, moments and master equal an uninterrupted run's bit for
    bit (deterministic data, kernels and optimizer)."""
    base = dict(num_steps=20, checkpoint_every=5, log_every=100,
                seq_len=16, global_batch=4, lr=1e-3, seed=7)
    with Trainer(tiny_cfg(), TrainerConfig(**base), str(tmp_path / "a"), device="cpu") as tr_a:
        ref = tr_a.run(resume=False)
    with Trainer(tiny_cfg(), TrainerConfig(**base, fail_at_step=12), str(tmp_path / "b"),
                 device="cpu") as tr_b:
        out = tr_b.run_with_restarts(max_restarts=2)
    for tree_a, tree_b in ((ref["params"].tree(), out["params"].tree()), (ref["opt"], out["opt"])):
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert torch.equal(a, b)


def test_watchdog_fires(tmp_path):
    tcfg = TrainerConfig(num_steps=5, seq_len=16, global_batch=4, heartbeat_timeout_s=0.0)
    with Trainer(tiny_cfg(), tcfg, str(tmp_path), device="cpu") as tr:
        tr._heartbeat -= 10  # pretend the last step was long ago
        with pytest.raises(TimeoutError):
            tr.run(resume=False)


def test_trainer_mesh_and_default_device(tmp_path):
    # the dense and GQA-MoE decoders train on a mesh (tests/test_torch_parallel.py);
    # the SSM family under a mesh waits for a later slice
    ssm = get_reduced("mamba2-1.3b").replace(dtype="float32")
    with pytest.raises(NotImplementedError, match="later slice"):
        Trainer(ssm, TrainerConfig(), str(tmp_path), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(tiny_cfg(), TrainerConfig(), str(tmp_path))


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu", "--steps", "3",
          "--seq", "16", "--batch", "2", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert out.count("loss") == 3
    assert (tmp_path / "ck" / "step_00000003" / "manifest.json").exists()


# -- the prefetcher (the reference's tests, ported) ----------------------------------------


def test_prefetcher_orders_and_resumes():
    src = SyntheticTokens(101, 8, 4, seed=2)
    with Prefetcher(src, depth=3, device="cpu") as pf:
        b0 = pf.get()
        b1 = pf.get()
        cursor = pf.cursor
    assert cursor == 2
    with Prefetcher(src, depth=2, start_step=cursor, device="cpu") as pf2:
        b2 = pf2.get()
    assert isinstance(b2["tokens"], torch.Tensor) and b2["tokens"].device == CPU
    np.testing.assert_array_equal(b2["tokens"].numpy(), src.batch(2)["tokens"])
    np.testing.assert_array_equal(b0["tokens"].numpy(), src.batch(0)["tokens"])
    np.testing.assert_array_equal(b1["tokens"].numpy(), src.batch(1)["tokens"])


def test_prefetcher_overlaps_slow_source():
    """The prefetcher runs the source's ``batch`` calls concurrently: each
    call is held until a second one is in flight beside it (a serial
    prefetcher would hold its first call for good), and the batches still
    come out in order. Counted, not timed, so a loaded host cannot fail it."""
    lock = threading.Lock()
    in_flight = {"now": 0, "most": 0}
    overlapped = threading.Event()

    class HeldSource:
        def batch(self, step):
            with lock:
                in_flight["now"] += 1
                in_flight["most"] = max(in_flight["most"], in_flight["now"])
                if in_flight["now"] >= 2:
                    overlapped.set()
            try:
                overlapped.wait(60)
            finally:
                with lock:
                    in_flight["now"] -= 1
            return {"x": np.full((2,), step)}

    with ThreadPool(4) as pool:
        with Prefetcher(HeldSource(), pool=pool, depth=4, device="cpu") as pf:
            for step in range(9):
                assert int(pf.get()["x"][0]) == step
    assert overlapped.is_set() and in_flight["most"] >= 2, in_flight


def test_prefetcher_close_cancels_and_drains():
    calls = []
    started = threading.Event()
    release = threading.Event()

    class SlowSource:
        def batch(self, step):
            calls.append(step)
            started.set()
            release.wait(60)
            return {"x": np.full((2,), step)}

    with ThreadPool(1) as pool:
        pf = Prefetcher(SlowSource(), pool=pool, depth=4, device="cpu")
        assert started.wait(60)
        assert calls == [0]
        queued = [pf._inflight[step] for step in (1, 2, 3)]

        def release_once_cancelled():
            # the running step 0 is let go only after close() has cancelled
            # the queued steps, whatever the host's load
            for _ in range(60000):
                if all(f.cancelled() for f in queued):
                    break
                time.sleep(0.001)
            release.set()

        threading.Thread(target=release_once_cancelled, daemon=True).start()
        pf.close()
        assert calls == [0]
        assert not pf._inflight
        assert pool.wait_idle(timeout=60)
        ok = []
        pool.run(lambda: ok.append(1))
        assert ok == [1]


def test_prefetcher_close_waits_for_running_task():
    done = []
    started = threading.Event()

    class Source:
        def batch(self, step):
            started.set()
            time.sleep(0.05)
            done.append(step)
            return {"x": np.full((2,), step)}

    pf = Prefetcher(Source(), depth=2, device="cpu")
    assert started.wait(60)  # a produce is running when close() comes
    pf.close()
    assert done, "running produce was abandoned instead of drained"


def test_prefetcher_backends():
    src = SyntheticTokens(101, 8, 4, seed=5)
    with Prefetcher(src, depth=2, backend="serial", put_fn=lambda b: b) as pf:
        np.testing.assert_array_equal(pf.get()["tokens"], src.batch(0)["tokens"])
    for backend in ("process", "socket"):
        with pytest.raises(NotImplementedError):
            Prefetcher(src, backend=backend, put_fn=lambda b: b)
    with ThreadPool(1) as tp:
        with pytest.raises(ValueError, match="not both"):
            Prefetcher(src, pool=tp, backend="thread", put_fn=lambda b: b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Prefetcher(src)
