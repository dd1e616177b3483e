"""On-card tests of the port (marker ``gpu``): they skip without a CUDA
device and import nothing of JAX, so they run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA flash and SSD kernels are held against their plain versions, in
bf16 (the tensor-core designs) and f32 (the FMA designs), over shape sweeps
and tile edges, and small models served on the card are held against the
same weights decoded on the CPU. Flash attention's backward is held against
its plain version over the same sweeps; a train step of a small model on
the card against the same step on the CPU; and a restarted training run
against an uninterrupted one, bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.models import build_model
from repro_torch.models.lm import extend_caches
from repro_torch.serve import ServeEngine

# (B, H, KV, Sq, Sk, Dh, causal, window, k_len)
SWEEP = {
    "mha": (1, 2, 2, 128, 128, 64, True, None, None),
    "gqa": (2, 4, 2, 128, 128, 64, True, None, None),
    "mqa": (1, 8, 1, 256, 256, 32, True, None, None),
    "dh128": (1, 2, 2, 64, 64, 128, True, None, None),
    "window16": (1, 2, 2, 128, 128, 64, True, 16, None),
    "window100": (1, 2, 2, 300, 300, 64, True, 100, None),
    "bidirectional": (1, 2, 2, 64, 64, 32, False, None, None),
    "k_len100": (1, 2, 2, 64, 128, 32, False, None, 100),
    "rect-sk192": (2, 4, 4, 64, 192, 32, False, None, None),
    "ragged-sq100": (1, 4, 2, 100, 100, 32, True, None, None),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


# tile edges of both designs (bf16 tensor cores, f32 FMA tiles), one
# case each: a window across 18 key tiles, rectangular Sq < Sk, and the
# head dims other than 64 with ragged lengths
FLASH_EDGES = {
    "hymba H=25 KV=5, window 1024, Sq=Sk=1100": (1, 25, 5, 1100, 1100, 64, True, 1024, None),
    "rectangular Sq=64 Sk=192": (2, 4, 2, 64, 192, 64, False, None, None),
    "rectangular causal Sq=64 Sk=192": (1, 4, 2, 64, 192, 64, True, None, None),
    "Dh=32 ragged S=300": (1, 4, 2, 300, 300, 32, True, None, None),
    "Dh=128 ragged S=445": (1, 4, 2, 445, 445, 128, True, None, None),
}
FLASH_TOL = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 2e-2)}


def _flash_error(dev, rng, dt, case) -> float:
    """One launch in the model's layout against the plain version: max abs
    error; the launch is counted and its instantiation was first checked."""
    B, H, KV, Sq, Sk, Dh, causal, window, k_len = case
    shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh)]
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(dev, dt) for s in shapes)
    mask = dict(causal=causal, window=window, k_len=k_len)
    before = tfa.flash_attention_bhsd.launches
    got = tfa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bhsd.launches == before + 1
    assert (0, dt, Dh) in tfa._guard.checked  # its first launch was checked
    want = tfa.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   **mask).transpose(1, 2)
    assert torch.isfinite(got.float()).all()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version_on_card(dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for name, case in SWEEP.items():
        err = _flash_error(dev, rng, dt, case)
        assert err <= tol, (name, dtype, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FLASH_EDGES))
def test_flash_kernel_tile_edges_on_card(name, dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    err = _flash_error(dev, np.random.default_rng(5), dt, FLASH_EDGES[name])
    assert err <= tol, (name, dtype, err)


# (B, S, H, P, N, chunk, laws); x, B and C are handed over as the model's
# split views of one (B, S, H*P + 2N) activation. laws "wide": dt =
# softplus(N(0, 1)), A = -exp(U[0, 1)), so the state decays within a few rows;
# "model": the model's init laws (log-uniform dt in [1e-3, 0.1), A in
# [-16, -1)), so the state carries across whole chunks and the 32-row steps
SSD_SWEEP = {
    "mamba2 heads, ragged S=300, chunk 256": (1, 300, 64, 64, 128, 256, "wide"),
    "mamba2 heads, S=512, chunk 256, model's dt/A": (1, 512, 64, 64, 128, 256, "model"),
    "hymba heads, H=25 N=16, chunk 64": (1, 300, 25, 64, 16, 64, "wide"),
    "B=2 H=25 N=128, chunk 64": (2, 100, 25, 64, 128, 64, "wide"),
    "S < chunk 256": (1, 50, 4, 64, 128, 256, "wide"),
    "reduced mamba2, chunk 8": (2, 37, 8, 16, 16, 8, "wide"),
    "reduced hymba N=8, chunk 8": (1, 19, 4, 16, 8, 8, "wide"),
    "P=40 ragged P tile, N=24": (2, 70, 3, 40, 24, 32, "wide"),
    "B=2 H=5 P=32, chunk 64": (2, 130, 5, 32, 16, 64, "wide"),
}


def _dt_a(rng, B, S, H, laws):
    """dt (B, S, H) and A (H,) in float32 numpy, by the named laws."""
    if laws == "model":
        lo, hi = np.log(1e-3), np.log(1e-1)
        dt = np.exp(rng.uniform(lo, hi, (B, S, H)))
        return dt, -rng.uniform(1.0, 16.0, H)
    return np.log1p(np.exp(rng.standard_normal((B, S, H)))), -np.exp(rng.uniform(0.0, 1.0, H))


# tile edges of both designs: 18 chunks through the bf16 state-passing
# launch, chunk 8, P and N off the 16-wide MMA tile, and hymba's N=16
SSD_EDGES = {
    "S=1100 chunk 64, 18 chunks, model's dt/A": (1, 1100, 25, 64, 16, 64, "model"),
    "chunk 8, S=37": (2, 37, 8, 16, 16, 8, "wide"),
    "P=40 N=24, chunk 32": (2, 70, 3, 40, 24, 32, "wide"),
    "N=16, chunk 64, S=130": (2, 130, 5, 64, 16, 64, "wide"),
}
SSD_TOL = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 1e-2)}


def _ssd_errors(dev, rng, dt_, case) -> list:
    """One launch on the model's split views against the plain version:
    scaled errors of y and the final state; the launch is counted and its
    instantiation was first checked."""
    B, S, H, P, N, chunk, laws = case
    xbc = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N))).to(dev, dt_)
    x = xbc[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    dt, A = (torch.from_numpy(a).to(dev, torch.float32) for a in _dt_a(rng, B, S, H, laws))
    kw = dict(chunk=chunk, return_final_state=True)
    before = tssd.ssd_bshp.launches
    y, state = tssd.ssd_bshp(x, dt, A, Bm, Cm, **kw)
    torch.cuda.synchronize()
    assert tssd.ssd_bshp.launches == before + 1
    assert (0, dt_) in tssd._guard.checked  # its first launch was checked
    want_y, want_state = tssd.ssd_ref(x, dt, A, Bm, Cm, **kw)
    assert y.dtype == dt_ and state.dtype == torch.float32
    assert all(torch.isfinite(t.float()).all() for t in (y, state))
    return [tssd.scaled_error(y, want_y), tssd.scaled_error(state, want_state)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_version_on_card(dtype):
    dev = _cuda()
    dt_, tol = SSD_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    for name, case in SSD_SWEEP.items():
        errs = _ssd_errors(dev, rng, dt_, case)
        assert max(errs) <= tol, (name, dtype, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SSD_EDGES))
def test_ssd_kernel_tile_edges_on_card(name, dtype):
    dev = _cuda()
    dt_, tol = SSD_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = _ssd_errors(dev, np.random.default_rng(6), dt_, SSD_EDGES[name])
    assert max(errs) <= tol, (name, dtype, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_small_ssm_model_served_on_card_matches_cpu_decode(arch):
    """Every prefill on the card runs the SSD kernel once per layer (and
    hymba's the flash kernel too); the tokens equal the same weights'
    sequential decode on the CPU."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    # head_dim 32: the flash kernel is built for head dims 32, 64 and 128
    cfg = get_reduced(arch).replace(dtype="float32", head_dim=32)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(0)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 70, 13)]
    refs = []
    for prompt in prompts:
        logits, caches = cpu_model.prefill(params, {"tokens": prompt[None]})
        caches = extend_caches(caches, 96 - prompt.size, window=cfg.window)
        out = [int(torch.argmax(logits[0, -1]))]
        for i in range(5):
            logits, caches = cpu_model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
            out.append(int(torch.argmax(logits[0, -1])))
        refs.append(out)
    ssd0, fa0 = tssd.ssd_bshp.launches, tfa.flash_attention_bhsd.launches
    with ServeEngine(model, params.to(dev), max_slots=2, max_len=96, page_size=16) as engine:
        outs = engine.generate(prompts, 6, timeout=300)
    assert tssd.ssd_bshp.launches - ssd0 == cfg.num_layers * len(prompts)
    want_fa = cfg.num_layers * len(prompts) if cfg.attention == "gqa" else 0
    assert tfa.flash_attention_bhsd.launches - fa0 == want_fa
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


@pytest.mark.gpu
def test_small_model_served_on_card_matches_cpu_decode():
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    # head_dim 32: the kernel is built for head dims 32, 64 and 128
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", head_dim=32)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(0)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 70, 13)]
    refs = []
    for prompt in prompts:
        logits, caches = cpu_model.prefill(params, {"tokens": prompt[None]})
        caches = extend_caches(caches, 96 - prompt.size)
        out = [int(torch.argmax(logits[0, -1]))]
        for i in range(5):
            logits, caches = cpu_model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
            out.append(int(torch.argmax(logits[0, -1])))
        refs.append(out)
    before = tfa.flash_attention_bhsd.launches
    with ServeEngine(model, params.to(dev), max_slots=2, max_len=96, page_size=16) as engine:
        outs = engine.generate(prompts, 6, timeout=300)
    assert tfa.flash_attention_bhsd.launches - before == cfg.num_layers * len(prompts)
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


# -- training: K1's backward, the train step, a bit-exact restart ------------------------


def _bwd_error(dev, rng, dt, case) -> float:
    """One set of backward launches in the model's layout against the plain
    version: the largest error of dq, dk and dv, each over max(1, its
    largest value); the set is counted and its instantiation was checked."""
    B, H, KV, Sq, Sk, Dh, causal, window, k_len = case
    shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh), (B, Sq, H, Dh)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).to(dev, dt) for s in shapes)
    mask = dict(causal=causal, window=window, k_len=k_len)
    with torch.no_grad():
        o, lse = tfa.flash_attention_lse(q, k, v, bshd=True, **mask)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, bshd=True, **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert (0, dt, Dh) in tfa._bwd_guard.checked  # its first launch was checked
    want = tfa.flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                                       do.transpose(1, 2), **mask)
    errs = []
    for g, w in zip(got, want):
        w = w.transpose(1, 2).float()
        assert torch.isfinite(g.float()).all()
        errs.append((g.float() - w).abs().max().item() / max(1.0, w.abs().max().item()))
    return max(errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain_version_on_card(dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(11)
    for name, case in {**SWEEP, **FLASH_EDGES}.items():
        err = _bwd_error(dev, rng, dt, case)
        assert err <= tol, (name, dtype, err)


@pytest.mark.gpu
def test_autograd_goes_through_the_kernels_and_raw_launches_refuse():
    """Under autograd the model's flash call is the autograd Function, whose
    backward launches the backward kernels; the raw launches of K1 and K2
    and an SSM layer's forward raise rather than return an output without a
    gradient."""
    dev = _cuda()
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).to(dev, torch.float32)
                   for s in [(1, 70, 4, 32), (1, 70, 2, 32), (1, 70, 2, 32), (1, 70, 4, 32)])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd0, bwd0 = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    assert tfa.flash_attention_bhsd.launches == fwd0 + 1
    assert tfa.flash_attention_bwd.launches == bwd0 + 1
    with torch.no_grad():
        o, lse = tfa.flash_attention_lse_ref(*(t.transpose(1, 2) for t in (q, k, v)))
    want = tfa.flash_attention_bwd_ref(*(t.detach().transpose(1, 2) for t in (q, k, v)), o, lse,
                                       do.transpose(1, 2))
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w.transpose(1, 2), atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError, match="no gradient"):
        tfa._launch(q, k, v, causal=True, window=None, k_len=70, bshd=True)
    x = torch.zeros((1, 16, 2, 16), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tssd._launch(x, torch.ones((1, 16, 2), device=dev), -torch.ones(2, device=dev),
                     torch.zeros((1, 16, 16), device=dev), torch.zeros((1, 16, 16), device=dev),
                     chunk=16)
    cfg = get_reduced("mamba2-1.3b").replace(dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(0)
    with pytest.raises(NotImplementedError, match="backward"):
        model.loss(params, {"tokens": np.zeros((1, 8), np.int32),
                            "targets": np.zeros((1, 8), np.int32)})


def _train_cfg():
    # head_dim 32: the flash kernels are built for head dims 32, 64 and 128
    return get_reduced("tinyllama-1.1b").replace(dtype="float32", head_dim=32)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One step of reduced tinyllama (loss, autograd through both K1
    kernels, AdamW) on the card against the same step on the CPU."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.common import ParamTree
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg()
    batch = SyntheticTokens(cfg.vocab_size, 40, 2, seed=0).batch(0)
    ocfg = AdamWConfig(lr=1e-3, grad_clip=0.5)
    cpu_params = build_model(cfg, device="cpu").init(0)
    card_params = ParamTree(tree_map(lambda t: t.detach().to(dev), cpu_params.tree()))
    out = {}
    for device, params in (("cpu", cpu_params), (dev, card_params)):
        model = build_model(cfg, device=device)
        tree = params.tree()
        state = adamw_init(ocfg, tree)
        loss, _ = model.loss(params, batch)
        grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
        _, state, met = adamw_update(ocfg, 1e-3, tree, grads, state)
        out[str(device)] = (loss.item(), met["grad_norm"].item(),
                            [t.detach().cpu() for t in tree_leaves(tree)])
    (l0, n0, p0), (l1, n1, p1) = out.values()
    assert l1 == pytest.approx(l0, rel=1e-4) and n1 == pytest.approx(n0, rel=1e-4)
    for a, b in zip(p0, p1):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_restart_resumes_bit_exactly_on_card(tmp_path):
    """Crash at step 7, restart from the step-5 checkpoint: params and AdamW
    state equal an uninterrupted run's bit for bit (the backward kernels
    use no float atomics)."""
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    dev = _cuda()
    base = dict(num_steps=10, checkpoint_every=5, log_every=100, seq_len=32, global_batch=2,
                lr=1e-3, seed=3)
    with Trainer(_train_cfg(), TrainerConfig(**base), str(tmp_path / "a"), device=dev) as tr:
        ref = tr.run(resume=False)
    with Trainer(_train_cfg(), TrainerConfig(**base, fail_at_step=7), str(tmp_path / "b"),
                 device=dev) as tr:
        out = tr.run_with_restarts(max_restarts=1)
    pairs = [(ref["params"].tree(), out["params"].tree()), (ref["opt"], out["opt"])]
    for tree_a, tree_b in pairs:
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert a.device.type == "cuda" and torch.equal(a, b)
