"""On-card tests of the port (marker ``gpu``): they skip without a CUDA
device and import nothing of JAX, so they run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA flash and SSD kernels are held against their plain versions, in
bf16 (the tensor-core designs) and f32 (the FMA designs), over shape sweeps
and tile edges, and small models served on the card are held against the
same weights decoded on the CPU."""
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
