"""The SSD scan's backward (``repro_torch.kernels.ssd``) on the CPU: the
plain version ``ssd_bwd_ref`` against autograd through the port's
``ssd_ref`` and against ``jax.vjp`` of the reference's oracle
``repro.models.ssm.ssd_reference``, for dx, ddt, dA, dB and dC (f32, each
gradient's largest error over max(1, its largest value) within 1e-4); the
autograd Function ``SSD``, which the scan and the SSM layer take under
autograd; the backward's first-launch check; and a plain-PyTorch emulation
of the bf16 kernels' arithmetic (``chip_smoke._ssd_bwd_emulation``: bf16
operands, f32 sums, f32 operands split into bf16 hi + lo parts, C·Bᵀ shared
by the heads, the scores summed over the heads, the rowsum − colsum form of
the gradient of the decays), held to the plain version within the on-card
gates beside a control that rounds the split operands once. The CUDA kernels
(``csrc/ssd_bwd.cu``) are held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro_torch.configs import get_reduced
from repro_torch.kernels import ssd as tssd
from repro_torch.models import build_model

# the bf16 design's emulation, which chip_smoke.py also reads on the card
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_ssd_bwd_emulation = chip_smoke._ssd_bwd_emulation

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = 1e-4  # scaled: |got - want| / max(1, max |want|)
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (B, S, H, P, N, chunk, with a final-state gradient)
CASES = {
    "four chunks": (1, 64, 2, 8, 8, 16, False),
    "ragged last chunk": (2, 37, 3, 8, 16, 16, False),
    "final-state gradient": (1, 40, 2, 16, 8, 16, True),
    "S < chunk": (2, 12, 2, 8, 16, 64, True),
    "H=5 sums dB and dC over heads": (2, 50, 5, 16, 24, 16, True),
}


def _inputs(seed, B, S, H, P, N):
    """x, B, C, dy ~ N(0, 1), dt = softplus(N(0, 1)), A = -exp(U[0, 1)),
    dfinal ~ N(0, 1), as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.uniform(0.0, 1.0, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dfinal = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dfinal


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd_and_jax_vjp(name):
    B, S, H, P, N, chunk, with_final = CASES[name]
    arrays, dy, dfinal = _inputs(len(name), B, S, H, P, N)
    if not with_final:
        dfinal = np.zeros_like(dfinal)
    t_in = [torch.from_numpy(a) for a in arrays]
    got = tssd.ssd_bwd_ref(*t_in, torch.from_numpy(dy),
                           torch.from_numpy(dfinal) if with_final else None, chunk=chunk)

    leaves = [t.clone().requires_grad_() for t in t_in]
    y, final = tssd.ssd_ref(*leaves, chunk=chunk, return_final_state=True)
    auto = torch.autograd.grad((y, final), leaves,
                               (torch.from_numpy(dy), torch.from_numpy(dfinal)))

    def f(*args):
        return jax_ssd_reference(*args, chunk=chunk, return_final_state=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))

    for label, g, a, j in zip(NAMES, got, auto, ref):
        assert g.dtype == torch.float32 and g.shape == a.shape, label
        assert _scaled(g.numpy(), a.numpy()) <= TOL, (name, label, _scaled(g.numpy(), a.numpy()))
        assert _scaled(g.numpy(), np.asarray(j)) <= TOL, (name, label, _scaled(g.numpy(), j))


def test_plain_backward_in_bf16_rounds_the_f32_gradients_once():
    """bf16 inputs: the gradients of x, B and C come back in bf16, within
    one rounding (2^-7 scaled) of autograd through the plain scan, which
    also computes in f32; dt's and A's stay f32."""
    arrays, dy, dfinal = _inputs(3, 2, 37, 3, 16, 16)
    bf16 = torch.bfloat16
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    x, Bm, Cm = x.to(bf16), Bm.to(bf16), Cm.to(bf16)
    dyt = torch.from_numpy(dy).to(bf16)
    got = tssd.ssd_bwd_ref(x, dt, A, Bm, Cm, dyt, chunk=16)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y = tssd.ssd_ref(*leaves, chunk=16)
    auto = torch.autograd.grad(y, leaves, dyt)
    assert [g.dtype for g in got] == [bf16, torch.float32, torch.float32, bf16, bf16]
    for label, g, a in zip(NAMES, got, auto):
        assert g.dtype == a.dtype, label
        assert _scaled(g.float().numpy(), a.float().numpy()) <= 2.0**-7, label


@pytest.mark.parametrize("use_final", [False, True])
def test_autograd_function_on_cpu_gives_the_plain_gradients(use_final):
    """``SSD.apply`` on CPU tensors: the plain scan forward, ``ssd_bwd_ref``
    backward; a final state left out of the loss counts as a zero gradient.
    Nothing is launched or counted."""
    arrays, dy, dfinal = _inputs(4, 2, 40, 3, 8, 16)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fwd0, bwd0 = tssd.ssd_bshp.launches, tssd.ssd_bwd.launches
    y, final = tssd.SSD.apply(*leaves, 16)
    assert type(y.grad_fn).__name__ == "SSDBackward"
    want_y, want_final = tssd.ssd_ref(*(t.detach() for t in leaves), chunk=16,
                                      return_final_state=True)
    assert torch.equal(y.detach(), want_y) and torch.equal(final.detach(), want_final)
    outs, grads = [y], [torch.from_numpy(dy)]
    if use_final:
        outs.append(final)
        grads.append(torch.from_numpy(dfinal))
    got = torch.autograd.grad(outs, leaves, grads)
    want = tssd.ssd_bwd_ref(*(t.detach() for t in leaves), torch.from_numpy(dy),
                            torch.from_numpy(dfinal) if use_final else None, chunk=16)
    for label, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), label
    assert (tssd.ssd_bshp.launches, tssd.ssd_bwd.launches) == (fwd0, bwd0)


def test_scan_under_grad_goes_through_the_autograd_function():
    arrays, _, _ = _inputs(5, 1, 20, 2, 8, 8)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    x.requires_grad_()
    y = tssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=8)
    assert type(y.grad_fn).__name__ == "SSDBackward"
    y, final = tssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=8, return_final_state=True)
    assert type(final.grad_fn).__name__ == "SSDBackward"
    with torch.no_grad():
        assert tssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=8).grad_fn is None
    # without an input that needs a gradient there is no graph to build
    assert tssd.ssd_bshp(x.detach(), dt, A, Bm, Cm, chunk=8).grad_fn is None


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_layers_train_through_the_autograd_function(arch, monkeypatch):
    """Under autograd every SSM layer's scan is ``SSD``: with remat "full"
    each layer's forward runs twice (the loss, then the recompute in the
    backward) and its backward once, as on the card, where those are the
    launches of the scan kernel and of the backward kernels."""
    cfg = get_reduced(arch).replace(dtype="float32")
    assert cfg.remat == "full"
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    calls = {"forward": 0, "backward": 0}
    apply, bwd = tssd.SSD.apply, tssd.ssd_bwd

    def counted_apply(*args):
        calls["forward"] += 1
        return apply(*args)

    def counted_bwd(*args, **kw):
        calls["backward"] += 1
        return bwd(*args, **kw)

    monkeypatch.setattr(tssd.SSD, "apply", counted_apply)
    monkeypatch.setattr(tssd, "ssd_bwd", counted_bwd)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    loss, _ = model.loss(params, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    loss.backward()
    assert calls == {"forward": 2 * cfg.num_layers, "backward": cfg.num_layers}
    ssm_leaves = [p for name, p in params.named_parameters() if ".ssm." in f".{name}."]
    assert ssm_leaves and all(p.grad is not None and p.grad.abs().sum() > 0 for p in ssm_leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_bwd_launch_check_raises_on_a_wrong_result(monkeypatch, dtype):
    """The backward's first-launch check holds all five gradients against
    the plain version: a launch whose dA is garbage raises (and the
    instantiation stays unchecked), a right one is remembered. The launch
    is stood in for on the CPU; on the card it is the kernels."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(tssd._bwd_guard, "checked", set())

    def wrong(*args, chunk):
        dx, ddt, dA, dB, dC = tssd.ssd_bwd_ref(*args, chunk=chunk)
        return dx, ddt, dA + 1e3, dB, dC

    monkeypatch.setattr(tssd, "_launch_bwd", wrong)
    with pytest.raises(RuntimeError, match="first-launch check failed"):
        tssd._check_first_bwd_launch(cpu, dtype)
    assert not tssd._bwd_guard.checked
    monkeypatch.setattr(tssd, "_launch_bwd",
                        lambda *args, chunk: tssd.ssd_bwd_ref(*args, chunk=chunk))
    tssd._check_first_bwd_launch(cpu, dtype)
    assert tssd._bwd_guard.checked == {(None, dtype)}


# -- the bf16 kernels' arithmetic ---------------------------------------------------------

BWD_ULP_TOL = 2.0  # chip_smoke.py's gate for the bf16 gradients, with 2^-7 scaled
F32_GRAD_TOL = 1e-4  # and for the f32 ones (ddt and dA), scaled

# (B, S, H, P, N, chunk, dt/A laws, with a final-state gradient)
EMULATION_CASES = {
    "chunk 256, model's dt/A": (1, 512, 4, 16, 32, 256, "model", True),
    "ragged, narrow heads, chunk 32": (2, 70, 3, 8, 16, 32, "wide", True),
    "hymba's N=16, chunk 64": (1, 300, 4, 16, 16, 64, "wide", False),
}


def _emulation_inputs(name):
    """The case's inputs, x, B, C and dy in bf16, by the case's dt/A laws
    (``tests/test_torch_gpu.py``'s): "model" is the model's init, log-uniform
    dt in [1e-3, 0.1) and A in [-16, -1), so the state carries across whole
    chunks; "wide" is dt = softplus(N(0, 1)), A = -exp(U[0, 1))."""
    B, S, H, P, N, chunk, laws, with_final = EMULATION_CASES[name]
    rng = np.random.default_rng(len(name))
    arrays, dy, dfinal = _inputs(len(name), B, S, H, P, N)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    if laws == "model":
        dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H)))).float()
        A = torch.from_numpy(-rng.uniform(1.0, 16.0, H)).float()
    bf16 = torch.bfloat16
    args = (x.to(bf16), dt, A, Bm.to(bf16), Cm.to(bf16), torch.from_numpy(dy).to(bf16),
            torch.from_numpy(dfinal) if with_final else None)
    return args, chunk


def _gate_readings(got, want):
    """(ulps of each bf16 gradient, scaled error of each gradient)."""
    pairs = list(zip(NAMES, got, want))
    ulps = {n: chip_smoke._ulps(g, w) for n, g, w in pairs if g.dtype == torch.bfloat16}
    scaled = {n: _scaled(g.float().numpy(), w.float().numpy()) for n, g, w in pairs}
    return ulps, scaled


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_bf16_bwd_design_with_split_operands_holds_the_ulp_gate(name):
    args, chunk = _emulation_inputs(name)
    want = tssd.ssd_bwd_ref(*args, chunk=chunk)
    got = _ssd_bwd_emulation(*args, chunk=chunk, split=True)
    ulps, scaled = _gate_readings(got, want)
    assert set(ulps) == {"dx", "dB", "dC"}
    for label in NAMES:
        assert torch.isfinite(got[NAMES.index(label)].float()).all(), label
        if label in ulps:
            assert ulps[label] <= BWD_ULP_TOL and scaled[label] <= 2.0**-7, (name, label, ulps,
                                                                             scaled)
        else:
            assert scaled[label] <= F32_GRAD_TOL, (name, label, scaled)


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_bf16_bwd_with_split_operands_rounded_once_fails_the_ulp_gate(name):
    """The control: the same products with each split operand rounded to
    one bf16 read well above the gate, in every bf16 gradient."""
    args, chunk = _emulation_inputs(name)
    want = tssd.ssd_bwd_ref(*args, chunk=chunk)
    ulps, _ = _gate_readings(_ssd_bwd_emulation(*args, chunk=chunk, split=False), want)
    assert min(ulps.values()) > BWD_ULP_TOL, (name, ulps)


@pytest.mark.parametrize("name", ["four chunks", "ragged last chunk", "H=5 sums dB and dC over heads"])
def test_restructured_f32_formulas_match_jax_vjp(name):
    """The bf16 design's formulas in f32 (shared C·Bᵀ, the scores summed over
    the heads, the rowsum − colsum gradient of the decays, the last row's
    term from the same numbers) against ``jax.vjp`` of the oracle."""
    B, S, H, P, N, chunk, with_final = CASES[name]
    arrays, dy, dfinal = _inputs(len(name), B, S, H, P, N)
    if not with_final:
        dfinal = np.zeros_like(dfinal)
    got = _ssd_bwd_emulation(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(dy),
                             torch.from_numpy(dfinal), chunk=chunk, split=None)

    def f(*args):
        return jax_ssd_reference(*args, chunk=chunk, return_final_state=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    for label, g, j in zip(NAMES, got, ref):
        assert g.dtype == torch.float32, label
        assert _scaled(g.numpy(), np.asarray(j)) <= TOL, (name, label, _scaled(g.numpy(), j))


def test_backward_design_names():
    assert tssd.DESIGN_BWD == {torch.bfloat16: "mma.sync-split", torch.float32: "fma-f32"}
