"""On-card tests of the port (marker ``gpu``): they skip without a CUDA
device and import nothing of JAX, so they run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA flash and SSD kernels are held against their plain versions, in
bf16 (the tensor-core designs) and f32 (the FMA designs), over shape sweeps
and tile edges, and small models served on the card are held against the
same weights decoded on the CPU. Flash attention's backward is held against
its plain version over the same sweeps and its own tile edges, in bf16 also
in ulps, and two of its launches against each other bit for bit, and the
SSD scan's backward the same way (at mamba2's training shape beside a
control that rounds the bf16 design's split operands once); a train step
of each small model (tinyllama, mamba2, hymba) on the card against the
same step on the CPU; and a restarted training run against an
uninterrupted one, bit for bit. The trainer's CUDA graph: four bf16
``Trainer.run`` steps of one reduced model a family (dense, SSM, hybrid,
MoE, MLA, enc-dec, VLM) against four eager steps bit for bit, K1, K1-bwd,
K2 and K2-bwd captured at their launches a step, and a step that cannot
be captured raising (in a process of its own). The serve engine's CUDA graphs: a captured
decode tick against eager ``decode_step`` bit for bit (three families, both
cache layouts, f32 and bf16), an engine whose ticks and bucketed prefills
all replay graphs, a capture beside another engine's work on other threads,
and the first-launch guard refusing to run inside a capture; the
exact-length prefill graphs: a replayed prefill against its eager body bit
for bit (mamba2, hymba, both dtypes), a forced preemption whose resume
replays its length's graph, and captures beside another length's replays
on another thread. MLA's flash
attention at Dqk=192, Dv=128 against its plain version, forward and
backward (causal, with and without ``k_len``, B=1 and B=2 at ragged S, in
bf16 also in ulps and bit for bit), autograd at 192/128 through both
kernels while an unequal pair with no backward instantiation is refused,
a train step of reduced deepseek-v2 with its MLA widened to 192/128 on the
card against the CPU and two bf16 ``Trainer`` steps of it at depth 2 and
S=256, and reduced granite-moe and deepseek-v2
(2 layers, MLA at 192/128) served through the graphs against the same
weights decoded on the CPU. Flash attention at gemma's Dqk=Dv=256 with and
without a prefix-LM span swept across the tile edges, whisper's non-causal
forms up to Sk=1500, and small whisper and paligemma prefills and greedy
decodes on the card against the CPU. Flash attention's backward at 256/256
with the prefix span over the same edges, the span at the other head dims,
whisper's encoder and cross-attention (Sq=448 over Sk=1500), two launches
at 256 bit for bit, autograd at 256 and with a span through the kernels
(and at 192/128 with a span), and a train step of small whisper and
paligemma at head dim 256 on the card against the CPU. The forward's
bf16 design at the wide pairs ("wgmma-wide") over ragged S, k_len, GQA and
MQA, non-causal and windowed cases and the prefix span's edges, output and
lse, and two launches bit for bit at deepseek-v2's and paligemma's training
shapes. The sharded train step's graph on an NCCL world of one against
its eager body bit for bit, at most 6 host launches a replay. With four
cards, the parallel layer's and the pipeline's group checks over NCCL
against the CPU, and the sharded train, prefill and decode graphs against
their eager bodies bit for bit, every rank capturing the same launches."""
import copy
import importlib.util
import json
from pathlib import Path

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
    error; the launch is counted and its instantiation was first checked.
    A case's optional tenth entry is Dv (Dh if absent), its eleventh the
    prefix-LM span."""
    B, H, KV, Sq, Sk, Dh, causal, window, k_len = case[:9]
    Dv = case[9] if len(case) > 9 else Dh
    prefix_len = case[10] if len(case) > 10 else None
    shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dv)]
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(dev, dt) for s in shapes)
    mask = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix_len)
    before = tfa.flash_attention_bhsd.launches
    got = tfa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bhsd.launches == before + 1
    assert (0, dt, Dh, Dv) in tfa._guard.checked  # its first launch was checked
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


# cases held forward only here; (B, H, KV, Sq, Sk, Dqk,
# causal, window, k_len[, Dv[, prefix_len]]). MLA's expanded prefill: Dqk =
# 192 (128 nope + 64 rope), Dv = 128, on the kernel's own instantiation;
# whisper's forms at Dh=64 (non-causal with Sq != Sk up to its 1500 encoder
# frames, and the decoder's causal 32-token prompt on one ragged tile); the
# prefix-LM span on every design, and cross-attention at 256/256
FLASH_FWD_ONLY = {
    "deepseek H=KV=128 causal S=512": (1, 128, 128, 512, 512, 192, True, None, None, 128),
    "GQA ragged causal S=300": (1, 8, 2, 300, 300, 192, True, None, None, 128),
    "causal k_len=100 Sk=128": (2, 4, 4, 128, 128, 192, True, None, 100, 128),
    "non-causal Sq=64 Sk=192 k_len=150": (1, 4, 2, 64, 192, 192, False, None, 150, 128),
    "whisper cross Sq=32 Sk=1500 Dh=64": (4, 16, 16, 32, 1500, 64, False, None, None),
    "whisper encoder Sq=Sk=1500 Dh=64": (1, 16, 16, 1500, 1500, 64, False, None, None),
    "whisper decoder causal S=32 Dh=64": (4, 16, 16, 32, 32, 64, True, None, None),
    "cross Sq=70 Sk=1500 Dh=256 MQA": (1, 8, 1, 70, 1500, 256, False, None, None, 256),
    "prefix 100 S=300 Dh=64 GQA": (1, 4, 2, 300, 300, 64, True, None, None, 64, 100),
    "prefix 100 window 50 S=200 Dh=256": (1, 4, 1, 200, 200, 256, True, 50, None, 256, 100),
    "prefix 40 S=150 Dh=128": (1, 4, 2, 150, 150, 128, True, None, None, 128, 40),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(FLASH_FWD_ONLY))
def test_flash_kernel_forward_only_cases_on_card(name, dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    err = _flash_error(dev, np.random.default_rng(21), dt, FLASH_FWD_ONLY[name])
    assert err <= tol, (name, dtype, err)


def _autograd_at(dev, dqk, dv, prefix_len=None):
    """Attention under autograd on the card at (Dqk, Dv): the forward and
    backward launches it made and its gradients against the plain
    versions'."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k = (torch.randn((1, 70, 4, dqk), generator=g, device=dev).requires_grad_()
            for _ in range(2))
    v = torch.randn((1, 70, 4, dv), generator=g, device=dev).requires_grad_()
    before = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    out = tfa.flash_attention(q, k, v, causal=True, prefix_len=prefix_len)
    out.square().sum().backward()
    launches = (tfa.flash_attention_bhsd.launches - before[0],
                tfa.flash_attention_bwd.launches - before[1])
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    want = tfa.attention_ref(qt, kt, vt, causal=True, prefix_len=prefix_len)
    want.square().sum().backward()
    for t, w in ((q, qt), (k, kt), (v, vt)):
        torch.testing.assert_close(t.grad, w.grad.transpose(1, 2), atol=1e-4, rtol=1e-4)
    return launches


@pytest.mark.gpu
def test_flash_attention_at_192_128_trains_through_both_kernels_and_256_128_is_refused_on_card():
    """Under autograd on the card, K1 at MLA's 192/128 runs the forward
    kernel and its own backward instantiation, gradients within 1e-4 of the
    plain versions'; an unequal pair with no backward instantiation
    (256/128, which the forward does not take either) raises before any
    launch and falls back to nothing."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    assert _autograd_at(dev, 192, 128) == (1, 1)
    q, k = (torch.zeros((1, 16, 4, 256), device=dev, requires_grad=True) for _ in range(2))
    v = torch.zeros((1, 16, 4, 128), device=dev, requires_grad=True)
    before = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    with pytest.raises(NotImplementedError, match=r"\(256, 128\)"):
        tfa.flash_attention(q, k, v, causal=True)
    assert (tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches) == before


# gemma's head dim (paligemma: H=8 on one kv-head): S ragged and whole
# tiles, the prefix-LM span at 0, 1, 63, 64, 65 and S; (B, H, KV, Sq, Sk,
# Dh, causal, window, k_len, Dv, prefix_len)
FLASH_256_PREFIXES = (0, 1, 63, 64, 65, None)  # None: the span covers all of S
FLASH_256_SEQS = (130, 320)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", FLASH_256_SEQS)
def test_flash_kernel_at_256_with_prefix_span_on_card(S, dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(22)
    for prefix in FLASH_256_PREFIXES:
        prefix = S if prefix is None else prefix
        err = _flash_error(dev, rng, dt, (1, 8, 1, S, S, 256, True, None, None, 256, prefix))
        assert err <= tol, (S, prefix, dtype, err)


@pytest.mark.gpu
def test_flash_attention_at_192_128_with_a_prefix_trains_through_both_kernels_on_card():
    """With a prefix span too, autograd at 192/128 on the card runs both
    kernels once, gradients within 1e-4 of the plain versions'."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    assert _autograd_at(dev, 192, 128, prefix_len=20) == (1, 1)


# K1's wide pairs in bf16 ("wgmma-wide": two warpgroups a CTA, 64 q rows
# each, one 64-key K/V ring): ragged S (257, 300, 320, 445), k_len, GQA and
# MQA, non-causal, a window, and the prefix span at 0, 1, 63, 64, 65 and S
# (FLASH_256_PREFIXES) at each pair; at 128/128 the head layouts of
# phi4-mini, qwen1.5 and deepseek-coder (GQA groups 3, 1 and 7); (B, H, KV,
# Sq, Sk, Dqk, causal, window, k_len, Dv[, prefix_len])
FWD_WIDE = {
    "128/128 G=3 ragged S=445": (1, 6, 2, 445, 445, 128, True, None, None, 128),
    "128/128 G=1 B=2 S=257 k_len 200": (2, 4, 4, 257, 257, 128, True, None, 200, 128),
    "128/128 G=7 ragged S=300": (1, 14, 2, 300, 300, 128, True, None, None, 128),
    "128/128 G=3 window 33 S=161": (1, 6, 2, 161, 161, 128, True, 33, None, 128),
    "128/128 G=1 non-causal Sq=100 Sk=333": (1, 4, 4, 100, 333, 128, False, None, None, 128),
    "192/128 MHA B=2 ragged S=257": (2, 4, 4, 257, 257, 192, True, None, None, 128),
    "192/128 GQA ragged S=300": (1, 8, 2, 300, 300, 192, True, None, None, 128),
    "192/128 MQA S=320 k_len 200": (1, 8, 1, 320, 320, 192, True, None, 200, 128),
    "192/128 GQA non-causal Sq=100 Sk=333": (1, 4, 2, 100, 333, 192, False, None, None, 128),
    "192/128 GQA window 70 S=300": (1, 8, 2, 300, 300, 192, True, 70, None, 128),
    "256 GQA ragged S=257": (1, 4, 2, 257, 257, 256, True, None, None, 256),
    "256 MQA B=2 non-causal S=320 k_len 250": (2, 8, 1, 320, 320, 256, False, None, 250, 256),
    "256 MHA window 33 S=300": (1, 4, 4, 300, 300, 256, True, 33, None, 256),
    **{f"{dqk}/{dv} MQA S=320 prefix {'S' if span is None else span}":
       (1, 8, 1, 320, 320, dqk, True, None, None, dv, 320 if span is None else span)
       for dqk, dv in ((192, 128), (256, 256), (128, 128)) for span in FLASH_256_PREFIXES},
}
# the wide pairs' train cells' shapes: deepseek-v2's B=1 H=KV=128 S=2048,
# paligemma's B=4 H=8 KV=1 S=512 under its 256-token prefix span, and
# phi4-mini's B=4 H=48 KV=16 S=2048 (its KV heads padded 8 -> 16)
WIDE_TRAIN = {
    (192, 128): (1, 128, 128, 2048, 2048, 192, True, None, None, 128),
    (256, 256): (4, 8, 1, 512, 512, 256, True, None, None, 256, 256),
    (128, 128): (4, 48, 16, 2048, 2048, 128, True, None, None, 128),
}


def _fwd_lse_errors(dev, rng, case) -> tuple:
    """The bf16 forward and its lse (model layout) against the plain
    versions: (max abs error of the output, lse's error scaled by
    max(1, max |lse|))."""
    (q, k, v, _o, lse, _do), mask = _bwd_inputs(dev, rng, torch.bfloat16, case)
    o = tfa.flash_attention(q, k, v, **mask)
    o_want, lse_want = tfa.flash_attention_lse_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                                   **mask)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    o_err = (o.float() - o_want.transpose(1, 2).float()).abs().max().item()
    lse_err = (lse - lse_want).abs().max().item() / max(1.0, lse_want.abs().max().item())
    return o_err, lse_err


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FWD_WIDE))
def test_flash_wide_forward_matches_plain_version_on_card(name):
    """The wide pairs' bf16 forward ("wgmma-wide"; f32 keeps "fma-f32")
    against the plain version: the output within 2e-2 and the lse within
    1e-4 scaled, chip_smoke.py's tolerances, each launch counted."""
    dev = _cuda()
    case = FWD_WIDE[name]
    assert tfa.design(torch.bfloat16, case[5], case[9]) == "wgmma-wide"
    assert tfa.design(torch.float32, case[5], case[9]) == "fma-f32"
    before = tfa.flash_attention_bhsd.launches
    o_err, lse_err = _fwd_lse_errors(dev, np.random.default_rng(44), case)
    assert tfa.flash_attention_bhsd.launches == before + 2  # the lse's launch and the output's
    assert o_err <= 2e-2, (name, o_err)
    assert lse_err <= 1e-4, (name, lse_err)


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256), (128, 128)])
def test_flash_wide_forward_is_bitwise_repeatable_at_the_train_shapes_on_card(dqk, dv):
    """At the train cells' own shapes (:data:`WIDE_TRAIN`), two forward
    launches give the same output and lse bit for bit, the output within
    2e-2 of the plain version."""
    dev = _cuda()
    case = WIDE_TRAIN[(dqk, dv)]
    (q, k, v, o, lse, _do), mask = _bwd_inputs(dev, np.random.default_rng(45), torch.bfloat16,
                                               case)
    with torch.no_grad():
        o2, lse2 = tfa.flash_attention_lse(q, k, v, bshd=True, **mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = tfa.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), **mask)
    assert (o.float() - want.transpose(1, 2).float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dh,prefix", [(256, 70), (256, None), (64, 40)])
def test_autograd_at_256_or_with_a_prefix_goes_through_the_kernels_on_card(dh, prefix):
    """Under autograd at 256/256 or with a prefix span, the forward and the
    backward kernels run once each and the gradients match the plain
    versions'."""
    dev = _cuda()
    rng = np.random.default_rng(23)
    shapes = [(1, 150, 8, dh), (1, 150, 1, dh), (1, 150, 1, dh), (1, 150, 8, dh)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).to(dev, torch.float32)
                   for s in shapes)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd0, bwd0 = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    tfa.flash_attention(q, k, v, causal=True, prefix_len=prefix).backward(do)
    assert tfa.flash_attention_bhsd.launches == fwd0 + 1
    assert tfa.flash_attention_bwd.launches == bwd0 + 1
    mask = dict(causal=True, prefix_len=prefix)
    qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
    o, lse = tfa.flash_attention_lse_ref(qt, kt, vt, **mask)
    want = tfa.flash_attention_bwd_ref(qt, kt, vt, o, lse, do.transpose(1, 2), **mask)
    for t, w in zip((q, k, v), want):
        w = w.transpose(1, 2)
        assert (t.grad - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


def _encdec_vlm_inputs(cfg, rng, B, n):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides,launches_per_layer", [
    # whisper at the kernel's Dh=64 over 100 ragged encoder frames: each
    # prefill runs K1 in every encoder layer and twice (self, cross) in
    # every decoder layer
    ("whisper-medium", dict(head_dim=64, encoder_seq=100), None),
    # paligemma at Dh=256, 70 image tokens: the prefix span ends mid-tile
    ("paligemma-3b", dict(head_dim=256, num_image_tokens=70), 1),
])
def test_small_encdec_and_vlm_on_card_match_cpu(arch, overrides, launches_per_layer):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).replace(dtype="float32", **overrides)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(0)
    model = build_model(cfg, device=dev)
    card_params = copy.deepcopy(params).to(dev)  # Module.to moves in place
    batch = _encdec_vlm_inputs(cfg, np.random.default_rng(4), 2, 9)
    runs = []
    for m, p in ((cpu_model, params), (model, card_params)):
        before = tfa.flash_attention_bhsd.launches
        logits, caches = m.prefill(p, batch)
        launched = tfa.flash_attention_bhsd.launches - before
        S = caches["s0"]["attn"]["k"].shape[2]
        caches = extend_caches(caches, 8)
        toks, steps = [], [logits[:, -1].cpu()]
        for i in range(6):
            toks.append(torch.argmax(logits[:, -1], dim=-1).cpu())
            logits, caches = m.decode_step(p, toks[-1][:, None], caches, [S + i] * 2)
            steps.append(logits[:, -1].cpu())
        runs.append((launched, torch.stack(toks), torch.stack(steps)))
    (cpu_n, cpu_toks, cpu_logits), (n, toks, logits) = runs
    assert cpu_n == 0
    per_prefill = (cfg.encoder_layers + 2 * cfg.num_layers if launches_per_layer is None
                   else launches_per_layer * cfg.num_layers)
    assert n == per_prefill
    assert torch.equal(toks, cpu_toks)
    scale = max(1.0, cpu_logits.abs().max().item())
    assert (logits - cpu_logits).abs().max().item() <= 1e-4 * scale


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


# -- K2's backward ----------------------------------------------------------------------

SSD_BWD_TOL = 1e-4  # scaled, for f32 gradients: the f32 cases', and ddt and dA in bf16


def _ssd_bwd_inputs(dev, rng, dt_, case, with_final):
    """The forward's inputs as the model hands them over (split views),
    a random dy in x's dtype and, ``with_final``, a random f32 gradient of
    the final state."""
    B, S, H, P, N, chunk, laws = case
    xbc = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * N))).to(dev, dt_)
    x = xbc[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    dt, A = (torch.from_numpy(a).to(dev, torch.float32) for a in _dt_a(rng, B, S, H, laws))
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P))).to(dev, dt_)
    dfinal = None
    if with_final:
        dfinal = torch.from_numpy(rng.standard_normal((B, H, P, N))).to(dev, torch.float32)
    return (x, dt, A, Bm, Cm, dy, dfinal), chunk


def _ssd_bwd_check(dev, rng, dt_, case, with_final):
    """One set of backward launches against the plain version: each
    gradient's scaled error, and in bf16 the bf16 gradients' ulps; the set
    is counted and its instantiation was first checked."""
    args, chunk = _ssd_bwd_inputs(dev, rng, dt_, case, with_final)
    before = tssd.ssd_bwd.launches
    got = tssd.ssd_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_bwd.launches == before + 1
    assert (0, dt_) in tssd._bwd_guard.checked
    want = tssd.ssd_bwd_ref(*args, chunk=chunk)
    out = {}
    for label, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.isfinite(g.float()).all(), label
        scaled = tssd.scaled_error(g, w)
        if g.dtype == torch.bfloat16:
            assert scaled <= 2.0**-7 and _bf16_ulps(g, w) <= BWD_ULP_TOL, (label, scaled,
                                                                          _bf16_ulps(g, w))
        else:
            assert scaled <= SSD_BWD_TOL, (label, scaled)
        out[label] = scaled
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_kernel_matches_plain_version_on_card(dtype):
    """K2's backward over the forward's sweep and tile edges, with and
    without a final-state gradient: f32 gradients within 1e-4 scaled, bf16
    ones within 2^-7 scaled and 2 bf16 ulps of the plain f32 formulas."""
    dev = _cuda()
    dt_, _tol = SSD_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(21)
    for i, (name, case) in enumerate({**SSD_SWEEP, **SSD_EDGES}.items()):
        errs = _ssd_bwd_check(dev, rng, dt_, case, with_final=i % 2 == 1)
        assert errs, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_is_bitwise_repeatable_on_card(dtype):
    """No float atomics: two launches give the same five gradients bit for
    bit, the sums over heads, batch and sequence included."""
    dev = _cuda()
    dt_, _tol = SSD_TOL[dtype]
    rng = np.random.default_rng(22)
    for name in ("mamba2 heads, ragged S=300, chunk 256", "B=2 H=25 N=128, chunk 64"):
        args, chunk = _ssd_bwd_inputs(dev, rng, dt_, SSD_SWEEP[name], with_final=True)
        first = tssd.ssd_bwd(*args, chunk=chunk)
        second = tssd.ssd_bwd(*args, chunk=chunk)
        for label, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), first, second):
            assert torch.equal(a, b), (name, dtype, label)


@pytest.mark.gpu
def test_ssd_bwd_bf16_design_holds_the_ulp_gate_on_card():
    """The bf16 backward (tensor cores, the f32 operands split into bf16 hi
    + lo) at mamba2's training shape with the model's dt/A laws: within 2
    bf16 ulps and 2^-7 scaled of the plain f32 formulas (ddt and dA within
    1e-4 scaled), where the same design with its split operands rounded once
    (``chip_smoke._ssd_bwd_emulation``) reads above the gate."""
    dev = _cuda()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert tssd.DESIGN_BWD[torch.bfloat16] == "mma.sync-split"
    torch.backends.cuda.matmul.allow_tf32 = False
    case = (4, 2048, 64, 64, 128, 256, "model")
    args, chunk = _ssd_bwd_inputs(dev, np.random.default_rng(23), torch.bfloat16, case, False)
    got = tssd.ssd_bwd(*args, chunk=chunk)
    want = tssd.ssd_bwd_ref(*args, chunk=chunk)
    ctl = chip_smoke._ssd_bwd_emulation(*args, chunk=chunk, split=False)
    names = ("dx", "ddt", "dA", "dB", "dC")
    ulps, ctl_ulps = {}, {}
    for label, g, w, c in zip(names, got, want, ctl):
        assert torch.isfinite(g.float()).all(), label
        scaled = tssd.scaled_error(g, w)
        if g.dtype == torch.bfloat16:
            ulps[label], ctl_ulps[label] = _bf16_ulps(g, w), _bf16_ulps(c, w)
            assert scaled <= 2.0**-7, (label, scaled)
        else:
            assert scaled <= SSD_BWD_TOL, (label, scaled)
    assert max(ulps.values()) <= BWD_ULP_TOL, (ulps, ctl_ulps)
    assert min(ctl_ulps.values()) > BWD_ULP_TOL, (ulps, ctl_ulps)


# -- training: K1's backward, the train step, a bit-exact restart ------------------------


def _bwd_error(dev, rng, dt, case) -> float:
    """One set of backward launches in the model's layout against the plain
    version: the largest error of dq, dk and dv, each over max(1, its
    largest value); the set is counted and its instantiation was checked.
    A case's optional tenth entry is Dv (Dh if absent), its eleventh the
    prefix-LM span."""
    args, mask = _bwd_inputs(dev, rng, dt, case)
    q, k, v, o, lse, do = args
    Dh, Dv = q.shape[-1], v.shape[-1]
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert (0, dt, Dh, Dv) in tfa._bwd_guard.checked  # its first launch was checked
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


# tile edges of the bf16 backward's design (64-key and 64-row tiles, 32-row
# streamed tiles at Dh=128): one tile short of 64, k_len in the middle of a
# key tile, a window edge inside a tile, ragged lengths at every head dim
BWD_EDGES = {
    "S=40 < one tile": (1, 4, 2, 40, 40, 64, True, None, None),
    "k_len=100 mid-tile Sk=192": (1, 4, 2, 192, 192, 64, True, None, 100),
    "window 70 S=200": (1, 4, 2, 200, 200, 64, True, 70, None),
    "window 33 Dh=128 S=161": (1, 4, 1, 161, 161, 128, True, 33, None),
    "Dh=32 ragged S=97 MQA": (2, 4, 1, 97, 97, 32, True, None, None),
    "bidirectional k_len=50 Dh=128 Sq=70 Sk=130": (1, 2, 2, 70, 130, 128, False, None, 50),
}
BWD_ULP_TOL = 2.0  # chip_smoke.py's gate


def _bf16_ulps(got, want) -> float:
    """Largest error in bf16 ulps of each plain entry, entries under 2^-8 of
    the largest counted at that floor's ulp (chip_smoke.py's measure)."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() * 2.0**-8)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return ((got.float() - w).abs() / ulp).max().item()


def _bwd_inputs(dev, rng, dt, case):
    B, H, KV, Sq, Sk, Dh, causal, window, k_len = case[:9]
    Dv = case[9] if len(case) > 9 else Dh
    prefix_len = case[10] if len(case) > 10 else None
    shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dv), (B, Sq, H, Dv)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)).to(dev, dt) for s in shapes)
    mask = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix_len)
    with torch.no_grad():
        o, lse = tfa.flash_attention_lse(q, k, v, bshd=True, **mask)
    return (q, k, v, o, lse, do), mask


@pytest.mark.gpu
def test_flash_bwd_bf16_design_holds_the_ulp_gate_on_card():
    """The bf16 backward (tensor cores, P and dS split into hi + lo) over
    the sweep, the forward's tile edges and its own: within 2 bf16 ulps and
    2^-7 scaled of the plain f32 formulas."""
    dev = _cuda()
    rng = np.random.default_rng(13)
    for name, case in {**SWEEP, **FLASH_EDGES, **BWD_EDGES}.items():
        assert "-split" in tfa.design_bwd(torch.bfloat16, case[5])
        args, mask = _bwd_inputs(dev, rng, torch.bfloat16, case)
        got = tfa.flash_attention_bwd(*args, bshd=True, **mask)
        q, k, v, o, lse, do = args
        want = tfa.flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                                           do.transpose(1, 2), **mask)
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            w = w.transpose(1, 2)
            assert torch.isfinite(g.float()).all(), (name, label)
            scaled = (g.float() - w.float()).abs().max().item() / max(
                1.0, w.float().abs().max().item())
            assert scaled <= 2.0**-7, (name, label, scaled)
            assert _bf16_ulps(g, w) <= BWD_ULP_TOL, (name, label, _bf16_ulps(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_bitwise_repeatable_on_card(dtype):
    """No float atomics: two launches on the same inputs give the same
    dq, dk and dv bit for bit, GQA and the tile edges included."""
    dev = _cuda()
    dt, _tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(14)
    for name in ("gqa", "window100", "ragged-sq100"):
        args, mask = _bwd_inputs(dev, rng, dt, SWEEP[name])
        first = tfa.flash_attention_bwd(*args, bshd=True, **mask)
        second = tfa.flash_attention_bwd(*args, bshd=True, **mask)
        for label, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (name, dtype, label)


# deepseek-v2's training attention at Dqk=192, Dv=128 (K1-bwd's own
# instantiation): causal, with and without k_len, B=1 and B=2 at ragged S;
# (B, H, KV, Sq, Sk, Dqk, causal, window, k_len, Dv)
BWD_192_128 = {
    "B=1 H=KV=16 S=512": (1, 16, 16, 512, 512, 192, True, None, None, 128),
    "B=1 GQA ragged S=300": (1, 8, 2, 300, 300, 192, True, None, None, 128),
    "B=2 ragged S=257": (2, 8, 8, 257, 257, 192, True, None, None, 128),
    "B=2 ragged S=257 k_len=200": (2, 8, 8, 257, 257, 192, True, None, 200, 128),
    "B=1 k_len=100 Sk=128": (1, 4, 4, 128, 128, 192, True, None, 100, 128),
    "B=2 S=40 < one tile": (2, 4, 4, 40, 40, 192, True, None, None, 128),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BWD_192_128))
def test_flash_bwd_at_192_128_matches_plain_version_on_card(name, dtype):
    """K1-bwd at MLA's 192/128 against its plain version: f32 within 1e-4
    scaled, bf16 within 2^-7 scaled and 2 ulps; two launches bit for bit."""
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    assert tfa.design_bwd(dt, 192, 128) == ("fma-f32" if dtype == "float32"
                                            else "wgmma-split-2wg")
    err = _bwd_error(dev, np.random.default_rng(31), dt, BWD_192_128[name])
    assert err <= tol, (name, dtype, err)
    args, mask = _bwd_inputs(dev, np.random.default_rng(32), dt, BWD_192_128[name])
    first = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    again = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), name
    if dtype == "bfloat16":
        q, k, v, o, lse, do = args
        want = tfa.flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                                           do.transpose(1, 2), **mask)
        for label, g, w in zip(("dq", "dk", "dv"), first, want):
            assert _bf16_ulps(g, w.transpose(1, 2)) <= BWD_ULP_TOL, (name, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BWD_EDGES))
def test_flash_bwd_kernel_tile_edges_on_card(name, dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    err = _bwd_error(dev, np.random.default_rng(15), dt, BWD_EDGES[name])
    assert err <= tol, (name, dtype, err)


# the enc-dec and VLM train paths' backward: the prefix-LM span at Dh=64
# across a tile edge and in a window, and whisper's cross-attention (its
# 448 text tokens over the 1500 frames, the last key tile ragged);
# (B, H, KV, Sq, Sk, Dh, causal, window, k_len, Dv, prefix_len)
BWD_ENCDEC_VLM = {
    "prefix 65 Dh=64 GQA S=200": (1, 4, 2, 200, 200, 64, True, None, None, 64, 65),
    "prefix 100 window 50 Dh=64 S=300": (1, 4, 2, 300, 300, 64, True, 50, None, 64, 100),
    "prefix 40 Dh=128 S=150": (1, 4, 2, 150, 150, 128, True, None, None, 128, 40),
    "prefix 30 Dh=32 MQA S=97": (1, 4, 1, 97, 97, 32, True, None, None, 32, 30),
    "whisper cross Sq=448 Sk=1500 Dh=64": (2, 16, 16, 448, 1500, 64, False, None, None),
    "whisper encoder S=1500 Dh=64": (1, 16, 16, 1500, 1500, 64, False, None, None),
    "cross Sq=70 Sk=1500 Dh=256 MQA": (1, 8, 1, 70, 1500, 256, False, None, None, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", FLASH_256_SEQS)
def test_flash_bwd_kernel_at_256_with_prefix_span_on_card(S, dtype):
    """K1-bwd at gemma's 256/256 (paligemma: 8 q-heads on one kv-head)
    with the prefix span at 0, 1, 63, 64, 65 and S, against its plain
    version; in bf16 also within 2 ulps."""
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(24)
    for prefix in FLASH_256_PREFIXES:
        prefix = S if prefix is None else prefix
        case = (1, 8, 1, S, S, 256, True, None, None, 256, prefix)
        err = _bwd_error(dev, rng, dt, case)
        assert err <= tol, (S, prefix, dtype, err)
        if dt == torch.bfloat16:
            assert _bwd_ulps(dev, rng, case) <= BWD_ULP_TOL, (S, prefix)


def _bwd_ulps(dev, rng, case) -> float:
    """The bf16 backward's largest error in ulps over dq, dk and dv."""
    args, mask = _bwd_inputs(dev, rng, torch.bfloat16, case)
    got = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    q, k, v, o, lse, do = args
    want = tfa.flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                                       do.transpose(1, 2), **mask)
    return max(_bf16_ulps(g, w.transpose(1, 2)) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BWD_ENCDEC_VLM))
def test_flash_bwd_kernel_encdec_vlm_shapes_on_card(name, dtype):
    dev = _cuda()
    dt, tol = FLASH_TOL[dtype]
    case = BWD_ENCDEC_VLM[name]
    err = _bwd_error(dev, np.random.default_rng(25), dt, case)
    assert err <= tol, (name, dtype, err)
    if dt == torch.bfloat16:
        assert _bwd_ulps(dev, np.random.default_rng(26), case) <= BWD_ULP_TOL, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_at_256_is_bitwise_repeatable_on_card(dtype):
    """The 256/256 instantiations (bf16: two warpgroups a dK/dV CTA, the
    q-heads split over CTAs and their partials reduced in split order) use
    no float atomics either: two launches give the same gradients bit for
    bit, with and without the prefix span."""
    dev = _cuda()
    dt, _tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(27)
    for prefix in (None, 70):
        args, mask = _bwd_inputs(dev, rng, dt, (2, 8, 1, 200, 200, 256, True, None, None, 256,
                                                prefix))
        first = tfa.flash_attention_bwd(*args, bshd=True, **mask)
        second = tfa.flash_attention_bwd(*args, bshd=True, **mask)
        for label, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (prefix, dtype, label)


# K1-bwd's wide pairs in bf16 ("wgmma-split-2wg"), the q-head split
# engaged (paligemma's training shape, B=1 MQA, GQA) and not (many
# kv-heads, or one q-head a kv-head), with ragged Sq and Sk, a prefix span
# that ends inside a key tile, a window and k_len; at 128/128 the head
# layouts of phi4-mini, qwen1.5 and deepseek-coder (GQA groups 3, 1, 7);
# (B, H, KV, Sq, Sk, Dqk, causal, window, k_len, Dv, prefix_len)
BWD_WIDE = {
    "128/128 G=3 ragged S=445": (1, 6, 2, 445, 445, 128, True, None, None, 128),
    "128/128 unsplit G=1 B=2 S=257 k_len 200": (2, 4, 4, 257, 257, 128, True, None, 200, 128),
    "128/128 G=7 window 77 S=300": (1, 14, 2, 300, 300, 128, True, 77, None, 128),
    "128/128 unsplit phi4 heads H=48 KV=16 S=512": (1, 48, 16, 512, 512, 128, True, None, None,
                                                    128),
    "128/128 G=3 prefix 100 S=257": (1, 6, 2, 257, 257, 128, True, None, None, 128, 100),
    "128/128 MQA Sq=100 Sk=333 bidirectional": (1, 4, 1, 100, 333, 128, False, None, None, 128),
    "paligemma train B=4 MQA S=512 prefix 256": (4, 8, 1, 512, 512, 256, True, None, None, 256,
                                                 256),
    "256 B=1 MQA S=300 prefix 100": (1, 8, 1, 300, 300, 256, True, None, None, 256, 100),
    "256 unsplit B=2 H=KV=8 S=1100": (2, 8, 8, 1100, 1100, 256, True, None, None, 256),
    "256 MQA Sq=70 Sk=1500 bidirectional": (1, 8, 1, 70, 1500, 256, False, None, None, 256),
    "256 GQA window 33 S=161": (1, 4, 2, 161, 161, 256, True, 33, None, 256),
    "192/128 B=1 MQA S=256": (1, 8, 1, 256, 256, 192, True, None, None, 128),
    "192/128 unsplit H=KV=16 S=512": (1, 16, 16, 512, 512, 192, True, None, None, 128),
    "192/128 GQA window 70 S=300": (1, 8, 2, 300, 300, 192, True, 70, None, 128),
    "192/128 GQA prefix 100 k_len 200 S=257": (2, 8, 2, 257, 257, 192, True, None, 200, 128, 100),
    "192/128 MQA Sq=100 Sk=333 bidirectional": (1, 4, 1, 100, 333, 192, False, None, None, 128),
}


def _wide_split(dev, case) -> int:
    B, H, KV, _Sq, Sk = case[:5]
    return tfa.bwd_head_split(B, KV, -(-Sk // 64), H // KV,
                              torch.cuda.get_device_properties(dev).multi_processor_count)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BWD_WIDE))
def test_flash_bwd_wide_pairs_with_and_without_the_head_split_on_card(name):
    """The wide pairs' bf16 design against the plain version: within 2^-7
    scaled and 2 ulps, every case in the split it names (paligemma's
    training shape split 4 ways on an H100's 132 SMs), two launches bit
    for bit."""
    dev = _cuda()
    case = BWD_WIDE[name]
    assert tfa.design_bwd(torch.bfloat16, case[5], case[9]) == "wgmma-split-2wg"
    n_split = _wide_split(dev, case)
    assert (n_split > 1) == ("unsplit" not in name), (name, n_split)
    err = _bwd_error(dev, np.random.default_rng(41), torch.bfloat16, case)
    assert err <= 2.0**-7, (name, err)
    args, mask = _bwd_inputs(dev, np.random.default_rng(42), torch.bfloat16, case)
    first = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    again = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), name
    q, k, v, o, lse, do = args
    want = tfa.flash_attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                                       do.transpose(1, 2), **mask)
    for label, g, w in zip(("dq", "dk", "dv"), first, want):
        assert _bf16_ulps(g, w.transpose(1, 2)) <= BWD_ULP_TOL, (name, label)


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(192, 128), (256, 256), (128, 128)])
def test_flash_bwd_wide_pairs_are_bitwise_repeatable_at_the_train_shapes_on_card(dqk, dv):
    """At the train cells' own shapes (:data:`WIDE_TRAIN`: deepseek-v2's
    and phi4-mini's unsplit, paligemma's split), two launches give the
    same gradients bit for bit."""
    dev = _cuda()
    case = WIDE_TRAIN[(dqk, dv)]
    args, mask = _bwd_inputs(dev, np.random.default_rng(43), torch.bfloat16, case)
    first = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    again = tfa.flash_attention_bwd(*args, bshd=True, **mask)
    for label, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.isfinite(a.float()).all(), label
        assert torch.equal(a, b), (dqk, dv, label)


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
    # an SSM layer's scan under autograd is SSD: the scan kernel forward, the
    # backward kernels backward (with remat "full", the forward twice)
    cfg = get_reduced("mamba2-1.3b").replace(dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(0)
    fwd0, bwd0 = tssd.ssd_bshp.launches, tssd.ssd_bwd.launches
    loss, _ = model.loss(params, {"tokens": np.zeros((1, 8), np.int32),
                                  "targets": np.zeros((1, 8), np.int32)})
    loss.backward()
    assert tssd.ssd_bshp.launches - fwd0 == 2 * cfg.num_layers
    assert tssd.ssd_bwd.launches - bwd0 == cfg.num_layers
    assert all(torch.isfinite(p.grad).all() for p in params.parameters())


# reduced deepseek-v2 with its MLA widened to the kernels' 192/128 (128
# nope + 64 rope dims of query and key, 128 of value)
MLA_192_128 = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


def _train_cfg(arch="tinyllama-1.1b", head_dim=32):
    # the flash kernels are built for head dims 32, 64, 128 and 256, and
    # MLA's 192/128
    if arch == "deepseek-v2-236b":
        return get_reduced(arch).replace(dtype="float32", **MLA_192_128)
    return get_reduced(arch).replace(dtype="float32", head_dim=head_dim)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,head_dim", [
    ("tinyllama-1.1b", 32), ("mamba2-1.3b", 32), ("hymba-1.5b", 32),
    # the enc-dec and VLM paths at gemma's 256: whisper's encoder, decoder
    # and cross-attention, paligemma under its prefix span
    ("whisper-medium", 256), ("paligemma-3b", 256),
    # MLA + MoE, K1 and K1-bwd at 192/128
    ("deepseek-v2-236b", 192),
])
def test_train_step_on_card_matches_cpu(arch, head_dim):
    """One step of a reduced model (loss, autograd through K1 and its
    backward, K2 and its backward, AdamW) on the card against the same step
    on the CPU, where the kernels' plain versions stand in; frames or
    patches beside the tokens for the enc-dec and VLM families."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.common import ParamTree
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg(arch, head_dim)
    batch = SyntheticTokens(cfg.vocab_size, 40, 2, seed=0).batch(0)
    batch.update({k: v for k, v in _encdec_vlm_inputs(cfg, np.random.default_rng(3), 2, 40).items()
                  if k != "tokens"})
    ocfg = AdamWConfig(lr=1e-3, grad_clip=0.5)
    cpu_params = build_model(cfg, device="cpu").init(0)
    card_params = ParamTree(tree_map(lambda t: t.detach().to(dev), cpu_params.tree()))
    out = {}
    for device, params in (("cpu", cpu_params), (dev, card_params)):
        model = build_model(cfg, device=device)
        tree = params.tree()
        state = adamw_init(ocfg, tree)
        ssd0, ssd_bwd0 = tssd.ssd_bshp.launches, tssd.ssd_bwd.launches
        bwd0 = tfa.flash_attention_bwd.launches
        loss, _ = model.loss(params, batch)
        grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
        _, state, met = adamw_update(ocfg, 1e-3, tree, grads, state)
        out[str(device)] = (loss.item(), met["grad_norm"].item(),
                            [t.detach().cpu() for t in tree_leaves(tree)])
        if device == dev and cfg.family in ("ssm", "hybrid"):  # remat: the forward twice
            assert tssd.ssd_bshp.launches - ssd0 == 2 * cfg.num_layers
            assert tssd.ssd_bwd.launches - ssd_bwd0 == cfg.num_layers
        if device == dev and cfg.family != "ssm":  # each attention call's backward once
            calls = cfg.num_layers + (cfg.encoder_layers + cfg.num_layers) * cfg.is_encdec
            assert tfa.flash_attention_bwd.launches - bwd0 == calls
    (l0, n0, p0), (l1, n1, p1) = out.values()
    assert l1 == pytest.approx(l0, rel=1e-4) and n1 == pytest.approx(n0, rel=1e-4)
    for a, b in zip(p0, p1):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_deepseek_trains_two_bf16_steps_on_card(tmp_path):
    """Two bf16 steps of ``Trainer`` on reduced deepseek-v2 with its MLA at
    192/128, at depth 2 (the dense layer 0 and one MoE layer) and S=256:
    finite losses, grad norms and aux losses, K1 2 x 2 and K1-bwd 2
    launches a step (remat), bf16 moments as the full config's size asks,
    every leaf a gradient. (Full width runs in ``chip_smoke.py``'s
    ``deepseek_train`` phase.)"""
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    dev = _cuda()
    cfg = _train_cfg("deepseek-v2-236b").replace(dtype="bfloat16", num_layers=2)
    tcfg = TrainerConfig(num_steps=2, checkpoint_every=100, log_every=1, seq_len=256,
                         global_batch=1, lr=1e-3, warmup=1, moments_dtype="bfloat16")
    fwd0, bwd0 = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    with Trainer(cfg, tcfg, str(tmp_path / "ckpt"), device=dev) as tr:
        out = tr.run(resume=False)
        graph = tr.graph.stats()
    # the eager warm-up's launches, and the captured ones each replay runs
    replayed = {k: graph["replays"] * n for k, n in graph["captured_launches"].items()}
    assert tfa.flash_attention_bhsd.launches - fwd0 + replayed["flash_attention"] == 2 * 2 * 2
    assert tfa.flash_attention_bwd.launches - bwd0 + replayed["flash_attention_bwd"] == 2 * 2
    rows = out["metrics"]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                                  and r["aux"] > 0 for r in rows)
    assert {t.dtype for t in tree_leaves(out["opt"]["m"])} == {torch.bfloat16}
    assert all(bool(m.ne(0).any()) for m in tree_leaves(out["opt"]["m"]))


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


# -- the train step's CUDA graph ---------------------------------------------------------

# one reduced model a family, at head dims the bf16 kernels take: (arch, head_dim)
TRAIN_GRAPH_FAMILIES = {
    "dense": ("tinyllama-1.1b", 32), "ssm": ("mamba2-1.3b", 32), "hybrid": ("hymba-1.5b", 32),
    "moe": ("granite-moe-1b-a400m", 32), "mla": ("deepseek-v2-236b", 192),
    "encdec": ("whisper-medium", 64), "vlm": ("paligemma-3b", 256),
}


class _TrainSource:
    """Tokens and targets from ``SyntheticTokens``, with frames or patches
    from ``default_rng((seed, step))``: a function of the step."""

    def __init__(self, cfg, S, B, seed=0):
        from repro_torch.data import SyntheticTokens

        self.cfg, self.S, self.B, self.seed = cfg, S, B, seed
        self.tokens = SyntheticTokens(cfg.vocab_size, S, B, seed=seed)

    def batch(self, step):
        out = self.tokens.batch(step)
        extra = _encdec_vlm_inputs(self.cfg, np.random.default_rng((self.seed, step)), self.B,
                                   self.S)
        out.update({k: v for k, v in extra.items() if k != "tokens"})
        return out


def _graph_against_eager(cfg, tmp_path, steps, S=64, B=2, mesh=None):
    """``steps`` of ``Trainer.run`` (the graph; under ``mesh``, the sharded
    step's) and as many eager ``train_step``s of a fresh state on the same
    batches: both runs' metric rows and state leaves, and the graph's
    stats."""
    from repro_torch.data import to_device
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    tcfg = TrainerConfig(num_steps=steps, checkpoint_every=100, log_every=1, seq_len=S,
                         global_batch=B, lr=1e-3, warmup=1)
    with Trainer(cfg, tcfg, str(tmp_path / "ckpt"), device=_cuda(), mesh=mesh,
                 data_source=_TrainSource(cfg, S, B)) as tr:
        out = tr.run(resume=False)
        stats = tr.graph.stats()
        graph = ([{k: v for k, v in r.items() if k not in ("step", "step_s")}
                  for r in out["metrics"]],
                 tree_leaves({"params": out["params"].tree(), "opt": out["opt"]}))
        tr.release_graph()
        state = tr.init_state()
        rows = []
        for step in range(steps):
            met = tr.train_step(state, to_device(tr.data.batch(step), tr.device), step)
            rows.append({k: float(v) for k, v in met.items()})
        eager = rows, tree_leaves({"params": state["params"].tree(), "opt": state["opt"]})
    return graph, eager, stats


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(TRAIN_GRAPH_FAMILIES))
def test_train_graph_equals_eager_steps_bit_for_bit_on_card(family, tmp_path):
    """Four bf16 steps of ``Trainer.run`` at reduced width, one eager
    warm-up then a captured step replayed three times, against four eager
    ``train_step``s on the same batches: every metric, param, master,
    moment and the counter equal bit for bit; the capture holds each of
    the family's kernels (K1 and K1-bwd, K2 and K2-bwd) at its launches a
    step (remat: each forward twice)."""
    arch, head_dim = TRAIN_GRAPH_FAMILIES[family]
    cfg = _train_cfg(arch, head_dim).replace(dtype="bfloat16")
    (g_rows, g_leaves), (e_rows, e_leaves), stats = _graph_against_eager(cfg, tmp_path, 4)
    assert stats["eager_steps"] == 1 and stats["replays"] == 3
    assert stats["captured_launches"] == _captured_want(cfg)
    assert g_rows == e_rows
    assert len(g_leaves) == len(e_leaves)
    for a, b in zip(g_leaves, e_leaves):
        assert a.device.type == "cuda" and torch.equal(a, b)


def _captured_want(cfg) -> dict:
    """The kernels a train step's capture holds, by name, at their
    launches a step (remat: each forward twice)."""
    attn = (cfg.attention != "none") * (cfg.num_layers
                                        + (cfg.encoder_layers + cfg.num_layers) * cfg.is_encdec)
    ssm = cfg.num_layers * (cfg.family in ("ssm", "hybrid"))
    want = {"flash_attention": 2 * attn, "flash_attention_bwd": attn, "ssd": 2 * ssm,
            "ssd_bwd": ssm}
    return {k: n for k, n in want.items() if n}


# the profiler's names of the host's calls that put work on the card
# (chip_smoke.HOST_LAUNCH)
HOST_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync")


def _host_launches(fn) -> int:
    """The host's launches and async copies in one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name.startswith(HOST_LAUNCH) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm", "moe", "encdec"])
def test_sharded_train_graph_on_a_world_of_one_equals_its_eager_body(family, tmp_path):
    """On an NCCL world of one rank and its (1, 1) mesh: four bf16 steps of
    ``Trainer(mesh=).run`` through the sharded step's graph against four
    eager sharded steps bit for bit, each kernel captured at its launches
    a step; and a replay of ``build_train_step``'s graph issuing at most 6
    host launches (the batch's copies, the lr's fill, the graph)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params

    dev = _cuda()
    arch, head_dim = TRAIN_GRAPH_FAMILIES[family]
    cfg = _train_cfg(arch, head_dim).replace(dtype="bfloat16")
    S, B = 64, 2
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1),
                            timeout=datetime.timedelta(seconds=120), device_id=dev)
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        (g_rows, g_leaves), (e_rows, e_leaves), stats = _graph_against_eager(
            cfg, tmp_path, 4, S=S, B=B, mesh=mesh)
        assert stats["eager_steps"] == 1 and stats["replays"] == 3
        assert stats["captured_launches"] == _captured_want(cfg)
        assert g_rows == e_rows
        assert len(g_leaves) == len(e_leaves)
        for a, b in zip(g_leaves, e_leaves):
            assert a.device.type == "cuda" and torch.equal(a, b)
        model = build_model(cfg, device=dev)
        ocfg = AdamWConfig(lr=1e-3)
        step, _, _ = build_train_step(model, mesh, ocfg, cosine_schedule(1e-3, 1, 8),
                                      model.input_specs("train", {"seq_len": S,
                                                                  "global_batch": B,
                                                                  "kind": "train"}))
        params = shard_params(model, model.init(0), mesh)
        opt = adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))
        source = _TrainSource(cfg, S, B)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in source.batch(i).items()}
                   for i in range(3)]
        for i in range(2):  # the warm-up, then the capture and its replay
            step(params, opt, batches[i], i)
        host = _host_launches(lambda: step(params, opt, batches[2], 2))
        assert step.stats()["replays"] == 2
        assert host <= 6, host
        step.release()
    finally:
        dist.destroy_process_group()


_BROKEN_CAPTURE = """
import sys, tempfile
from repro_torch.configs import get_reduced
from repro_torch.runtime import Trainer, TrainerConfig

class HostReadTrainer(Trainer):
    def step_body(self, state, batch, lr):
        out = super().step_body(state, batch, lr)
        float(out["loss"])  # a synchronisation, which a capture forbids
        return out

cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", head_dim=32)
tcfg = TrainerConfig(num_steps=3, checkpoint_every=100, log_every=1, seq_len=32,
                     global_batch=2, lr=1e-3)
with tempfile.TemporaryDirectory() as d, HostReadTrainer(cfg, tcfg, d, device="cuda:0") as tr:
    try:
        tr.run(resume=False)
    except RuntimeError as e:
        print("raised", tr.graph.eager_steps, tr.graph.stats()["replays"], len(tr.metrics_log))
        sys.exit(0)
print("ran", len(tr.metrics_log))
sys.exit(1)
"""


@pytest.mark.gpu
def test_broken_train_capture_raises():
    """A step body that reads a value to the host cannot be captured: the
    capture fails and the run raises, with no eager step in its place
    (after the one warm-up). In a process of its own: a failed capture
    leaves that process's capture stream behind."""
    import os
    import subprocess
    import sys

    _cuda()
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _BROKEN_CAPTURE], cwd=root, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0 and proc.stdout.split() == ["raised", "1", "0", "1"], (
        proc.stdout + proc.stderr[-3000:])


# -- the serve engine's CUDA graphs --------------------------------------------------------


def _serve_cfg(arch, dtype="float32"):
    # head_dim 32: the flash kernel is built for head dims 32, 64 and 128
    return get_reduced(arch).replace(dtype=dtype, head_dim=32)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "hymba-1.5b"])
def test_captured_decode_equals_eager_decode_step_bit_for_bit(arch, dtype, kv_layout):
    """Three replays of the decode graph (captured while no slot is live)
    against eager ``decode_step`` on a copy of the same logical caches: the
    same next tokens and the same caches of the live slots, bit for bit."""
    from repro_torch.serve import PagedKVCache, SlotKVCache
    from repro_torch.serve.graphs import DecodeGraph
    from repro_torch.serve.kv import lane_view
    from repro_torch.tree import tree_leaves, tree_map

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg(arch, dtype)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    paged = kv_layout == "paged"
    kv = (PagedKVCache(model, 3, 40, page_size=8) if paged else SlotKVCache(model, 3, 40))
    graph = DecodeGraph(model, params, kv)  # before any slot is live
    rng = np.random.default_rng(9)
    lens = (5, 19)
    for S in lens:
        prompt = rng.integers(0, cfg.vocab_size, (1, S))
        kv.write(kv.alloc(kv.pages_for(S + 3)), model.prefill(params, {"tokens": prompt})[1], S)

    def logical():  # a copy of every slot's logical cache
        if not paged:
            return tree_map(torch.clone, kv.buffers)
        tables = np.zeros((3, kv.pages_per_seq), np.int64)
        kv.tick_inputs({}, tables, np.zeros(3, np.int64))
        return tree_map(torch.clone, kv.gather(kv.pools, torch.as_tensor(tables, device=dev)))

    eager = logical()
    tok = rng.integers(0, cfg.vocab_size, (3, 1))
    for step in range(3):
        idx = np.array([lens[0] + step, lens[1] + step, 0])
        feeds = {0: int(idx[0]), 1: int(idx[1])}
        got = graph.run(tok, idx, feeds)
        logits, _ = model.decode_step(params, torch.as_tensor(tok, device=dev), lane_view(eager),
                                      torch.as_tensor(idx, device=dev))
        want = torch.argmax(logits[:, -1], dim=-1, keepdim=True).cpu().numpy()
        # the idle lane 2 decodes garbage, kept in the copy but not in the pages
        assert np.array_equal(got[:2], want[:2]), (step, got, want)
        now = logical()
        for a, b in zip(tree_leaves(now), tree_leaves(eager)):
            assert torch.equal(a[:2], b[:2]), step
        tok = got
    assert graph.stats()["replays"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("kv_layout", ["paged", "flat"])
def test_engine_on_card_replays_its_graphs_and_matches_cpu_decode(kv_layout):
    """Reduced tinyllama with prompt buckets, served on the card: every tick
    replays the decode graph (replays == ticks), every prompt replays its
    bucket's prefill graph with the flash kernel captured once per layer,
    the wrapper counts the warm-ups' launches only (a replay runs without
    it), and the tokens equal the same weights' sequential decode on the
    CPU."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg("tinyllama-1.1b")
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(0)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 30, 13, 9)]
    refs = [_cpu_decode(cpu_model, params, p, 6, 96) for p in prompts]
    before = tfa.flash_attention_bhsd.launches
    buckets = (16, 32)
    with ServeEngine(model, params.to(dev), max_slots=2, max_len=96, page_size=16,
                     kv_layout=kv_layout, prefill_buckets=buckets) as engine:
        outs = engine.generate(prompts, 6, timeout=300)
        stats = engine.stats()
    graphs = stats["graphs"]
    assert graphs["decode"]["replays"] == stats["ticks"] > 0
    assert graphs["decode"]["captured_launches"] == {}
    assert graphs["prefill_16"]["replays"] == 3 and graphs["prefill_32"]["replays"] == 1
    for b in buckets:
        assert graphs[f"prefill_{b}"]["captured_launches"] == {"flash_attention": cfg.num_layers}
    warmups = 2 * cfg.num_layers * len(buckets)  # _Graph.WARMUP eager runs of each bucket
    assert tfa.flash_attention_bhsd.launches - before == warmups
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


def _moe_serve_cfg(arch):
    """Reduced granite-moe at head dim 32, and deepseek-v2 at 2 layers (the
    dense layer 0, then one MoE layer) with MLA's full head dims, so its
    prefill runs the 192/128 instantiation."""
    cfg = get_reduced(arch).replace(dtype="float32")
    if arch == "deepseek-v2-236b":
        return cfg.replace(num_layers=2, qk_nope_head_dim=128, qk_rope_head_dim=64,
                           v_head_dim=128)
    return cfg.replace(head_dim=32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_moe_engine_on_card_replays_its_graphs_and_matches_cpu_decode(arch):
    """The MoE families served on the card through the decode graph and the
    bucketed prefill graphs (routing, top-k and the one-hot captured; the
    flash kernel captured once per layer), token for token equal to the same
    weights' sequential decode on the CPU."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_serve_cfg(arch)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(0)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 30, 13, 9)]
    refs = [_cpu_decode(cpu_model, params, p, 6, 96) for p in prompts]
    with ServeEngine(model, params.to(dev), max_slots=2, max_len=96, page_size=16,
                     prefill_buckets=(16, 32)) as engine:
        outs = engine.generate(prompts, 6, timeout=300)
        stats = engine.stats()
    graphs = stats["graphs"]
    assert graphs["decode"]["replays"] == stats["ticks"] > 0
    for b in (16, 32):
        assert graphs[f"prefill_{b}"]["captured_launches"] == {"flash_attention": cfg.num_layers}
    for ref, out in zip(refs, outs):
        assert list(map(int, out)) == ref


def _cpu_decode(model, params, prompt, budget, width):
    logits, caches = model.prefill(params, {"tokens": prompt[None]})
    caches = extend_caches(caches, width - prompt.size, window=model.cfg.window)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(budget - 1):
        logits, caches = model.decode_step(params, [[out[-1]]], caches, [prompt.size + i])
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.mark.gpu
def test_capture_while_another_engines_prefill_runs_on_another_thread():
    """Engines capture their graphs (in ``thread_local`` mode) while another
    engine's eager SSM prefills and decode-graph replays run on its pool's
    threads, with their allocations and synchronisations: nothing fails,
    and every engine's tokens equal the CPU's sequential decode. (With the
    warm-ups on the capture stream, they ran beside the other engine's
    replays, whose GEMMs share that stream's cuBLAS workspace, and its
    tokens went wrong.)"""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    ssm_cfg, dense_cfg = _serve_cfg("mamba2-1.3b"), _serve_cfg("tinyllama-1.1b")
    rng = np.random.default_rng(6)
    budget, runs = 16, {}
    for name, cfg, lens in (("ssm", ssm_cfg, (40, 70, 25, 60, 33, 52)),
                            ("dense", dense_cfg, (7, 12))):
        cpu_model = build_model(cfg, device="cpu")
        params = cpu_model.init(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
        refs = [_cpu_decode(cpu_model, params, p, budget, 96) for p in prompts]
        runs[name] = (build_model(cfg, device=dev), params.to(dev), prompts, refs)
    model, params, prompts, refs = runs["ssm"]
    with ServeEngine(model, params, max_slots=2, max_len=96, page_size=16) as busy:
        handles = [busy.submit(p, budget) for p in prompts]
        handles[0].result(300)  # the other engine is serving now
        model, params, dense_prompts, dense_refs = runs["dense"]
        for _ in range(12):  # with warm-ups on the capture stream, 5 runs in 6 failed
            with ServeEngine(model, params, max_slots=2, max_len=96, page_size=16,
                             prefill_buckets=(16,)) as engine:
                outs = engine.generate(dense_prompts, budget, timeout=300)
            for ref, out in zip(dense_refs, outs):
                assert list(map(int, out)) == ref
        busy_outs = [h.result(300) for h in handles]
    for ref, out in zip(refs, busy_outs):
        assert list(map(int, out)) == ref


@pytest.mark.gpu
def test_first_launch_guard_raises_inside_a_capture(monkeypatch):
    """A kernel instantiation whose first-launch check has not run, reached
    inside a CUDA graph capture, raises (the check synchronises, which a
    capture forbids) rather than skip its check."""
    dev = _cuda()
    q, k, v = (torch.randn(1, 2, 64, 32, device=dev) for _ in range(3))
    tfa.flash_attention_bhsd(q, k, v)  # checked and warm
    monkeypatch.setattr(tfa._guard, "checked", set())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            tfa.flash_attention_bhsd(q, k, v)
    assert tfa._guard.checked == set()
    tfa.flash_attention_bhsd(q, k, v)  # eagerly, the check runs and passes
    assert len(tfa._guard.checked) == 1


@pytest.mark.gpu
def test_capture_survives_the_collector_freeing_a_graph():
    """The collector frees an unreachable graph (a closed engine's sits in a
    reference cycle) at whichever allocation it runs; doing so inside a
    capture is a call the capture forbids, and aborts it. Here such a cycle
    becomes garbage inside the decode graph's capture, with the collector
    set to run at every allocation: the capture has collected first and
    holds the collector off, so it completes and the engine serves."""
    import gc

    dev = _cuda()
    cfg = _serve_cfg("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    params = model.init(0)
    x = torch.zeros(4, device=dev)
    held = {"graph": torch.cuda.CUDAGraph()}
    with torch.cuda.graph(held["graph"], stream=torch.cuda.Stream(dev)):
        x.add_(1)
    calls, step = [], model.decode_step

    def decode_step(*args, **kw):
        calls.append(1)
        if len(calls) == 1 + 2:  # after the two warm-ups: inside the capture
            cycle = [held.pop("graph")]
            cycle.append(cycle)
            del cycle
        return step(*args, **kw)

    model.decode_step = decode_step
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        engine = ServeEngine(model, params, max_slots=2, max_len=64, page_size=16)
    finally:
        gc.set_threshold(*threshold)
    with engine:
        out = engine.generate([np.arange(5, dtype=np.int32)], 3, timeout=300)
    assert len(calls) == 3 and len(out[0]) == 3


# -- the exact-length prefill graphs --------------------------------------------------


def _same_leaves(got, want) -> bool:
    """Every leaf of two cache trees equal bit for bit, with its shape and
    dtype."""
    from repro_torch.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def _eager_prefill(model, params, tokens):
    from repro_torch.serve.graphs import prefill_first

    with torch.inference_mode():
        want = prefill_first(model, params, torch.as_tensor(tokens, device=model.device))
    return want["cache"], int(want["first"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_replayed_exact_prefill_equals_its_eager_body_bit_for_bit(arch, dtype, monkeypatch):
    """A prompt length's prefill through ``ExactPrefillGraphs`` (the first
    run eager, the second captured and replayed, the third replayed)
    against the eager body on the same tokens: the first token and every
    cache leaf, with its shape and dtype, bit for bit, at a length below
    hymba's window (its ring leaves as long as the prompt) and one above.
    Each length's graph captured the SSD kernel (and hymba's flash kernel)
    once a layer. Each pool holds device memory in the allocator's snapshot
    until its graph is given back: the older length's when a budget that
    holds only the newer one evicts it, the newer one's at ``close``; once
    the allocator's cache is emptied, no segment of either pool is left and
    the reserved memory fell by at least the pool's bytes."""
    import gc

    from repro_torch.serve import graphs as serve_graphs
    from repro_torch.serve.graphs import ExactPrefillGraphs

    def segments(pool):
        return [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == pool]

    def reserved_after_emptying():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg(arch, dtype)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    graphs = ExactPrefillGraphs(model, params)
    rng = np.random.default_rng(10)
    lengths = (5, 77)
    assert cfg.window is None or lengths[0] < cfg.window < lengths[1]
    want_launches = {"ssd": cfg.num_layers}
    if cfg.attention == "gqa":
        want_launches["flash_attention"] = cfg.num_layers
    for n in lengths:
        tokens = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        want_cache, want_first = _eager_prefill(model, params, tokens)
        for i in range(3):
            cache, first = graphs.run(tokens)
            assert first == want_first, (n, i)
            assert _same_leaves(cache, want_cache), (n, i)
        stats = graphs.stats()[f"exact_{n}"]
        assert (stats["eager_steps"], stats["replays"]) == (1, 2)
        assert stats["captured_launches"] == want_launches
    del cache, want_cache
    older, newer = (graphs._graphs[n] for n in lengths)
    pools = [tuple(g._graph.graph.pool()) for g in (older, newer)]
    for g, pool in zip((older, newer), pools):
        assert g.pool_bytes > 0 and sum(seg["total_size"] for seg in segments(pool)) \
            == g.pool_bytes
    assert graphs.held_bytes() == older.held_bytes() + newer.held_bytes()
    monkeypatch.setattr(serve_graphs, "EXACT_PREFILL_BYTES", newer.held_bytes())
    for g, pool in zip((older, newer), pools):
        reserved = reserved_after_emptying()
        if g is older:
            graphs.run(tokens)  # the newer length's: its budget gives the older back
            assert list(graphs._graphs) == [lengths[1]] and graphs.evictions == 1
        else:
            graphs.close()
        assert g.state is None and not g.captured
        assert reserved - reserved_after_emptying() >= g.pool_bytes
        assert not segments(pool)
    assert graphs.held_bytes() == 0


class _PreemptingEngine(ServeEngine):
    """``hold``: the next tick waits until that many prefilled sequences wait
    to join (a round's residents join together); ``preempt_at=t``: before
    the tick that follows ``t`` ticks, the youngest resident is preempted
    (once), so its resume's length is the same in every round."""

    def __init__(self, *args, hold=0, preempt_at=None, **kw):
        super().__init__(*args, **kw)
        self.hold, self.preempt_at = hold, preempt_at

    def _tick_body(self):
        import time

        deadline = time.monotonic() + 120
        while self.hold:
            with self._lock:
                if len(self._joinq) >= self.hold:
                    self.hold = 0
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("the held prefills never arrived")
            time.sleep(1e-3)
        with self._lock:
            if self.preempt_at == self._ticks and self._active:
                self._preempt_locked(max(self._active.values(), key=lambda s: s.p.order))
                self.preempt_at = None
        super()._tick_body()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "hymba-1.5b"])
def test_forced_preemption_resumes_by_a_replayed_graph_on_card(arch):
    """Two residents on few pages (tinyllama bucketed); the youngest is
    preempted after three ticks and resumes by an exact-length prefill of
    prompt and tokens but the last. Served twice on one engine: in the
    second round every prompt's length and the resume's replay their
    captured graphs (the resume's eager the first time). Both rounds'
    tokens equal the same weights' sequential decode on the CPU (f32)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg(arch)
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(2)
    model = build_model(cfg, device=dev)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (21, 13)]
    budgets = [12, 10]
    refs = [_cpu_decode(cpu_model, params, p, b, 48) for p, b in zip(prompts, budgets)]
    buckets = (16, 32) if ServeEngine.supports_prefill_buckets(cfg) else None
    resume = 13 + 4 - 1  # the youngest's prompt and its first token and 3 decoded, but the last
    rounds = []
    with _PreemptingEngine(model, params.to(dev), max_slots=2, max_len=48, page_size=8,
                           num_pages=8, prefill_buckets=buckets, hold=2,
                           preempt_at=3) as engine:
        for _ in range(2):
            outs = engine.generate(prompts, budgets, timeout=300)
            rounds.append(([list(map(int, o)) for o in outs], engine.stats()))
            engine.hold, engine.preempt_at = 2, engine._ticks + 3
    (first, s1), (second, s2) = rounds
    assert s1["preemptions"] == 1 and s2["preemptions"] == 2
    g1, g2 = s1["graphs"], s2["graphs"]
    exact = [resume] + ([] if buckets else [21, 13])
    for n in exact:
        assert (g1[f"exact_{n}"]["eager_steps"], g1[f"exact_{n}"]["replays"]) == (1, 0), n
        assert (g2[f"exact_{n}"]["eager_steps"], g2[f"exact_{n}"]["replays"]) == (1, 1), n
        assert g2[f"exact_{n}"]["capture_s"] is not None
    assert first == second == refs


@pytest.mark.gpu
def test_exact_prefill_captures_beside_another_lengths_replays():
    """One thread replays a captured length's prefill graph again and again
    while the main thread brings new lengths: each one's first run eager,
    its second captured (captures take turns in the process, in
    ``thread_local`` mode) while the other thread's replays, clones and
    read-backs go on. Every run on either thread gives the eager body's
    first token and cache leaves bit for bit."""
    import threading
    import time

    from repro_torch.serve.graphs import ExactPrefillGraphs

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg("hymba-1.5b")
    model = build_model(cfg, device=dev)
    params = model.init(3)
    graphs = ExactPrefillGraphs(model, params)
    rng = np.random.default_rng(12)
    busy = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    busy_want = _eager_prefill(model, params, busy)
    graphs.run(busy)
    graphs.run(busy)  # captured
    stop, errors, replays = threading.Event(), [], [0]

    def replay():
        try:
            while not stop.is_set():
                cache, first = graphs.run(busy)
                if first != busy_want[1] or not _same_leaves(cache, busy_want[0]):
                    errors.append(f"replay {replays[0]} differs from the eager body")
                replays[0] += 1
        except BaseException as e:  # noqa: BLE001 - reported below, with the others
            errors.append(repr(e))

    th = threading.Thread(target=replay)
    th.start()
    try:
        while not replays[0] and th.is_alive():
            time.sleep(1e-3)
        for n in (11, 23, 31, 52, 66):
            tokens = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
            want_cache, want_first = _eager_prefill(model, params, tokens)
            for i in range(3):
                cache, first = graphs.run(tokens)
                assert first == want_first and _same_leaves(cache, want_cache), (n, i)
    finally:
        stop.set()
        th.join(300)
    assert not th.is_alive() and not errors and replays[0] > 0, errors[:3]
    stats = graphs.stats()
    assert all(stats[f"exact_{n}"]["capture_s"] is not None for n in (11, 23, 31, 52, 66))
    graphs.close()


# -- the parallelism layer across four cards ------------------------------------------


def _stacked_numpy(cfg, params) -> dict:
    """The port's params as the reference lays them out (each layer group's
    leaves stacked), numpy: what ``bridge.params_from_jax`` takes."""
    from repro_torch.models.lm import encoder_plan, stack_plan
    from repro_torch.tree import tree_map

    tree = tree_map(lambda t: t.detach().numpy(), params.tree())
    for key, plan in (("layers", stack_plan(cfg)), ("enc_layers", encoder_plan(cfg) or ())):
        for grp in plan:
            if grp.kind == "scan":
                tree[key][grp.name] = tree_map(lambda *xs: np.stack(xs), *tree[key][grp.name])
    return tree


def _parallel_port_reference(par) -> tuple:
    """The four-card workers' inputs (``test_torch_parallel._worker``'s),
    drawn by the port, and the single-device results on the CPU they are
    held against."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.common import Init
    from repro_torch.models.moe import moe_dense, moe_params
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
    from repro_torch.optim.adamw import decay_mask
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map, tree_unflatten

    cpu = torch.device("cpu")
    flat = lambda tree: {k: t.detach().numpy() for k, t in tree_flatten_with_keys(tree)}  # noqa: E731
    # head dim 32: the flash kernel is built for head dims 32, 64, 128 and 256
    inp, want = {"overrides": {"head_dim": 32}}, {}
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", **inp["overrides"])
    model = build_model(cfg, device=cpu)
    params = model.init(0)
    inp["tiny"] = _stacked_numpy(cfg, params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (par.B, par.S + 1))
    inp["batch"] = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    inp["prompt"] = {"tokens": toks[:, :-1]}
    logits, caches = model.prefill(params, inp["prompt"])
    want["prefill_logits"], want["prefill_caches"] = logits.numpy(), flat(caches)
    # the worker's step: at the schedule's peak lr, past its warmup
    ocfg = AdamWConfig(lr=par.PEAK_LR)
    want["train_lr"] = float(cosine_schedule(par.PEAK_LR, par.WARMUP, 100)(par.TRAIN_STEP))
    tree = params.tree()
    # a copy: the update writes into the params in place
    want["train_p0"] = {k: a.copy() for k, a in flat(tree).items()}
    want["train_decay"] = dict(zip(
        [k for k, _ in tree_flatten_with_keys(tree)], tree_leaves(decay_mask(tree))))
    loss, _ = model.loss(params, inp["batch"])
    grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
    opt = adamw_init(ocfg, tree)
    _, _, met = adamw_update(ocfg, want["train_lr"], tree, grads, opt)
    want["train_loss"], want["train_params"] = float(loss.detach()), flat(tree)
    want["train_m"], want["train_v"] = flat(opt["m"]), flat(opt["v"])
    want["train_grad_norm"] = float(met["grad_norm"])
    mcfg = par._moe_cfg(ModelConfig)
    g = torch.Generator().manual_seed(0)
    mp = moe_params(mcfg, Init(g, cpu, torch.float32))
    inp["moe_params"] = tree_map(lambda t: t.numpy(), mp)
    inp["moe_x"] = np.random.default_rng(1).standard_normal((par.MOE_B, par.MOE_S, 32)).astype(
        np.float32)
    p = tree_map(lambda t: t.clone().requires_grad_(), mp)
    x = torch.tensor(inp["moe_x"]).requires_grad_()
    y, aux = moe_dense(mcfg, p, x)
    val = (y * y).sum() + aux
    want["moe_value"] = float(val.detach())
    want["moe_grads"] = [t.numpy() for t in torch.autograd.grad(val, tree_leaves(p) + [x])]
    inp["dec_caches"] = {}
    for name, arch in (("granite", "granite-moe-1b-a400m"), ("tiny", "tinyllama-1.1b")):
        dcfg = get_reduced(arch).replace(dtype="float32", **inp["overrides"])
        dmodel = build_model(dcfg, device=cpu)
        dparams = dmodel.init(0)
        inp[name] = _stacked_numpy(dcfg, dparams)
        dtoks = np.random.default_rng(2).integers(0, dcfg.vocab_size, (par.DEC_B, par.DEC_S))
        _, dc = dmodel.prefill(dparams, {"tokens": dtoks})
        dc = extend_caches(dc, par.DEC_EXTRA)
        inp["dec_caches"][name] = tree_map(lambda t: t.numpy().copy(), dc)
        dl, _ = dmodel.decode_step(dparams, torch.zeros((par.DEC_B, 1), dtype=torch.long), dc,
                                   torch.full((par.DEC_B,), par.DEC_S))
        want[f"decode_logits_{name}"] = dl.numpy()
    inp["trainer"] = dict(num_steps=3, checkpoint_every=100, log_every=1, seq_len=par.S,
                          global_batch=par.B, lr=1e-3, warmup=2)
    return inp, want


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_sharded_steps_on_four_cards_match_one_cpu(mesh, tmp_path):
    """``tests/test_torch_parallel.py``'s checks, each rank on its own card
    over NCCL (the flash kernel on the local heads), held against the
    port's single-device results on the CPU: the train step, ``moe_ep``,
    the prefill, the decode steps, the ZeRO blocks and, on (2, 2), the
    elastic restore; and three ``Trainer(mesh=)`` steps (through the
    sharded step's graph: an eager warm-up, then the captured step with
    its collectives replayed) against the single-device Trainer on one
    card. Then ``tests/test_torch_sharded_graph.py``'s group on the four
    cards: ``Trainer(mesh=)`` through the graph against the eager sharded
    body bit for bit for dense, GQA-MoE, SSM and enc-dec, every rank
    capturing the same launches (each kernel at its launches a step), a
    moved leaf refused, and the prefill and greedy decode graphs bit for
    bit with their eager bodies."""
    import pickle
    import sys

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the sharded steps span four cards")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_parallel as par

    from repro_torch.configs import get_reduced as reduced
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys

    inp, want = _parallel_port_reference(par)
    # the single-device Trainer on a card: its init draws from the card's
    # generator, as each rank's Trainer(mesh=) does
    with Trainer(reduced("tinyllama-1.1b").replace(dtype="float32", **inp["overrides"]),
                 TrainerConfig(**inp["trainer"]), str(tmp_path / "single"),
                 device="cuda:0") as tr:
        run = tr.run(resume=False)
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(inp))
    res = par._spawn(mesh, tmp_path, str(tmp_path / "inputs.pkl"), device_type="cuda")
    np.testing.assert_allclose(res["train_loss"], want["train_loss"], rtol=1e-5)
    # the step as tests/test_torch_parallel.py holds it: the clip's norm and
    # both moments 1e-5 scaled, every param the AdamW update of its moments
    np.testing.assert_allclose(res["train_grad_norm"], want["train_grad_norm"], rtol=1e-5)
    for moment in ("train_m", "train_v"):
        for k, w in want[moment].items():
            err = float(np.abs(res[moment][k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
            assert err <= 1e-5, (moment, k, err)
    ocfg = AdamWConfig(lr=par.PEAK_LR)
    for k, p0 in want["train_p0"].items():
        expect = par._adamw_first_step(p0, res["train_m"][k], res["train_v"][k],
                                       want["train_lr"], bool(want["train_decay"][k]), ocfg)
        np.testing.assert_allclose(res["train_params"][k], expect, atol=1e-7, rtol=0, err_msg=k)
        assert not np.array_equal(res["train_params"][k], p0), k
    np.testing.assert_allclose(res["moe_value"], want["moe_value"], rtol=1e-5)
    for got, w in zip(res["moe_grads"], want["moe_grads"], strict=True):
        np.testing.assert_allclose(got, w, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(res["prefill_logits"], want["prefill_logits"], atol=1e-4,
                               rtol=1e-4)
    for k, w in want["prefill_caches"].items():
        np.testing.assert_allclose(res["prefill_caches"][k], w, atol=1e-4, rtol=1e-4, err_msg=k)
    for name in ("granite", "tiny"):
        key = f"decode_logits_{name}"
        np.testing.assert_allclose(res[key], want[key], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(res["trainer_losses"], [r["loss"] for r in run["metrics"]],
                               rtol=1e-5)
    for k, t in tree_flatten_with_keys(run["params"].tree()):
        np.testing.assert_allclose(res["trainer_params"][k], t.detach().cpu().numpy(),
                                   atol=1e-5, err_msg=k)
    for rows in res["zero"]:
        for key, p_shape, m_shape, zero in rows:
            assert np.prod(m_shape) * (mesh[0] if zero else 1) == np.prod(p_shape), key
    if mesh == (2, 2):
        assert all(all(rank.values()) for rank in res["elastic"]), res["elastic"]
        # a save on four ranks: only the writer (rank 0) holds the tree on
        # the host, the others join the gathers on their cards
        save = res["save_host"]
        print(json.dumps({"checkpoint_save_host_peak_2x2": save}))
        writer, *others = save["peak_growth_bytes"]
        assert writer >= save["tree_bytes"], save
        assert max(others) <= save["tree_bytes"] // 2, save
    import test_torch_sharded_graph as sg

    (tmp_path / "graphs").mkdir()
    ranks = sg.spawn(mesh, tmp_path / "graphs", device_type="cuda")
    for arch in sg.ARCHS:
        sg.check_trainer(ranks, arch)
        assert ranks[0]["trainer"][arch]["stats"]["captured_launches"] == _captured_want(
            sg._cfg(arch)), arch
        sg.check_serve(ranks, arch)
    sg.check_moved(ranks)


# the families' four-card overrides: head dim 32 where K1 runs at the
# reduced head dim 16 (its instantiations take 32, 64, 128, 256 and MLA's
# Dqk=192/Dv=128, which deepseek-v2's widen to)
FAMILY_CARD_OVERRIDES = {
    "hymba-1.5b": {"head_dim": 32}, "whisper-medium": {"head_dim": 32},
    "paligemma-3b": {"head_dim": 32}, "tinyllama-1.1b": {"head_dim": 32},
    "granite-moe-1b-a400m": {"head_dim": 32},
    "deepseek-v2-236b": {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                         "v_head_dim": 128},
}


def _families_on_four_ranks(mesh: tuple, tmp_path, device_type: str) -> None:
    """``tests/test_torch_parallel_families.py``'s group of ``mesh`` on four
    ranks against the port's single-device results on the CPU."""
    import pickle
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_parallel as par
    import test_torch_parallel_families as fam

    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys

    inp, want = fam.port_reference(mesh, FAMILY_CARD_OVERRIDES, _stacked_numpy)
    archs, moe, trainers = fam.MESHES[mesh]
    singles = {}
    for arch in fam.TRAINER_ARCHS if trainers else ():
        # the single-device Trainer on the ranks' device type: its init
        # draws from that device's generator, as each rank's Trainer does
        cfg = get_reduced(arch).replace(dtype="float32", **FAMILY_CARD_OVERRIDES.get(arch, {}))
        dev = "cuda:0" if device_type == "cuda" else "cpu"
        with Trainer(cfg, TrainerConfig(**fam.TRAINER), str(tmp_path / f"single_{arch}"),
                     data_source=fam._trainer_source(cfg), device=dev) as tr:
            run = tr.run(resume=False)
        singles[arch] = ([r["loss"] for r in run["metrics"]],
                         {k: t.detach().cpu().numpy() for k, t in tree_flatten_with_keys(
                             run["params"].tree())})
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(inp))
    res = par._spawn(mesh, tmp_path, str(tmp_path / "inputs.pkl"), device_type=device_type,
                     module="test_torch_parallel_families")
    tol = dict(atol=1e-4, rtol=1e-4)  # the four-card dense test's prefill tolerance
    for arch in archs:
        if "train" in want[arch]:
            fam.check_train(res[arch]["train"], want[arch]["train"])
        fam.check_prefill(res[arch]["prefill"], want[arch]["prefill"], **tol)
        fam.check_decode(res[arch]["decode"], want[arch]["decode"], cache_tol=tol)
    if moe:
        fam.check_moe(res["moe"]["dense"], want["moe"]["dense"])
        drops = want["moe"]["drops"][mesh[1:]]
        assert drops["dropped"] > 0
        fam.check_moe(res["moe"]["drops"], drops)
    for arch, (losses, params) in singles.items():
        fam.check_trainer(res["trainer"][arch], losses, params)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(1, 2, 2), (1, 1, 4), (2, 1, 2)],
                         ids=["2x2", "1x4", "pods_2x1x2"])
def test_families_on_four_cards_match_one_cpu(mesh, tmp_path):
    """Every family under a mesh, each rank on its own card over NCCL (the
    kernels on the local heads), held against the port's single-device
    results on the CPU: on (2, 2) and (1, 4) deepseek-v2 (prefill and
    decode; its train step under a mesh is ROADMAP queue 1 item 3), mamba2, hymba, whisper and
    paligemma (train step, prefill, decode), deepseek-v2's ``moe_ep`` with
    its experts' hidden dim on data, and on (2, 2) two ``Trainer(mesh=)``
    steps of mamba2 and whisper; on the multi-pod (2, 1, 2), tinyllama and
    granite-moe."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the sharded steps span four cards")
    _families_on_four_ranks(mesh, tmp_path, "cuda")


@pytest.mark.gpu
def test_pipeline_on_four_cards_matches_one_cpu(tmp_path):
    """``tests/test_torch_pipeline.py``'s cases, each rank on its own card
    over NCCL (S=4 on a ("pod",) mesh of four, S=2 on the pod axis of a
    (2, 2) mesh; tinyllama at head dim 32 for the flash kernel and its
    backward), held against the port's serial loss and gradients on the
    CPU at the reference test's tolerances."""
    import sys

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the pipeline spans four cards")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_pipeline as pipe

    inputs = {"overrides": {"head_dim": 32}}
    for name, (kind, S, M, _remat) in pipe.CASES.items():
        if kind == "mlp":
            inputs[name] = pipe.mlp_inputs(S, M)
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", num_layers=pipe.TINY_LAYERS,
                                                **inputs["overrides"])
    inputs["tiny"] = _stacked_numpy(cfg, build_model(cfg, device="cpu").init(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (pipe.TINY_B, pipe.TINY_S + 1))
    inputs["tokens"], inputs["targets"] = toks[:, :-1], toks[:, 1:]
    want = pipe.port_reference(inputs)
    res = pipe.spawn(tmp_path, inputs, device_type="cuda")
    for name, (kind, *_rest) in pipe.CASES.items():
        if kind == "tiny":
            want[name]["grads"] = pipe.stacked(want[name]["grads"])
        pipe.check_case(name, pipe.assemble(name, res[name]), want[name])
