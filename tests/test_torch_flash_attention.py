"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference: its plain version is held to the Pallas kernel run
in interpret mode and to ``kernels/ref.attention_ref`` over the sweep of
``tests/kernels/test_flash_attention.py``, the wrapper's CPU dispatch, and
the head dims the entry points run each config at on the card.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.kernels import flash_attention as tfa

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = 2e-5


def _mk(seed, B, H, KV, Sq, Sk, Dh):
    rng = np.random.default_rng(seed)
    shapes = [(B, H, Sq, Dh), (B, KV, Sk, Dh), (B, KV, Sk, Dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, H, KV, Sq, Sk, Dh, causal, window, k_len, block_q, block_k)
SWEEP = {
    "mha": (1, 2, 2, 128, 128, 64, True, None, None, 64, 64),
    "gqa": (2, 4, 2, 128, 128, 64, True, None, None, 64, 32),
    "mqa": (1, 8, 1, 256, 256, 32, True, None, None, 128, 128),
    "one-q-block-dh128": (1, 2, 2, 64, 64, 128, True, None, None, 64, 64),
    "window16": (1, 2, 2, 128, 128, 64, True, 16, None, 32, 32),
    "window64": (1, 2, 2, 128, 128, 64, True, 64, None, 32, 32),
    "window100": (1, 2, 2, 128, 128, 64, True, 100, None, 32, 32),
    "bidirectional": (1, 2, 2, 64, 64, 32, False, None, None, 32, 32),
    "k_len100": (1, 2, 2, 64, 128, 32, False, None, 100, 32, 32),
    "rect-sk192": (2, 4, 4, 64, 192, 32, False, None, None, 32, 64),
}


@pytest.mark.parametrize("name", list(SWEEP))
def test_plain_version_matches_pallas_kernel_and_oracle(name):
    B, H, KV, Sq, Sk, Dh, causal, window, k_len, bq, bk = SWEEP[name]
    q, k, v = _mk(len(name), B, H, KV, Sq, Sk, Dh)
    mask = dict(causal=causal, window=window, k_len=k_len)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_kernel = np.asarray(
        jax_flash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True, **mask)
    )
    want_ref = np.asarray(jax_attention_ref(jq, jk, jv, **mask))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention_ref(tq, tk, tv, **mask).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=TOL)
    # the port's own copy of the oracle agrees too
    np.testing.assert_allclose(
        tfa.attention_ref(tq, tk, tv, **mask).numpy(), want_ref, atol=TOL, rtol=TOL
    )


@pytest.mark.parametrize("window", [None, 40])
def test_ragged_sq_matches_oracle(window):
    """Sq = 100 is not a multiple of any block: the port masks the edge
    where the Pallas kernel asserts divisibility, so only the oracle is
    held against it."""
    q, k, v = _mk(7, 1, 4, 2, 100, 100, 32)
    want = np.asarray(
        jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)
    )
    got = tfa.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=window
    ).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _mk(3, 1, 4, 2, 48, 48, 16))
    before = tfa.flash_attention_bhsd.launches
    got = tfa.flash_attention_bhsd(q, k, v, causal=True, window=8)
    assert torch.equal(got, tfa.flash_attention_ref(q, k, v, causal=True, window=8))
    # the model-layout wrapper: (B, S, H, Dh) in and out
    got_m = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert torch.equal(got_m.transpose(1, 2), tfa.flash_attention_ref(q, k, v))
    assert tfa.flash_attention_bhsd.launches == before


def test_bf16_plain_version_matches_pallas_kernel():
    q, k, v = _mk(11, 2, 4, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(
        jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True), np.float32
    )
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention_ref(tq, tk, tv, causal=True).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_launch_check_raises_on_a_wrong_result(monkeypatch, dtype):
    """The first-launch check holds the launch against the plain version:
    a launch that returns garbage raises (and the instantiation stays
    unchecked), a right one is remembered. The launch is stood in for on
    the CPU; on the card it is the kernel."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(tfa._guard, "checked", set())
    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, **kw: torch.full_like(q, 320.0))
    with pytest.raises(RuntimeError, match="first-launch check failed"):
        tfa._check_first_launch(cpu, dtype, 64)
    assert not tfa._guard.checked
    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, **kw: tfa.flash_attention_ref(
        q, k, v, causal=kw["causal"], window=kw["window"], k_len=kw["k_len"]))
    tfa._check_first_launch(cpu, dtype, 64)
    # keyed by (device, dtype, Dqk, Dv): MLA's 192/128 is an instantiation of its own
    assert tfa._guard.checked == {(None, dtype, 64, 64)}
    tfa._check_first_launch(cpu, dtype, 192, 128)
    assert tfa._guard.checked == {(None, dtype, 64, 64), (None, dtype, 192, 128)}


def _views(device, dtype, offset=0, seq_pad=0):
    """q, k, v in the model's layout (B, S, heads, Dh) as views into flat
    buffers: ``offset`` elements from the buffer's start, rows ``seq_pad``
    elements longer than the heads they hold."""
    B, S, H, KV, Dh = 1, 8, 4, 2, 32

    def view(heads):
        row = heads * Dh + seq_pad
        flat = torch.zeros(offset + B * S * row, dtype=dtype, device=device)
        return flat[offset:].view(B, S, row)[..., : heads * Dh].view(B, S, heads, Dh)

    return view(H), view(KV), view(KV)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize(
    "offset,seq_pad", [(1, 0), (0, 4), (4, 0)], ids=["base-2-bytes", "row-8-bytes", "base-8-bytes"]
)
def test_bf16_views_off_16_byte_boundaries_raise_before_launch(device, offset, seq_pad):
    """The bf16 kernel copies 16-byte pieces: a base address or a stride
    that is not a multiple of 16 bytes is refused by the input check, which
    runs on any device and ahead of the first-launch check and the launch."""
    q, k, v = _views(device, torch.bfloat16, offset, seq_pad)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_inputs(q, k, v, bshd=True)
    aligned = _views(device, torch.bfloat16)
    assert tfa.check_inputs(*aligned, bshd=True) == 8
    assert tfa.check_inputs(*(t.transpose(1, 2) for t in aligned)) == 8
    # the f32 design reads single elements and takes the same views
    assert tfa.check_inputs(*_views(device, torch.float32, offset, seq_pad), bshd=True) == 8


def test_input_check_refuses_what_the_kernel_does_not_take():
    q, k, v = _views("meta", torch.bfloat16)
    assert tfa.check_inputs(q, k[:, :, :1], v[:, :, :1], bshd=True) == 8  # MQA
    for bad, match in [
        ((q[..., :16], k, v), "bad shapes"),
        ((q[:, :, :3], k, v), "bad shapes"),  # 3 heads over 2 kv-heads
        ((q.float(), k, v), "dtypes"),
        ((q.half(), k.half(), v.half()), "dtypes"),
    ]:
        with pytest.raises(ValueError, match=match):
            tfa.check_inputs(*bad, bshd=True)
    with pytest.raises(ValueError, match="k_len"):
        tfa.check_inputs(q, k, v, -1, bshd=True)


# -- the precision of the bf16 backward's design ---------------------------------------
#
# The kernel's bf16 backward runs its products on the tensor cores: bf16
# operands, f32 sums. Q, K, V and dO are bf16 already, so S = Q Kᵀ and dP =
# dO Vᵀ are exact products; P = exp(S·scale − lse) and dS = P∘(dP − D) are f32
# in registers, and each is split into a bf16 hi part and a bf16 lo part
# before the products that take it (dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K), each
# issued twice into one f32 sum. The emulation below repeats that in PyTorch
# and is held in bf16 ulps against the plain f32 formulas, at the gate that
# ``chip_smoke.py`` holds the kernel to (BWD_ULP_TOL); rounding P and dS to
# one bf16 each instead reads well above it on the same inputs.

BWD_ULP_TOL = 2.0

# (B, H, KV, S, Dh, causal, window, k_len[, prefix_len])
BWD_PRECISION_CASES = {
    "causal gqa dh64": (1, 8, 2, 256, 64, True, None, None),
    "mqa dh128 ragged": (1, 4, 1, 200, 128, True, None, None),
    "window dh32": (2, 4, 4, 192, 32, True, 48, None),
    "k_len bidirectional dh64": (1, 4, 2, 160, 64, False, None, 120),
    "mha dh32": (1, 2, 2, 256, 32, True, None, None),
    # gemma's head dim in paligemma: MQA under a prefix-LM span
    "mqa dh256 prefix 64": (1, 8, 1, 192, 256, True, None, None, 64),
    "gqa dh256 prefix 100 ragged": (1, 4, 2, 150, 256, True, None, None, 100),
}


def _bf16_ulps(got, want) -> float:
    """Largest error in bf16 ulps of each plain entry, entries under 2^-8 of
    the largest counted at that floor's ulp (``chip_smoke._ulps``)."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() * 2.0**-8)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return ((got.float() - w).abs() / ulp).max().item()


def _split(x):
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _bwd_emulation(q, k, v, o, lse, do, *, causal, window, k_len, split, prefix_len=None,
                   n_split=1):
    """The bf16 backward's arithmetic in PyTorch: products of bf16 operands
    summed in f32, P and dS split into hi + lo parts (``split``) or rounded
    to one bf16 each. With ``n_split``, dK and dV are the wide pairs' head
    split: each kv-head's q-heads in ``n_split`` consecutive subsets, an f32
    partial per subset, the partials summed in split order and only then
    scaled and rounded. (B, H, S, Dh) layout, bf16 in and out."""
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, Dh**-0.5

    def grouped(t):
        return t.reshape(B, KV, G, Sq, Dh).float()

    def mm(eq, a, b):  # bf16 operands, f32 sums
        return torch.einsum(eq, a.float(), b.float())

    def parts(x):
        return _split(x) if split else (x.to(torch.bfloat16),)

    qg, og, dog, kf, vf = grouped(q), grouped(o), grouped(do), k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
    mask = tfa._mask(Sq, Sk, causal, window, k_len, q.device, prefix_len)
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    gs = G // n_split

    def split_sum(x, y):  # the subsets' partials, summed in split order
        out = None
        for i in range(n_split):
            heads = slice(i * gs, (i + 1) * gs)
            part = sum(mm("bkgqs,bkgqd->bksd", xp[:, :, heads], y[:, :, heads])
                       for xp in parts(x))
            out = part if out is None else out + part
        return out

    dv = split_sum(p, dog)
    dk = split_sum(ds, qg) * scale
    dq = sum(mm("bkgqs,bksd->bkgqd", x, kf) for x in parts(ds)) * scale
    bf16 = torch.bfloat16
    return dq.reshape(B, H, Sq, Dh).to(bf16), dk.to(bf16), dv.to(bf16)


def _bwd_precision_inputs(name):
    B, H, KV, S, Dh, causal, window, k_len = BWD_PRECISION_CASES[name][:8]
    prefix = BWD_PRECISION_CASES[name][8] if len(BWD_PRECISION_CASES[name]) > 8 else None
    rng = np.random.default_rng(len(name))
    shapes = [(B, H, S, Dh), (B, KV, S, Dh), (B, KV, S, Dh), (B, H, S, Dh)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
                   for s in shapes)
    mask = dict(causal=causal, window=window, k_len=k_len, prefix_len=prefix)
    o, lse = tfa.flash_attention_lse_ref(q, k, v, **mask)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, **mask)
    return (q, k, v, o, lse, do), mask, want


@pytest.mark.parametrize("name", list(BWD_PRECISION_CASES))
def test_bf16_bwd_design_with_split_p_and_ds_holds_the_ulp_gate(name):
    args, mask, want = _bwd_precision_inputs(name)
    got = _bwd_emulation(*args, **mask, split=True)
    for g, w, label in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g.float()).all()
        assert _bf16_ulps(g, w) <= BWD_ULP_TOL, (name, label, _bf16_ulps(g, w))


@pytest.mark.parametrize("name", list(BWD_PRECISION_CASES))
def test_bf16_bwd_with_p_and_ds_rounded_once_fails_the_ulp_gate(name):
    """The control: the same products with P and dS rounded to one bf16
    each (half the tensor-core products) read above the gate."""
    args, mask, want = _bwd_precision_inputs(name)
    got = _bwd_emulation(*args, **mask, split=False)
    worst = max(_bf16_ulps(g, w) for g, w in zip(got, want))
    assert worst > BWD_ULP_TOL, (name, worst)


# the wide pairs' head split at paligemma's training shape (B=4, one
# kv-head of 8 q-heads, 8 key tiles: 32 CTAs unsplit on 132 SMs), at B=1
# MQA, and never above G nor off G's divisors
@pytest.mark.parametrize("shape, want", [
    ((4, 1, 8, 8, 132), 4),
    ((1, 1, 8, 8, 132), 8),
    ((1, 128, 32, 1, 132), 1),   # deepseek-v2's training attention
    ((2, 8, 16, 1, 132), 1),
    ((1, 2, 3, 6, 132), 6),
    ((1, 1, 40, 6, 132), 3),
    ((1, 1, 200, 8, 132), 1),    # the unsplit grid already fills the card
])
def test_bwd_head_split_fills_the_card_and_divides_the_group(shape, want):
    B, KV, k_tiles, G, sms = shape
    n = tfa.bwd_head_split(B, KV, k_tiles, G, sms)
    assert n == want
    assert 1 <= n <= G and G % n == 0
    assert n == 1 or B * KV * k_tiles * n <= sms


@pytest.mark.parametrize("name", ["mqa dh256 prefix 64", "gqa dh256 prefix 100 ragged"])
def test_bf16_bwd_head_split_partials_hold_the_ulp_gate(name):
    """dK and dV as the wide pairs' split CTAs and reduce launch sum them:
    each subset of q-heads an f32 partial, summed in split order, within
    the same 2-ulp gate at every split count the group takes; dQ is
    untouched."""
    args, mask, want = _bwd_precision_inputs(name)
    G = args[0].shape[1] // args[1].shape[1]
    whole = _bwd_emulation(*args, **mask, split=True)
    for n_split in (d for d in range(2, G + 1) if G % d == 0):
        got = _bwd_emulation(*args, **mask, split=True, n_split=n_split)
        assert torch.equal(got[0], whole[0])  # dQ takes no split
        for g, w, label in zip(got[1:], want[1:], ("dk", "dv")):
            assert _bf16_ulps(g, w) <= BWD_ULP_TOL, (name, n_split, label, _bf16_ulps(g, w))


def test_split_parts_carry_sixteen_bits():
    """hi + lo recovers an f32 value to about 2^-16 of it, where one bf16
    keeps 2^-8."""
    x = torch.from_numpy(np.random.default_rng(0).random(4096, dtype=np.float32)) + 1e-3
    hi, lo = _split(x)
    rel = ((hi.float() + lo.float()) - x).abs() / x
    assert rel.max().item() <= 2.0**-16
    assert ((hi.float() - x).abs() / x).max().item() > 2.0**-10


def test_backward_design_names():
    assert tfa.design_bwd(torch.float32, 64) == "fma-f32"
    assert tfa.design_bwd(torch.float32, 128) == "fma-f32"
    assert tfa.design_bwd(torch.bfloat16, 64) == "wgmma-split"
    assert tfa.design_bwd(torch.bfloat16, 32) == "mma.sync-split"
    for dqk, dv in ((128, 128), (256, 256), (192, 128)):
        assert tfa.design_bwd(torch.bfloat16, dqk, dv) == "wgmma-split-2wg"
    with pytest.raises(ValueError, match="head_dim"):
        tfa.design_bwd(torch.bfloat16, 96)


def test_forward_design_names():
    """bf16 on wgmma at 64/64, on mma.sync at 32/32, "wgmma-wide" at every
    pair of head dim 128 or more (the wide pairs); f32 on FMA tiles."""
    assert tfa.design(torch.bfloat16, 64) == "wgmma"
    assert tfa.design(torch.bfloat16, 32) == "mma.sync"
    assert tfa.WIDE_PAIRS == ((128, 128), (192, 128), (256, 256))
    for dqk, dv in tfa.WIDE_PAIRS:
        assert tfa.design(torch.bfloat16, dqk, dv) == "wgmma-wide"
    for dqk, dv in tfa.HEAD_DIM_PAIRS:
        assert tfa.design(torch.float32, dqk, dv) == "fma-f32"
    with pytest.raises(ValueError, match="head dims"):
        tfa.design(torch.bfloat16, 128, 192)


def test_rows_16_byte_aligned_reads_address_and_strides():
    """The predicate behind the bf16 input check, which the backward also
    reads to copy a misaligned dO before its 16-byte loads."""
    from repro_torch.kernels import build

    base = torch.zeros(4 * 8 * 64, dtype=torch.bfloat16)
    assert build.rows_16_byte_aligned(base.view(4, 8, 64))
    assert not build.rows_16_byte_aligned(base[1:1 + 4 * 8 * 32].view(4, 8, 32))
    assert not build.rows_16_byte_aligned(base[: 32 * 60].view(32, 60))  # 120-byte rows
    # a broadcast dimension (stride 0) reads one row again: aligned
    assert build.rows_16_byte_aligned(base[:64].expand(8, 64))


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if get_config(a).attention != "none"])
def test_fit_head_dims_gives_each_config_a_pair_the_kernels_take(arch):
    """The entry points' config on the card: a reduced config's head dims
    raised to the smallest pair both kernels take (MLA's rope part kept,
    nothing else changed), a full config's left as it is."""
    full, reduced = get_config(arch), get_reduced(arch)
    assert tfa.fit_head_dims(full) is full
    fitted = tfa.fit_head_dims(reduced)
    if fitted.attention == "mla":
        dims = (fitted.qk_nope_head_dim + fitted.qk_rope_head_dim, fitted.v_head_dim)
        assert fitted.qk_rope_head_dim == reduced.qk_rope_head_dim
        changed = {"qk_nope_head_dim", "v_head_dim"}
    else:
        dims = (fitted.head_dim, fitted.head_dim)
        changed = {"head_dim"}
    assert dims == (32, 32) and dims in tfa.BWD_HEAD_DIM_PAIRS
    before, after = dataclasses.asdict(reduced), dataclasses.asdict(fitted)
    assert {k for k in before if before[k] != after[k]} == changed
    H, KV = fitted.num_heads, fitted.num_kv_heads
    q, k, v = (torch.empty((1, 40, n, d), device="meta")
               for n, d in ((H, dims[0]), (KV, dims[0]), (KV, dims[1])))
    assert tfa.check_inputs(q, k, v, bshd=True) == 40
