"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference: its plain version is held to the Pallas kernel run
in interpret mode and to ``kernels/ref.attention_ref`` over the sweep of
``tests/kernels/test_flash_attention.py``, and the wrapper's CPU dispatch.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as tfa

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
    assert tfa._guard.checked == {(None, dtype, 64)}


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
