"""The port's SSD scan (``repro_torch.kernels.ssd``) against the reference:
its plain version is held to the Pallas kernel run in interpret mode over
the shapes of ``tests/kernels/test_ssd.py``, to the oracle
``ssd_reference(return_final_state=True)`` on ragged lengths (y and final
state), and to its own decode step; the wrapper's CPU dispatch and
first-launch check. The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_bshp as jax_ssd_bshp
from repro.models.ssm import ssd_decode_step as jax_ssd_decode_step
from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro_torch.kernels import ssd as tssd

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)


def _mk(seed, B, S, H, P, N):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(U[0, 1)), as the
    reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.uniform(0.0, 1.0, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(*arrays, dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _jax(*arrays, dtype=jnp.float32):
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in arrays)
    return x.astype(dtype), dt, A, Bm.astype(dtype), Cm.astype(dtype)


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (1, 64, 2, 16, 16, 16),
        (2, 128, 4, 32, 32, 32),
        (1, 128, 8, 64, 128, 64),  # mamba2-1.3b-like tile
        (2, 96, 3, 16, 24, 32),  # uneven heads / N
    ],
)
def test_plain_version_matches_pallas_kernel(B, S, H, P, N, chunk):
    arrays = _mk(1, B, S, H, P, N)
    want = np.asarray(jax_ssd_bshp(*_jax(*arrays), chunk=chunk, interpret=True))
    got = tssd.ssd_ref(*_torch(*arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_plain_version_matches_pallas_kernel():
    arrays = _mk(2, 1, 64, 2, 16, 16)
    want = jax_ssd_bshp(*_jax(*arrays, dtype=jnp.bfloat16), chunk=16, interpret=True)
    got = tssd.ssd_ref(*_torch(*arrays, dtype=torch.bfloat16), chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=5e-2
    )


@pytest.mark.parametrize(
    "B,S,H,P,N,chunk,with_init",
    [
        (1, 37, 2, 8, 8, 16, False),  # ragged: 2 full chunks + 5 rows
        (2, 100, 3, 16, 16, 64, False),  # one full chunk + 36 rows
        (1, 12, 2, 8, 16, 64, False),  # S < chunk: one chunk of S rows
        (2, 37, 2, 8, 8, 16, True),  # carried in from an initial state
    ],
)
def test_plain_version_matches_oracle_with_final_state(B, S, H, P, N, chunk, with_init):
    arrays = _mk(3, B, S, H, P, N)
    init = None
    if with_init:
        init = np.random.default_rng(4).standard_normal((B, H, P, N)).astype(np.float32)
    want_y, want_state = jax_ssd_reference(
        *_jax(*arrays), chunk=chunk, return_final_state=True,
        initial_state=None if init is None else jnp.asarray(init),
    )
    got_y, got_state = tssd.ssd_ref(
        *_torch(*arrays), chunk=chunk, return_final_state=True,
        initial_state=None if init is None else torch.from_numpy(init),
    )
    assert got_state.dtype == torch.float32 and got_state.shape == (B, H, P, N)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state), **TOL)


def test_final_state_equals_decode_steps():
    """The chunked scan's final state is the state after S recurrent steps
    (the prefill -> decode handoff), and its y is each step's y."""
    x, dt, A, Bm, Cm = _torch(*_mk(5, 1, 21, 2, 8, 8))
    y, final = tssd.ssd_ref(x, dt, A, Bm, Cm, chunk=8, return_final_state=True)
    state = torch.zeros((1, 2, 8, 8))
    ys = []
    for t in range(21):
        yt, state = tssd.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], state)
        ys.append(yt)
    np.testing.assert_allclose(final.numpy(), state.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), atol=1e-4, rtol=1e-4)


def test_decode_step_matches_reference():
    x, dt, A, Bm, Cm = _mk(6, 3, 1, 4, 8, 16)
    state = np.random.default_rng(7).standard_normal((3, 4, 8, 16)).astype(np.float32)
    jy, jstate = jax_ssd_decode_step(
        jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]), jnp.asarray(A), jnp.asarray(Bm[:, 0]),
        jnp.asarray(Cm[:, 0]), jnp.asarray(state),
    )
    s0 = torch.from_numpy(state.copy())
    ty, tstate = tssd.ssd_decode_step(
        torch.from_numpy(x[:, 0]), torch.from_numpy(dt[:, 0]), torch.from_numpy(A),
        torch.from_numpy(Bm[:, 0]), torch.from_numpy(Cm[:, 0]), s0,
    )
    assert torch.equal(s0, torch.from_numpy(state))  # the state passed in is left alone
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_uncounted():
    x, dt, A, Bm, Cm = _torch(*_mk(8, 1, 30, 2, 8, 8))
    before = tssd.ssd_bshp.launches
    y, state = tssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=8, return_final_state=True)
    want_y, want_state = tssd.ssd_ref(x, dt, A, Bm, Cm, chunk=8, return_final_state=True)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert torch.equal(tssd.ssd_bshp(x, dt, A, Bm, Cm, chunk=8), want_y)
    assert tssd.ssd_bshp.launches == before


def test_mixed_devices_raise():
    x, dt, A, Bm, Cm = _torch(*_mk(9, 1, 8, 2, 8, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        tssd.ssd_bshp(x, dt.to("meta"), A, Bm, Cm, chunk=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_launch_check_raises_on_a_wrong_result(monkeypatch, dtype):
    """The first-launch check holds y and the final state against the plain
    version: a launch that returns garbage raises (and the instantiation
    stays unchecked), a right one is remembered. The launch is stood in for
    on the CPU; on the card it is the kernel."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(tssd._guard, "checked", set())

    def wrong(x, dt, A, Bm, Cm, *, chunk):
        y, state = tssd.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)
        return y, state + 320.0  # y right, the state garbage

    monkeypatch.setattr(tssd, "_launch", wrong)
    with pytest.raises(RuntimeError, match="first-launch check failed"):
        tssd._check_first_launch(cpu, dtype)
    assert not tssd._guard.checked
    monkeypatch.setattr(tssd, "_launch", lambda x, dt, A, Bm, Cm, *, chunk: (
        tssd.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)))
    tssd._check_first_launch(cpu, dtype)
    assert tssd._guard.checked == {(None, dtype)}


def _split_views(device, dtype, P=16, N=16, offset=0, row_pad=0):
    """x, B and C as the model hands them over: split views of one (B, S,
    H*P + 2N + row_pad) activation starting ``offset`` elements into its
    buffer; dt and A in float32."""
    B, S, H = 1, 10, 2
    row = H * P + 2 * N + row_pad
    flat = torch.zeros(offset + B * S * row, dtype=dtype, device=device)
    xbc = flat[offset:].view(B, S, row)
    x = xbc[..., : H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N : H * P + 2 * N]
    dt = torch.zeros((B, S, H), device=device)
    A = torch.zeros((H,), device=device)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize(
    "offset,row_pad", [(1, 0), (0, 4), (4, 0)], ids=["base-2-bytes", "row-8-bytes", "base-8-bytes"]
)
def test_bf16_views_off_16_byte_boundaries_raise_before_launch(device, offset, row_pad):
    """The bf16 kernels copy 16-byte pieces: a base address or a stride that
    is not a multiple of 16 bytes is refused by the input check, which runs
    on any device and ahead of the first-launch check and the launches."""
    args = _split_views(device, torch.bfloat16, offset=offset, row_pad=row_pad)
    with pytest.raises(ValueError, match="16-byte"):
        tssd.check_inputs(*args, chunk=4)
    assert tssd.check_inputs(*_split_views(device, torch.bfloat16), chunk=4) == 4
    assert tssd.check_inputs(*_split_views(device, torch.bfloat16), chunk=64) == 10
    # the f32 design reads single elements and takes the same views
    f32 = _split_views(device, torch.float32, offset=offset, row_pad=row_pad)
    assert tssd.check_inputs(*f32, chunk=4) == 4


@pytest.mark.parametrize("P,N", [(12, 16), (16, 12)])
def test_bf16_head_and_state_widths_off_8_raise(P, N):
    args = _split_views("meta", torch.bfloat16, P=P, N=N)
    with pytest.raises(ValueError, match="multiples of 8"):
        tssd.check_inputs(*args, chunk=4)
    assert tssd.check_inputs(*_split_views("meta", torch.float32, P=P, N=N), chunk=4) == 4
