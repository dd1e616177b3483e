"""AdamW's single-device update in flat pieces (``optim.adamw.PIECE``,
which keeps deepseek-v2's expert leaves' f32 temporaries small): the
update is elementwise, so a leaf updated in pieces equals the leaf updated
whole bit for bit, the params, both moments and the f32 master, with f32 or
bf16 moments and a gradient that is not contiguous."""
import pytest
import torch

from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)


def _state(dtype, moments):
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(37, 11, generator=g).to(dtype),
              "layers": [{"a": torch.randn(5, 3, 7, generator=g).to(dtype),
                          "n": torch.randn(13, generator=g).to(dtype)}]}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g).to(dtype), params)
    grads["w"] = torch.randn(11, 37, generator=g).to(dtype).t()  # not contiguous
    ocfg = AdamWConfig(lr=1e-2, moments_dtype=moments)
    return ocfg, params, grads, adamw_init(ocfg, params)


@pytest.mark.parametrize("dtype,moments", [(torch.float32, "float32"),
                                           (torch.bfloat16, "float32"),
                                           (torch.bfloat16, "bfloat16")])
def test_an_update_in_pieces_equals_the_whole_update_bit_for_bit(dtype, moments, monkeypatch):
    out = []
    for piece in (1 << 40, 7):  # whole leaves, then pieces of 7 elements
        monkeypatch.setattr(adamw_mod, "PIECE", piece)
        ocfg, params, grads, state = _state(dtype, moments)
        for step in range(3):
            adamw_update(ocfg, 1e-2, params, grads, state)
        out.append(tree_leaves(params) + tree_leaves(state))
    whole, pieces = out
    assert len(whole) == len(pieces)
    for a, b in zip(whole, pieces):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_global_norm_in_pieces_equals_the_whole_leaf_norm(dtype, monkeypatch):
    """A leaf over ``PIECE`` elements has its squares summed in pieces
    (its f32 square never exists whole): the norm equals the whole leaf's
    within f32 rounding, a non-contiguous leaf is summed whole, and the
    update still takes it."""
    from repro_torch.optim import global_norm

    _, params, grads, _ = _state(dtype, "float32")
    norms = []
    for piece in (1 << 40, 7):
        monkeypatch.setattr(adamw_mod, "PIECE", piece)
        norms.append(global_norm(grads))
    whole, pieces = norms
    want = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in tree_leaves(grads)))
    torch.testing.assert_close(pieces, whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(pieces.double(), want, rtol=1e-6, atol=0)
    assert not grads["w"].is_contiguous()
    assert adamw_mod._sum_squares(grads["w"]).dtype == torch.float32
