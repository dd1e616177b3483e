"""deepseek-v2's training attention: flash attention's backward at MLA's
Dqk=192 / Dv=128 (K1-bwd's own instantiation on the card).

* The wrapper's checks on the meta device: the backward takes 192/128 and
  the Dqk = Dv pairs, and still refuses every other unequal pair before
  anything runs; the design names the two-warpgroup ``wgmma`` form, and
  the head split stays off at deepseek-v2's training shape.
* Reduced deepseek-v2's loss, aux loss and every gradient with each
  prefill's attention sent through ``flash_attention``'s autograd function
  (its plain versions on the CPU, forward and backward, at the reduced
  MLA's Dqk=24 / Dv=16), as the card sends it to the kernels, against the
  reference's ``jax.value_and_grad`` of ``Model.loss`` at float32 within
  ``tests/test_torch_mla.py``'s tolerance (atol = rtol = 1e-4; each
  gradient read against max(1, its largest value), as
  ``tests/test_torch_moe.py`` reads them). That test file holds the same
  loss through the CPU's dense attention, not through the autograd
  function.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as attention_mod
from repro_torch.tree import tree_leaves, tree_unflatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_moe as tmoe  # noqa: E402  (the reference pair and the gradient check)

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"


def _meta(B, S, H, KV, dqk, dv):
    return (torch.empty((B, S, H, dqk), device="meta", dtype=torch.bfloat16),
            torch.empty((B, S, KV, dqk), device="meta", dtype=torch.bfloat16),
            torch.empty((B, S, KV, dv), device="meta", dtype=torch.bfloat16))


def test_the_backward_takes_192_128_and_refuses_other_unequal_pairs():
    assert tfa.BWD_HEAD_DIM_PAIRS == ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128))
    for dqk, dv in tfa.BWD_HEAD_DIM_PAIRS:
        q, k, v = _meta(1, 64, 128, 128, dqk, dv)
        tfa._require_bwd_dims(q, v)
        assert tfa.check_inputs(q, k, v, bshd=True) == 64
    for dqk, dv in ((192, 192), (128, 192), (256, 128)):
        q, k, v = _meta(1, 64, 8, 8, dqk, dv)
        with pytest.raises(NotImplementedError, match=fr"\({dqk}, {dv}\)"):
            tfa._require_bwd_dims(q, v)
        with pytest.raises(ValueError, match="head dims"):
            tfa.check_inputs(q, k, v, bshd=True)


def test_the_backward_design_at_192_128():
    assert tfa.design_bwd(torch.bfloat16, 192, 128) == "wgmma-split-2wg"
    assert tfa.design_bwd(torch.float32, 192, 128) == "fma-f32"
    assert tfa.design_bwd(torch.bfloat16, 256) == "wgmma-split-2wg"
    assert tfa.WIDE_BWD_PAIRS == ((192, 128), (256, 256))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.design_bwd(torch.bfloat16, 128, 192)
    # deepseek-v2's training attention (B=1, 128 kv-heads of one q-head,
    # 32 key tiles at S=2048) fills an H100's 132 SMs unsplit
    assert tfa.bwd_head_split(1, 128, 32, 1, 132) == 1


def test_on_the_card_autograd_at_192_128_reaches_the_autograd_function(monkeypatch):
    """Off the CPU (meta tensors stand in for the card's), attention at
    192/128 under autograd goes to ``FlashAttention`` (stubbed: its kernels
    need the card), launching nothing before it."""
    q, k, v = (t.requires_grad_() for t in _meta(1, 320, 128, 128, 192, 128))
    applied = []
    monkeypatch.setattr(tfa.FlashAttention, "apply", lambda *a: applied.append(a) or "applied")
    before = tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches
    assert tfa.flash_attention(q, k, v, causal=True) == "applied"
    assert len(applied) == 1 and applied[0][3] is True  # causal
    assert (tfa.flash_attention_bhsd.launches, tfa.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_gradient_through_the_autograd_function_match_reference(
        remat, monkeypatch):
    jm, jp, tm, tp = tmoe._pair(ARCH, remat=remat)
    dense = attention_mod.attend
    calls = []
    apply = tfa.FlashAttention.apply

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return apply(*args)

    def through_flash(q, k, v, mask):
        """A prefill's attention as the card runs it: the flash wrapper."""
        if isinstance(mask, attention_mod.PrefillMask) and q.shape[1] > 1:
            return tfa.flash_attention(q, k, v, causal=mask.causal, window=mask.window,
                                       prefix_len=mask.prefix_len)
        return dense(q, k, v, mask)

    monkeypatch.setattr(tfa.FlashAttention, "apply", counted)
    monkeypatch.setattr(attention_mod, "attend", through_flash)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True))(jp)
    loss, metrics = tm.loss(tp, batch)
    tree = tp.tree()
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    cfg = tm.cfg
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    # every layer's prefill went through the function at Dqk != Dv (twice under remat)
    assert calls == [(2, 16, cfg.num_heads, dqk)] * (cfg.num_layers * (2 if remat == "full" else 1))
    assert dqk != cfg.v_head_dim
    tmoe._close(loss.item(), float(jl))
    tmoe._close(metrics["ce"].item(), float(jaux["ce"]))
    tmoe._close(metrics["aux"].item(), float(jaux["aux"]))
    tmoe._assert_grads_close(
        tmoe._stacked(cfg, tree_unflatten(tree, [g.numpy() for g in grads])), jg)
