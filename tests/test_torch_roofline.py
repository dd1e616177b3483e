"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's ``repro.analysis.roofline``: the analytic model FLOPs equal for
every config and shape (rtol 1e-12: the same formula, summed in the same
order), the three terms at the H100's constants, the train cells' model-FLOP
count pinned to the values ``chip_smoke.py`` printed before the count moved
into the package, and the kernels' cost formulas against brute-force
counts of the masks' visible pairs."""
import numpy as np
import pytest
import torch

from repro.analysis.roofline import model_flops as jax_model_flops
from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import build_model

torch.set_num_threads(1)

CELLS = [(arch, shape) for arch in ARCH_NAMES for shape in get_config(arch).shapes()]


def test_the_port_has_the_reference_archs():
    assert ARCH_NAMES == JAX_ARCH_NAMES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    spec = get_config(arch).shapes()[shape]
    got = roofline.model_flops(get_config(arch), spec["seq_len"], spec["global_batch"],
                               spec["kind"])
    want = jax_model_flops(jax_get_config(arch), spec["seq_len"], spec["global_batch"],
                           spec["kind"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), (k, got, want)


def test_roofline_terms_and_dominance_at_the_h100_constants():
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.terms_from_analysis(roofline.PEAK_FLOPS_BF16, roofline.HBM_BW * 0.5,
                                     roofline.NVLINK_BW * 0.25)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(0.25)
    assert t.dominant == "compute" and t.dominant_s == pytest.approx(1.0)
    assert t.bound_s == t.dominant_s
    t = roofline.terms_from_analysis(1.0, 1.0, roofline.NVLINK_BW)
    assert t.dominant == "collective" and t.to_dict()["collective_s"] == pytest.approx(1.0)
    assert roofline.terms_from_analysis(0.0, roofline.HBM_BW, 0.0).dominant == "memory"


# the six train cells (B=4; whisper's 448 text tokens, paligemma's 256 after
# its patches, S=2048 otherwise): (FLOPs, parameter-positions) as
# chip_smoke.py's _model_flops counted them before it moved here
STEP_MODEL_FLOPS = {
    "tinyllama-1.1b": (2048, 55386052755456, 2118681362432),
    "mamba2-1.3b": (2048, 66047554093056, 2751981420544),
    "hymba-1.5b": (2048, 69967927050240, 2749178511360),
    "granite-moe-1b-a400m": (2048, 23544540954624, 877892993024),
    "whisper-medium": (448, 20619313348608, 710572400640),
    "paligemma-3b": (256, 27894554296320, 1150184062976),
}


@pytest.mark.parametrize("arch", list(STEP_MODEL_FLOPS))
def test_step_model_flops_of_the_train_cells_are_pinned(arch):
    S, flops, n_pos = STEP_MODEL_FLOPS[arch]
    cfg = get_config(arch).replace(dtype="bfloat16")
    abstract = build_model(cfg, device="cpu").abstract_params()  # meta tensors
    got, formula, got_pos = roofline.step_model_flops(cfg, abstract, 4, S)
    assert (got, got_pos) == (flops, n_pos)
    assert formula.startswith("6*B*sum(N_p*p)")


@pytest.mark.parametrize("case", [
    # (Sq, Sk, causal, window, prefix_len)
    (1, 1, True, None, None), (7, 7, True, None, None), (9, 5, True, None, None),
    (5, 9, True, None, None), (12, 12, True, 3, None), (12, 12, True, None, 5),
    (12, 12, True, 4, 6), (8, 11, False, None, None), (30, 30, True, 30, 40),
])
def test_visible_pairs_count_the_mask(case):
    Sq, Sk, causal, window, prefix = case
    mask = tfa._mask(Sq, Sk, causal, window, None, "cpu", prefix)
    assert roofline.visible_pairs(Sq, Sk, causal, window, prefix) == int(
        mask.expand(Sq, Sk).sum())


@pytest.mark.parametrize("dims", [(64, 64), (192, 128), (256, 256)])
def test_attention_costs_count_each_product_over_the_visible_pairs(dims):
    Dqk, Dv = dims
    B, H, KV, Sq, Sk = 2, 8, 2, 40, 40
    pairs = roofline.visible_pairs(Sq, Sk, True, None, None)
    f, b = roofline.attention_cost(B, H, KV, Sq, Sk, Dqk, Dv, 2, causal=True)
    assert f == 2 * B * H * (Dqk + Dv) * pairs
    assert b == 2 * (B * H * Sq * (Dqk + Dv) + B * KV * Sk * (Dqk + Dv))
    fb, bb = roofline.attention_bwd_cost(B, H, KV, Sq, Sk, Dqk, Dv, 2, causal=True)
    # S, dK, dQ over Dqk and dP, dV over Dv: 2.5x the forward at Dqk = Dv
    assert fb == 2 * B * H * (3 * Dqk + 2 * Dv) * pairs
    if Dqk == Dv:
        assert fb == 2.5 * f
    # read q, k, v, o, dO and lse; write dq, dk, dv
    reads = 2 * (B * H * Sq * (Dqk + 2 * Dv) + B * KV * Sk * (Dqk + Dv)) + 4 * B * H * Sq
    writes = 2 * (B * H * Sq * Dqk + B * KV * Sk * (Dqk + Dv))
    assert bb == reads + writes
    # keys past k_len are not seen
    f_len, _ = roofline.attention_cost(B, H, KV, Sq, Sk, Dqk, Dv, 2, causal=False, k_len=25)
    assert f_len == 2 * B * H * (Dqk + Dv) * Sq * 25


def test_ssd_costs_follow_the_chunks():
    f, b = roofline.ssd_cost(1, 512, 64, 64, 128, 256, 2)
    pairs = 2 * (256 * 257 // 2)
    assert f == 2 * 128 * pairs + 64 * (2 * 64 * pairs + 2 * 128 * 64 * 256 + 2 * 128 * 64 * 512)
    assert b == 2 * (2 * 512 * 64 * 64 + 2 * 512 * 128) + 4 * (512 * 64 + 64) + 4 * 64 * 64 * 128
    f_r, _ = roofline.ssd_cost(1, 300, 4, 8, 16, 256, 4)  # a ragged last chunk
    pairs_r = 256 * 257 // 2 + 44 * 45 // 2
    assert f_r == 2 * 16 * pairs_r + 4 * (2 * 8 * pairs_r + 2 * 16 * 8 * 44 + 2 * 16 * 8 * 300)
    fb, bb = roofline.ssd_bwd_cost(4, 2048, 64, 64, 128, 256, 2)
    pairs = 8 * (256 * 257 // 2)
    assert fb == 4 * (6 * 128 * pairs + 64 * (4 * 64 * pairs + 8 * 64 * 128 * 2048
                                               + 2 * 64 * 128 * (2048 - 256)))
    assert bb == 2 * (3 * 4 * 2048 * 64 * 64 + 4 * 4 * 2048 * 128) + 4 * (2 * 4 * 2048 * 64 + 128)


def test_model_flops_scaling_as_the_reference_test_holds_it():
    cfg = get_config("tinyllama-1.1b")
    f1 = roofline.model_flops(cfg, 4096, 256, "train")
    f2 = roofline.model_flops(cfg, 4096, 512, "train")
    assert f2["total"] == pytest.approx(2 * f1["total"])
    assert roofline.model_flops(cfg, 4096, 256, "prefill")["total"] < f1["total"]
    assert np.isfinite(roofline.model_flops(get_config("mamba2-1.3b"), 524288, 1,
                                            "decode")["total"])
