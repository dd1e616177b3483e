"""On-card tests of the port (marker ``gpu``): they skip without a CUDA
device and import nothing of JAX, so they run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA flash kernel is held against its plain version over the mask and
shape sweep, and a small model served on the card is held against the same
weights decoded on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as tfa
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version_on_card(dtype):
    dev = _cuda()
    dt, tol = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 2e-2)}[dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for name, (B, H, KV, Sq, Sk, Dh, causal, window, k_len) in SWEEP.items():
        shapes = [(B, Sq, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh)]  # model layout
        q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(dev, dt) for s in shapes)
        mask = dict(causal=causal, window=window, k_len=k_len)
        before = tfa.flash_attention_bhsd.launches
        got = tfa.flash_attention(q, k, v, **mask)
        torch.cuda.synchronize()
        assert tfa.flash_attention_bhsd.launches == before + 1
        assert (0, dt, Dh) in tfa._checked  # its first launch was checked
        want = tfa.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       **mask).transpose(1, 2)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (name, dtype, err)


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
