"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: flash attention (``csrc/flash_attention.cu``; the model-layout
wrapper is ``flash_attention.flash_attention``) and the Mamba2 SSD chunked
scan (``csrc/ssd.cu``)."""
from .flash_attention import attention_ref, flash_attention_bhsd, flash_attention_ref
from .ssd import ssd_bshp, ssd_decode_step, ssd_ref

__all__ = [
    "attention_ref",
    "flash_attention_bhsd",
    "flash_attention_ref",
    "ssd_bshp",
    "ssd_decode_step",
    "ssd_ref",
]
