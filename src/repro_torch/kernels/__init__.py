"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: flash attention (``csrc/flash_attention.cu``). The model-layout
wrapper is ``flash_attention.flash_attention``."""
from .flash_attention import attention_ref, flash_attention_bhsd, flash_attention_ref

__all__ = ["attention_ref", "flash_attention_bhsd", "flash_attention_ref"]
