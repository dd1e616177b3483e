"""mamba2-1.3b [ssm]: 48L d=2048, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    head_dim=0,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # d_inner=4096 -> 64 heads
    ssm_chunk=256,
    conv_kernel=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-1.3b-reduced",
        num_layers=3, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8,
    )
