"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + Mamba(SSD) heads, SWA except 3 global-attention layers
(first/middle/last), ssm_state=16. [arXiv:2411.13676; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_heads=25,  # parallel SSD heads match attention heads
    ssm_head_dim=64,
    ssm_chunk=64,
    conv_kernel=4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="hymba-1.5b-reduced",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, window=8, global_layers=(0, 2, 4),
        ssm_state=8, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8,
    )
