"""tinyllama-1.1b [dense]: llama2-arch small, 22L d=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000. [arXiv:2401.02385; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    head_dim=64,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="tinyllama-1.1b-reduced",
        num_layers=3, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512,
    )
