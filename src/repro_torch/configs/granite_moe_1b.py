"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) vocab=49155,
32 experts top-8, expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=0,  # every layer is MoE
    vocab_size=49_155,
    kv_pad_to=16,  # beyond-paper: zero-padded KV heads (exact; see EXPERIMENTS §Perf)
    head_dim=64,
    tie_embeddings=True,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    capacity_factor=1.25,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-1b-a400m-reduced",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=512, num_experts=8, experts_per_token=2, moe_d_ff=96,
    )
