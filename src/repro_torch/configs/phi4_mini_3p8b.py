"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192
vocab=200064. RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    kv_pad_to=16,  # beyond-paper: zero-padded KV heads (exact; see EXPERIMENTS §Perf)
    head_dim=128,
    rope_theta=10_000.0,
    tie_embeddings=True,
    loss_chunk=512,  # 200k vocab: chunk the CE to bound logits memory
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi4-mini-3.8b-reduced",
        num_layers=3, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=1024, loss_chunk=0,
    )
