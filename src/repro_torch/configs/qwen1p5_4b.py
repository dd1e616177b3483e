"""qwen1.5-4b [dense]: 40L d=2560 20H (GQA kv=20) d_ff=6912 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    kv_pad_to=32,  # beyond-paper: zero-padded KV heads (exact; see EXPERIMENTS §Perf)
    head_dim=128,
    qkv_bias=True,
    rope_theta=10_000.0,
    loss_chunk=512,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen1.5-4b-reduced",
        num_layers=3, d_model=96, num_heads=4, num_kv_heads=4, head_dim=24,
        d_ff=192, vocab_size=1024, loss_chunk=0,
    )
