"""deepseek-coder-33b [dense]: llama-arch, 62L d=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256. [arXiv:2401.14196; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    kv_pad_to=16,  # beyond-paper: zero-padded KV heads (exact; see EXPERIMENTS §Perf)
    head_dim=128,
    rope_theta=100_000.0,
    max_seq_len=16_384,
    loss_chunk=512,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-coder-33b-reduced",
        num_layers=3, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, loss_chunk=0,
    )
