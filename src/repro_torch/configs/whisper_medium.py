"""whisper-medium [audio enc-dec]: 24L(enc)+24L(dec) d=1024 16H d_ff=4096
vocab=51865. Conv frontend is a STUB: input_specs supplies precomputed frame
embeddings (B, 1500, d_model). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    head_dim=64,
    norm="ln",
    act="gelu_mlp",
    use_rope=False,
    encoder_layers=24,
    encoder_seq=1500,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-medium-reduced",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=12,
    )
