"""paligemma-3b [vlm]: SigLIP frontend STUB + gemma backbone, 18L d=2048
8H (MQA kv=1) d_ff=16384 vocab=257216. input_specs supplies precomputed
patch embeddings (B, 256, 1152). [arXiv:2407.07726; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257_216,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    vision_dim=1152,
    num_image_tokens=256,
    loss_chunk=256,  # 257k vocab
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="paligemma-3b-reduced",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=192, vocab_size=1024, vision_dim=48, num_image_tokens=4,
        loss_chunk=0,
    )
