"""deepseek-v2-236b [moe]: 60L d=5120 128H, MLA (kv_lora=512, rope 64),
2 shared + 160 routed experts top-6 (d_ff 1536), first layer dense
(d_ff 12288), vocab=102400. [arXiv:2405.04434; hf]

Sharding override: per-expert hidden dim additionally sharded over `data`
(2D expert sharding) so the 236B fit on 256 chips (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12_288,  # the first (dense) layer
    vocab_size=102_400,
    head_dim=128,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_dense_layers=1,
    capacity_factor=1.25,
    loss_chunk=512,
    sharding_rules=(("expert_mlp", "data"),),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-236b-reduced",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, q_lora_rank=32, kv_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        num_experts=8, experts_per_token=2, num_shared_experts=2,
        moe_d_ff=96, loss_chunk=0, sharding_rules=(),
    )
