"""Model/architecture configuration schema.

One dataclass covers every assigned family (dense / moe / ssm / hybrid /
enc-dec audio / vlm). Family-specific fields default to "off". Each assigned
architecture lives in ``repro/configs/<id>.py`` as a module-level ``CONFIG``
plus a ``reduced()`` smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Shape suites assigned to the LM families (seq_len, global_batch).
SHAPES = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // num_heads
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp (plain)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    norm: str = "rms"  # rms | ln (whisper)
    norm_eps: float = 1e-5
    use_rope: bool = True  # False = absolute/sinusoidal positions (whisper)
    rope_theta: float = 10_000.0
    max_seq_len: int = 4_096  # advisory; shapes override

    # -- attention variants -------------------------------------------------
    attention: str = "gqa"  # gqa | mla | none
    # Zero-padded KV heads (beyond-paper TP optimization, EXPERIMENTS.md
    # §Perf): pad the KV-head axis to this count, preserving the GQA group
    # size, with exactly-zero pad weights. Zero pads are provably inert
    # (zero V ⇒ zero outputs ⇒ zero grads ⇒ stay zero under AdamW), so the
    # model function is IDENTICAL while every head dim becomes divisible by
    # the 16-way model axis (no row-parallel all-reduce fallback).
    kv_pad_to: int = 0
    window: Optional[int] = None  # sliding-window size (None = full)
    global_layers: Tuple[int, ...] = ()  # layer indices with full attention
    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff of routed experts)
    first_dense_layers: int = 0  # deepseek-v2: first k layers use dense MLP
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # -- SSM (mamba2 SSD) -----------------------------------------------------
    ssm_state: int = 0  # N (state dim per head); 0 = no ssm
    ssm_heads: int = 0  # defaults to num_heads when hybrid, d_inner/64 for ssm
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # -- enc-dec (whisper) ------------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1_500  # whisper: 30s of audio at 50 fps after conv

    # -- vlm (paligemma) --------------------------------------------------------
    vision_dim: int = 0  # stub frontend embedding dim (SigLIP width)
    num_image_tokens: int = 0

    # -- sharding ---------------------------------------------------------------
    sharding_rules: Tuple[Tuple[str, str], ...] = ()  # logical->mesh overrides

    # -- numerics / execution ---------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"  # full | none
    loss_chunk: int = 0  # 0 = unchunked cross-entropy
    # use the Pallas kernels on TPU (dry-run/CPU uses the jnp reference path)
    use_kernels: bool = False

    # ------------------------------------------------------------------------

    def __post_init__(self) -> None:
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def kv_heads_padded(self) -> int:
        return max(self.kv_pad_to, self.num_kv_heads) if self.num_kv_heads else 0

    @property
    def heads_padded(self) -> int:
        if not self.num_heads:
            return 0
        group = self.num_heads // max(self.num_kv_heads, 1)
        return self.kv_heads_padded * group

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no full-attention-over-full-seq layers,
        except a bounded number of global layers (hymba-style)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid" and self.window is not None:
            return True
        return False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def shapes(self) -> dict:
        """The shape suite this arch runs (per assignment skip rules)."""
        out = {}
        for name, spec in SHAPES.items():
            if name == "long_500k" and not self.sub_quadratic:
                continue  # full-attention archs skip (DESIGN.md §4)
            out[name] = spec
        return out


def param_count(cfg: ModelConfig) -> dict:
    """Analytic parameter counts (total + active) for MODEL_FLOPS."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    embed = V * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    if cfg.attention == "gqa":
        per_layer += d * h * hd + 2 * d * kv * hd + h * hd * d
    elif cfg.attention == "mla":
        qk_hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        q_in = cfg.q_lora_rank or d
        per_layer += (d * cfg.q_lora_rank if cfg.q_lora_rank else 0)
        per_layer += q_in * h * qk_hd
        per_layer += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        per_layer += cfg.kv_lora_rank * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        per_layer += h * cfg.v_head_dim * d
    mlp_mult = 3 if cfg.act in ("silu", "gelu") else 2
    dense_mlp = mlp_mult * d * cfg.d_ff
    if cfg.is_moe:
        routed = cfg.num_experts * mlp_mult * d * cfg.moe_d_ff
        shared = cfg.num_shared_experts * mlp_mult * d * cfg.moe_d_ff
        active_mlp = (cfg.experts_per_token + cfg.num_shared_experts) * mlp_mult * d * cfg.moe_d_ff
        router = d * cfg.num_experts
        moe_layers = L - cfg.first_dense_layers
        total_mlp = moe_layers * (routed + shared + router) + cfg.first_dense_layers * dense_mlp
        active_mlp_total = moe_layers * (active_mlp + router) + cfg.first_dense_layers * dense_mlp
    else:
        total_mlp = L * dense_mlp
        active_mlp_total = total_mlp
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * d if cfg.family == "ssm" else cfg.num_heads * cfg.head_dim
        nh = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
        # in/out/gate projections dominate; per-head state params are small
        ssm_per_layer = (
            d * d_inner * 2 + d_inner * d + d_inner * cfg.conv_kernel + nh * (2 + cfg.ssm_state)
        )
        per_layer += ssm_per_layer
    attn_total = L * per_layer
    enc = 0
    if cfg.is_encdec:
        enc_attn = d * h * hd * 2 + 2 * d * kv * hd * 2 + 2 * h * hd * d  # self+cross
        enc = cfg.encoder_layers * (enc_attn + dense_mlp)
    total = embed + attn_total + total_mlp + enc
    active = embed + attn_total + active_mlp_total + enc
    return dict(total=total, active=active, non_embedding=total - embed)
