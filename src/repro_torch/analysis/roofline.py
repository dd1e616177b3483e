"""Three-term roofline model for one NVIDIA H100 SXM, ported from the
reference's ``repro/analysis/roofline.py`` (whose constants are TPU v5e's):

  compute term    = FLOPs_per_device / peak_FLOPs
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

The FLOPs and bytes come from ``launch/dryrun.py`` (a ``FlopCounterMode``
count and every op's input and output bytes of the port's eager step on
one rank), the collective bytes from ``analysis/traffic.py``.

MODEL_FLOPS (:func:`model_flops`) is the reference's analytic useful work,
unchanged: 6·N·D for a train step (2·N·D for forward-only inference), N =
active non-embedding params, D = tokens, plus the causal-attention term.
The ratio MODEL_FLOPS / counted FLOPs exposes remat, dispatch and padding
overheads of the program.

:func:`step_model_flops` is a second count, the model-FLOP share's
numerator of the port's train cells (``PERF.md`` §2, ``chip_smoke.py``'s
train phases): it counts each parameter over the positions it actually
runs over (an encoder's frames, a VLM's patches, the text for the head),
leaves out zero-padded heads and the routed experts a token is not sent
to, and counts attention over the pairs its mask leaves visible. The two
differ by design: the reference's counts every parameter over every token
and halves attention for causality, whatever the mask.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs.base import ModelConfig, param_count

# NVIDIA H100 SXM5, per card, dense (not the 2:4 sparse figures), from
# NVIDIA's data sheet (https://www.nvidia.com/en-us/data-center/h100/)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, BF16 tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s each way per card (NVLink 4: 900 GB/s both ways)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def dominant_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound_s(self) -> float:
        """Perfect-overlap execution-time lower bound (max of the terms)."""
        return self.dominant_s

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "dominant_s": self.dominant_s,
        }


def terms_from_analysis(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS_BF16,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes_per_device / NVLINK_BW,
    )


def model_flops(cfg: ModelConfig, seq_len: int, global_batch: int, kind: str) -> dict:
    """Analytic useful FLOPs for one step of a shape cell (whole job)."""
    counts = param_count(cfg)
    n_active = counts["active"] - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2
    )
    n_active = max(n_active, 1)
    # lm head is real compute even when embeddings are "excluded"
    head = 2 * cfg.d_model * cfg.vocab_size

    if kind == "train":
        tokens = seq_len * global_batch
        dense = (6 * n_active + 3 * head) * tokens
        attn = _attn_flops(cfg, seq_len, global_batch, backward=True)
    elif kind == "prefill":
        tokens = seq_len * global_batch
        dense = (2 * n_active + head) * tokens
        attn = _attn_flops(cfg, seq_len, global_batch, backward=False)
    else:  # decode: one token per sequence against a seq_len cache
        tokens = global_batch
        dense = (2 * n_active + head) * tokens
        attn = _decode_attn_flops(cfg, seq_len, global_batch)
    return {"dense": float(dense), "attention": float(attn), "total": float(dense + attn)}


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.attention == "none":
        return 0
    return cfg.num_layers + (cfg.encoder_layers if cfg.is_encdec else 0)


def _attn_flops(cfg: ModelConfig, S: int, B: int, *, backward: bool) -> float:
    L = _attn_layers(cfg)
    if L == 0:
        return 0.0
    H = cfg.num_heads
    Dh = cfg.head_dim or 0
    if cfg.attention == "mla":
        Dh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim
    # QK^T + AV: 4 * S^2 * Dh per head, halved by causality
    full = 4.0 * S * S * Dh * H * B
    causal = 0.5 if not cfg.is_encdec else 0.75  # enc is bidirectional
    window_frac = 1.0
    if cfg.window is not None and cfg.window < S:
        n_global = len(cfg.global_layers)
        frac_sw = cfg.window / S
        window_frac = (n_global + (cfg.num_layers - n_global) * frac_sw) / cfg.num_layers
    mult = 3.0 if backward else 1.0
    return full * causal * window_frac * L * mult


def _decode_attn_flops(cfg: ModelConfig, S_cache: int, B: int) -> float:
    L = _attn_layers(cfg)
    if L == 0:
        return 0.0
    if cfg.attention == "mla":
        # absorbed form: scores vs ckv (lora) + rope, values from ckv
        per_tok = 2.0 * cfg.num_heads * (
            2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim
        ) * S_cache
    else:
        Dh = cfg.head_dim or 0
        per_tok = 4.0 * cfg.num_kv_heads * Dh * S_cache * (
            cfg.num_heads / max(cfg.num_kv_heads, 1)
        )
    window_frac = 1.0
    if cfg.window is not None and cfg.window < S_cache:
        n_global = len(cfg.global_layers)
        frac = cfg.window / S_cache
        window_frac = (n_global + (cfg.num_layers - n_global) * frac) / cfg.num_layers
    return per_tok * L * B * window_frac


# -- the train cells' model-FLOP count ----------------------------------------------


def visible_pairs(Sq: int, Sk: int, causal: bool, window=None, prefix_len=None) -> int:
    """The (q, k) pairs a prefill mask leaves visible, queries and keys
    from position 0: all Sq·Sk without ``causal`` (whisper's encoder and
    cross-attention, Sq != Sk there); with it, key k is seen by query q
    when k <= q or k < ``prefix_len``, and k > q - ``window``."""
    if not causal:
        return Sq * Sk
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk, np.maximum(q + 1, prefix_len or 0))
    lo = np.zeros_like(q) if window is None else np.maximum(0, q - window + 1)
    return int(np.maximum(0, hi - lo).sum())


def attention_cost(B, H, KV, Sq, Sk, Dqk, Dv, elem_bytes, *, causal, window=None,
                   prefix_len=None, k_len=None) -> tuple:
    """(FLOPs, bytes) of flash attention's forward, the least work of the
    function: 2 Dqk for Q·Kᵀ and 2 Dv for P·V per visible pair
    (:func:`visible_pairs`, keys below ``k_len``) and head; q, k, v read
    once and the output written once."""
    Sk_seen = Sk if k_len is None else min(Sk, int(k_len))
    flops = 2 * B * H * (Dqk + Dv) * visible_pairs(Sq, Sk_seen, causal, window, prefix_len)
    nbytes = elem_bytes * (B * H * Sq * (Dqk + Dv) + B * KV * Sk * (Dqk + Dv))
    return flops, nbytes


def attention_bwd_cost(B, H, KV, Sq, Sk, Dqk, Dv, elem_bytes, *, causal, window=None,
                       prefix_len=None, k_len=None) -> tuple:
    """(FLOPs, bytes) of flash attention's backward: q, k, v, o, dO and the
    f32 lse read once, dq, dk, dv written once; its five products over the
    visible pairs: S, dK and dQ 2 Dqk a pair and head, dP and dV 2 Dv (at
    Dqk = Dv 2.5x the forward's)."""
    Sk_seen = Sk if k_len is None else min(Sk, int(k_len))
    pairs = visible_pairs(Sq, Sk_seen, causal, window, prefix_len)
    flops = 2 * B * H * (3 * Dqk + 2 * Dv) * pairs
    nbytes = elem_bytes * (B * H * Sq * (Dqk + 2 * Dv) + B * KV * Sk * (Dqk + Dv)) \
        + 4 * B * H * Sq + elem_bytes * (B * H * Sq * Dqk + B * KV * Sk * (Dqk + Dv))
    return flops, nbytes


def _ssd_chunks(S: int, chunk: int) -> tuple:
    full, rest = divmod(S, chunk)
    chunks = [chunk] * full + ([rest] if rest else [])
    return sum(n * (n + 1) // 2 for n in chunks), S - chunks[0]


def ssd_cost(B, S, H, P, N, chunk, elem_bytes) -> tuple:
    """(FLOPs, bytes) of the SSD scan: x, B and C (``elem_bytes``), dt and A
    (f32) read once, y written once and the f32 final state written once.
    FLOPs: C Bᵀ over each chunk's causal pairs (shared by the heads), and
    per head M x over the same pairs, the inter-chunk term C state for every
    chunk but the first (which enters with a zero state), and the state
    update of every chunk."""
    pairs, entering = _ssd_chunks(S, chunk)
    flops = B * (2 * N * pairs + H * (2 * P * pairs + 2 * N * P * entering + 2 * N * P * S))
    nbytes = (elem_bytes * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
              + 4 * B * H * P * N)
    return flops, nbytes


def ssd_bwd_cost(B, S, H, P, N, chunk, elem_bytes) -> tuple:
    """(FLOPs, bytes) of the SSD scan's backward: x, B, C and dy
    (``elem_bytes``), dt and A (f32) read once; dx, dB, dC (``elem_bytes``),
    ddt and dA (f32) written once. FLOPs, the least work of the function:
    over each chunk's causal pairs, C Bᵀ and, since B and C are shared by
    the heads, the chunk-local dB and dC from the scores summed over the
    heads (N each, once); per head, dy xᵀ and du = (C Bᵀ e^..)ᵀ dy over the
    same pairs (P each); and per head and row the state terms: the chunk
    states and the dy Cᵀ sums recomputed, g B into du and gᵀ u into dB, and
    hᵀ dy into dC for every chunk but the first (which enters with a zero
    state)."""
    pairs, entering = _ssd_chunks(S, chunk)
    flops = B * (6 * N * pairs + H * (4 * P * pairs + 8 * P * N * S + 2 * P * N * entering))
    nbytes = elem_bytes * (3 * B * S * H * P + 4 * B * S * N) + 4 * (2 * B * S * H + 2 * H)
    return flops, nbytes


def step_model_flops(cfg: ModelConfig, params, B: int, S: int) -> tuple:
    """Model FLOPs of one train step (no remat recompute), ``S`` the text
    tokens a sample, ``params`` a ``ParamTree`` or its tree (the meta
    tensors of ``Model.abstract_params`` will do): 6 per parameter and
    position for the parameter products each position runs. A decoder-side
    parameter runs over the decoder's positions (a VLM's image patches and
    text, S otherwise), an encoder-decoder's encoder parameters and its
    decoder layers' cross-attention K and V projections over the encoder's
    frames, a VLM's vision projection over its patches, and the head over
    the text only; the embedding table counts only where the head is tied
    to it (its forward is a gather, not a product). Without the zero-padded
    attention heads (``kv_pad_to``: their products are of zeros) and, in
    each MoE layer, with the ``experts_per_token`` routed experts a token is
    sent to of the ``num_experts`` (the shared experts and the router all
    count; the port's ``moe_dense`` runs every expert, which is not
    counted). Each attention call's two products over the (q, k) pairs its
    mask leaves visible (causal, within the window on a window layer, the
    VLM's prefix span; all pairs in the encoder and the cross-attention),
    forward (2 Dqk + 2 Dv per pair per head) and backward (twice that). The
    SSD scan's own products are not counted. Returns (FLOPs, formula, the
    parameters counted, each at its positions, summed over the positions of
    one sample)."""
    from ..models.lm import encoder_plan, stack_plan
    from ..tree import tree_flatten_with_keys

    d = cfg.d_model
    F = cfg.encoder_seq if cfg.is_encdec else 0
    P = cfg.num_image_tokens if cfg.family == "vlm" else 0
    S_dec = P + S
    tree = params.tree() if hasattr(params, "tree") else params
    by_pos: dict = {}  # positions a sample -> parameters run over them
    for key, leaf in tree_flatten_with_keys(tree):
        parts = key.split(".")
        if parts[0].startswith("enc_") or ("cross" in parts and parts[-1] in ("wk", "wv")):
            pos = F
        elif parts[0] == "vision_proj":
            pos = P
        elif parts[0] == "embed":
            pos = S if cfg.tie_embeddings else 0
        elif parts[0] == "lm_head":
            pos = S
        else:
            pos = S_dec
        by_pos[pos] = by_pos.get(pos, 0) + leaf.numel()
    idle = 0
    dqk = dv = cfg.head_dim
    if cfg.attention == "gqa":  # wq, wo and wk, wv over the padded heads
        pads = 2 * (cfg.heads_padded - cfg.num_heads) + 2 * (cfg.kv_heads_padded - cfg.num_kv_heads)
        idle += cfg.num_layers * pads * cfg.head_dim * d
    elif cfg.attention == "mla":
        dqk, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    if cfg.is_moe:
        idle += (sum(g.count for g in stack_plan(cfg) if g.moe)
                 * (cfg.num_experts - cfg.experts_per_token) * 3 * d * cfg.moe_d_ff)
    by_pos[S_dec] -= idle
    attn = 0
    if cfg.attention != "none":
        calls = [(g.count, S_dec, S_dec, True, None if g.is_global else cfg.window)
                 for g in stack_plan(cfg)]
        if cfg.is_encdec:  # the encoder's layers, and each decoder layer's cross-attention
            calls += [(g.count, F, F, False, None) for g in encoder_plan(cfg)]
            calls.append((cfg.num_layers, S_dec, F, False, None))
        for count, Sq, Sk, causal, window in calls:
            pairs = visible_pairs(Sq, Sk, causal, window, P or None)
            attn += 6 * count * B * cfg.num_heads * (dqk + dv) * pairs
    formula = ("6*B*sum(N_p*p) + 6*B*H*(Dqk+Dv)*(visible pairs) per attention call; N_p the "
               "parameters run over p positions a sample (encoder and cross K/V: the frames; "
               "vision projection: the patches; tied head: the text; the rest: the decoder's "
               "positions), less the embedding table (untied), zero-padded heads and the routed "
               "experts a token is not sent to (MoE: experts_per_token of num_experts active)")
    n_pos = sum(n * pos for pos, n in by_pos.items())
    return 6 * B * n_pos + attn, formula, n_pos
