// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the reference's Pallas TPU kernel
// `src/repro/kernels/flash_attention.py:_kernel` (launched by
// `flash_attention_bhsd`). It recomputes the same function:
// softmax(Q K^T * Dqk^-1/2 + mask) V per (batch, q-head), GQA q-head h reading
// kv-head h / (H / KV), masks causal (top-left aligned, positions from 0)
// with an optional prefix-LM span (keys below prefix_len visible to every
// query, as the reference's causal_mask_bias), sliding window
// (k > q - window) and valid length (k < k_len), finite -1e30
// for masked scores, the denominator floored at 1e-30, output in the input
// dtype. With a non-null `lse` it also writes each row's log-sum-exp, which
// the backward (csrc/flash_attention_bwd.cu) recomputes P from.
//
// What bounds it on this card: at tinyllama prefill (H=32, KV=4, Dh=64) the
// work is 4 * Sq * Sk/2 * Dh FLOPs per head against q, k, v and o moved once,
// so short prompts are bounded by bytes and long ones by tensor-core FLOPs
// (at H100 peaks, 989 TFLOP/s bf16 and 3.35 TB/s, the crossover is near
// Sq = Sk = 660 for causal attention). At batch 1 and S <= 1024 the grid is a
// few hundred CTAs, so latency and occupancy, not either peak, decide.
//
// bf16 at Dqk = Dv = 32 and 64 (the served tinyllama, hymba, granite-moe
// and whisper): one CTA of 8 warps per (batch * q-head, 64-row q tile); the
// grid dispatches every head's last q tile first, since on the causal
// diagonal it sees the most keys. K and V stay bf16 in a two-stage
// shared-memory ring of 128-key tiles filled by 16-byte cp.async copies,
// so the next tile loads while this one computes. Two groups of 4 warps
// (two warpgroups) split each tile's keys in halves: at prefill batch 1 the
// card holds too few CTAs to hide the latency of one group walking every
// key tile, and the split halves each group's walk. The online softmax
// (running max, denominator, rescale, all f32, -1e30 masking before the
// max) runs on the score fragments in registers, and P is rounded to bf16
// in registers and fed straight back as the A operand of P V; only key
// halves on the diagonal, at the window's edge or at the valid length
// evaluate the mask. At the end the groups merge (max, sum, output)
// per row through shared memory, exactly: both rescale to the common max.
//  - Dh = 64, the served head dim (flash_fwd_wgmma): each group is one
//    warpgroup issuing wgmma.m64n64k16 (bf16 operands, f32 accumulators):
//    Q K^T with Q and K read by the tensor cores from 128-byte-swizzled
//    shared memory, P V with P from registers and V from shared memory.
//  - Dh = 32 (flash_fwd_mma): each warp of a group owns 16 q rows
//    and runs mma.sync.m16n8k16 fed by ldmatrix from rows padded by 16
//    bytes. Each warp re-reads K and V fragments for only 16 rows, the
//    shared-memory traffic that wgmma's direct B reads remove.
// What holds the Dh = 64 form back next: each group waits for its Q K^T
// before the softmax and for its P V before the next tile (no overlap of
// the two within a warpgroup), and the loads come from cp.async issued by
// the same warps rather than TMA from a producer warp. The wrapper requires
// 16-byte aligned base pointers and strides and raises otherwise.
//
// bf16 at the wide pairs (flash_fwd_wide): Dqk = Dv = 128, the dense
// configs' (phi4-mini, qwen1.5 and deepseek-coder, their KV heads
// zero-padded: 48/16, 32/32 and 112/16 heads), Dqk = 192, Dv = 128, MLA's
// expanded prefill and training (deepseek-v2: 128 nope + 64 rope dims of
// q and k, 128 of v, H = KV = 128), and Dqk = Dv = 256, gemma's (paligemma:
// MQA, 8 q-heads on one kv-head, a prefix-LM span over 256 image tokens).
// The work per head is 2 (Dqk + Dv) FLOPs a visible (q, k) pair against
// q, k, v and o moved once: the training attention (S=2048, causal) is
// bounded by operations (phi4-mini's 0.209 ms, deepseek-v2's 0.174 at 989
// TFLOP/s), the prefills (S=512) by bytes. What the pre-Hopper form
// (flash_fwd_mma at these pairs) lost there: mma.sync warps re-reading K
// and V fragments for 16 rows each, and a K/V byte read into shared memory
// feeding only the CTA's 64 q rows.
//  - CTA: three warpgroups. Warpgroup 0 is the producer: it gives its
//    registers up (setmaxnreg) and one thread copies Q and each 64-key K/V
//    tile by TMA into a ring of four stages at 128/128 and 192/128 and two
//    at 256/256,
//    each stage's bytes counted on an mbarrier. Warpgroups 1 and 2 own q
//    rows 0 .. 63 and 64 .. 127 of the CTA's 128: a K/V byte feeds 128
//    rows. Each waits for a stage, computes, and releases it on a second
//    mbarrier; no CTA-wide barrier after the start, so the two consumers
//    run apart. Tiles are 64-column slabs in the 128-byte swizzle, which
//    the copy writes. The tensor maps follow the (B, S, H, D) views'
//    strides, built for each launch on the host. Grid: (batch * q-head,
//    128-row tile), last rows first.
//  - S = Q K^T: a chain of wgmma.m64n64k16 over the slabs of the depth (8
//    k-steps at 128, 12 at 192, 16 at 256), K K-major from shared memory.
//    At 128 and 192 each warp keeps its 16 q rows' A operands (32 or 48
//    registers) and the product reads only K; at 256 they would not fit
//    beside the 128 output accumulators, and Q is read from its slab tile.
//  - O += P V: P rounded to bf16 in registers, V MN-major as one
//    m64n128k16 a k-step over two slabs (the slab stride as the leading
//    byte offset), two of them at 256 (one m64n256 spilled in K1-bwd's dQ).
//  - The softmax: row maxima and sums as trees over a thread's 16 values,
//    the scale folded into the exponent (one FFMA) outside the tiles that
//    evaluate the mask.
//  - Shared memory 162 KiB at 128/128, 210 KiB at 192/128 and 194 KiB at
//    256/256, one CTA an SM; the kernel is built for 168 registers a thread (384 threads), the
//    consumers raise theirs to 240 and the producer lowers its to 24; no
//    spill.
//  Trials (chip calls, each building a variant of this source beside the
//  kept form and timing both by CUDA-graph replay in one call: bf16 device
//  ms at deepseek-v2 MLA S=512 / S=2048 / paligemma S=320 prefix 256 /
//  S=512 prefix 256, on an H100 80GB HBM3 at 700 W; the losing forms' code
//  is gone). First the form with two
//  warpgroups that also issue the loads (16-byte cp.async, a two-stage
//  ring, CTA-wide barriers); flash_fwd_mma read 0.1035 / 1.156 / 0.03287
//  / 0.04589:
//  - the Dh = 64 form's split (one 64-row q tile, the warpgroups taking the
//    key halves of 128-key tiles, merged at the end): 0.0852 / 0.784 /
//    0.0244 / 0.0331 against 0.0715 / 0.622 / 0.0205 / 0.0330.
//  - two CTAs an SM at 192/128 (one ring stage, K and V refilled apart, a
//    128-register cap): 236 bytes of spill, 0.778 against 0.796 ms at
//    S=2048; one stage at one CTA an SM: 0.0906 / 0.811 / 0.0236 / 0.0391
//    against 0.0869 / 0.796 / 0.0229 / 0.0379; three or four stages at
//    192/128: 0.0636 / 0.603 and 0.0641 / 0.609 against 0.0646 / 0.598.
//  - the softmax's trees and FFMA against sequential maxima and sums and a
//    separate scale: 0.0869 / 0.796 / 0.0229 / 0.0379 before, 0.0715 /
//    0.622 / 0.0205 / 0.0330 after (two runs); rescaling the output only
//    where a row's max moved read 0.609 against 0.597 always; Q from
//    shared memory at 192: 0.0715 / 0.622 against 0.0699 / 0.604.
//  - the grid in blocks of (batch, kv-head) pairs whose K and V fit half
//    the L2: 0.0869 / 0.796 against 0.0836 / 0.791 without.
//  - the next tile's Q K^T in flight beside this tile's P V (three K
//    stages): 0.0816 / 0.721 / 0.0219 / 0.0348 against 0.0727 / 0.629 /
//    0.0207 / 0.0330; warpgroup 1 issuing its Q K^T after warpgroup 0's
//    (named barriers): 0.0637 / 0.588 / 0.0200 / 0.0314 against 0.0666 /
//    0.608 / 0.0197 / 0.0309, within the spread of two runs (3 %).
//  - ablations at S=2048 (0.609 ms): without the K/V refills 0.439,
//    without the softmax 0.482, without Q K^T 0.506, without P V 0.568;
//    the refills and barriers alone 0.257, about 5.1 TB/s out of L2: the
//    loads the product warps issued were the largest part, hence the
//    producer warpgroup.
//  Then the producer warpgroup (kept) against that form: 0.05607 / 0.5243
//  / 0.01709 / 0.02319 against 0.06703 / 0.6023 / 0.02068 / 0.03236; on it,
//  the consumers taking turns at Q K^T: 0.05811 / 0.5253 / 0.01706 /
//  0.02275 against 0.05639 / 0.5240 / 0.01677 / 0.02154; the next tile's
//  Q K^T beside this tile's P V at 192 (four stages): 0.06368 / 0.5571
//  against 0.05793 / 0.5262.
//  - a grid for paligemma's MQA (python3 chip_smoke.py --k1-wide in this
//    form's and the packed form's checkouts, two turns each): the 8
//    q-heads of the kv-head packed into the M rows (a warpgroup's 64 rows
//    8 heads x 8 positions, Q's TMA box 64 columns x 8 heads x 8
//    positions), so a K/V tile is read once for 8 heads and S=320 leaves
//    no padded rows: 80 CTAs at S=320, 128 at S=512, against 96 and 128.
//    0.01812 / 0.01811 against 0.01575 / 0.01572 at S=320, 0.02258 /
//    0.02366 against 0.02264 / 0.02249 at S=512; deepseek-v2 (no
//    packing) unchanged. No grid of 128-row CTAs fills the 132 SMs there
//    (S=320's 10 240 rows make 80), and in both forms the CTAs that see 5
//    key tiles set the time; packed, both of their consumers work.
//  Trials at 128/128 (one chip call, each form built from its own copy of
//  this source and run in turns, two runs each; bf16 device ms by CUDA-graph
//  replay at phi4-mini's training shape B=4 H=48 KV=16 S=2048 / qwen1.5's
//  H=KV=32 S=2048 / the prefills at S=512 B=1 of phi4-mini / qwen1.5 /
//  deepseek-coder H=112 KV=16; H100 80GB HBM3 at 700 W): this form 0.5586 /
//  0.4303 / 0.01904 / 0.01528 / 0.04149 and 0.5565 / 0.4305 / 0.01959 /
//  0.01498 / 0.04097; six ring stages in place of four 0.5616 / 0.4325 /
//  0.01956 / 0.01516 / 0.04138 and 0.5521 / 0.4315 / 0.01934 / 0.01519 /
//  0.04105 (within the spread: four kept); the Dh = 64 form
//  (flash_fwd_wgmma) widened to two slabs, one CTA an SM, 1.192 / 0.8507 /
//  0.03453 / 0.02309 / 0.07460 and 1.190 / 0.8518 / 0.03442 / 0.02330 /
//  0.07390; the replaced flash_fwd_mma 1.593 / 1.070 / 0.03817 / 0.02582 /
//  0.08280 and 1.591 / 1.068 / 0.03844 / 0.02608 / 0.08214; SDPA (cuDNN,
//  is_causal) 0.3785 / 0.2587 / 0.01774 / 0.01320 / 0.02853.
// What bounds it next: at S=2048 the kept form reaches a third of the
// tensor cores' peak at 192/128 and 37 % at 128/128 (phi4-mini), where
// SDPA reads 1.5x faster. Each consumer still waits for its Q K^T before
// its softmax and for its P V before the next tile, and the two trials that
// overlap those read no faster; no profiler here counts the stalls.
//
// f32, the parity path (flash_fwd_f32): FMA tiles on the FP32 pipes; the
// tensor cores take no f32 operand that holds a 1e-4 tolerance. One CTA per
// (batch * q-head, 64-row q tile), 256 threads, each thread owning a 4 x 4
// micro-tile of the 64 x 64 score tile and 4 rows x Dv/16 columns of the
// output, K/V staged in shared memory as f32 (146 KiB at 192/128, 209.5 KiB
// at 256/256, under the 227 KiB a CTA may opt in to).
//
// Both: tiles wholly above the causal diagonal (and past the prefix span),
// left of the window or past the valid length are skipped; ragged Sq and Sk are masked (zero-filled
// loads), never asserted away; inputs are addressed through strides, so
// (B, S, H, Dh) activations need no transpose copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG_INF = -1e30f;  // finite: (-inf) - (-inf) would be NaN
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;  // <= 0: no window
  int k_len;   // keys at positions >= k_len are masked
  int prefix_len;  // causal: keys at positions < prefix_len are visible to every query
  float scale;
  float* lse;  // optional (B, H, Sq) f32 row statistics m + log(l); null: not written
};

// the key range [k_lo, k_hi) a q tile of `rows` rows starting at q0 can
// see, k_lo on a boundary of bk-key tiles; a causal tile's keys run to its
// diagonal or to the end of the prefix-LM span, whichever is further
struct KeyRange {
  int k_valid, q_last, k_lo, k_hi;
  __device__ KeyRange(const Params& p, int q0, int bk, int rows = BQ) {
    k_valid = min(p.k_len, p.Sk);
    q_last = min(q0 + rows, p.Sq) - 1;
    k_hi = p.causal ? min(k_valid, max(q_last + 1, p.prefix_len)) : k_valid;
    k_lo = p.window > 0 ? max(0, q0 - p.window + 1) / bk * bk : 0;
  }
};

__device__ __forceinline__ bool visible(const Params& p, int k_valid, int qi, int kj) {
  bool ok = kj < k_valid;
  if (p.causal) ok = ok && (kj <= qi || kj < p.prefix_len);
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// -- bf16: tensor cores --------------------------------------------------------

constexpr int MMA_WARPS = 8;  // two groups of 4; a group's warp owns 16 q rows
constexpr int MMA_THREADS = 32 * MMA_WARPS;

// Keys per shared-memory tile, half of them to each warp group: a warp's
// score and output fragments fit 128 registers at Dqk = 32, two CTAs an SM
constexpr int MMA_BK = 128;

template <int DQK, int DV>
constexpr int mma_smem_bytes() {
  // the q tile and two stages of k, rows of Dqk + 8; two stages of v, rows
  // of Dv + 8; the groups' merge reuses it
  return ((BQ + 2 * MMA_BK) * (DQK + 8) + 2 * MMA_BK * (DV + 8)) * 2;
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 2) flash_fwd_mma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = MMA_BK;
  constexpr int HK = BK / 2;    // keys of a tile for one warp group
  constexpr int LD = DQK + 8;   // padded q and k row, in elements
  constexpr int LDV = DV + 8;   // padded v row
  constexpr int KD = DQK / 16;  // k-steps of Q K^T
  constexpr int ND = DV / 8;    // n-tiles of O
  constexpr int NS = HK / 8;    // n-tiles of a warp's S
  constexpr int CH = DQK / 8;   // 16-byte pieces of a q or k row
  constexpr int CHV = DV / 8;   // of a v row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LD;       // [stage][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;   // [stage][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wr = warp & 3;  // key half, 16-row slot
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  // q tiles are the slower grid axis, last first: every head's heaviest
  // causal tiles are dispatched before any lighter one
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const KeyRange kr(p, q0, BK);

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, d = (c % CH) * 8, qi = q0 + r;
    tc::cp_async16(q_s + r * LD + d, qg + (long long)min(qi, p.Sq - 1) * p.q_ss + d, qi < p.Sq);
  }
  auto load_kv = [&](int k0, int stage) {
    bf16* ks = k_s + stage * BK * LD;
    bf16* vs = v_s + stage * BK * LDV;
    for (int c = tid; c < BK * CH; c += MMA_THREADS) {
      const int r = c / CH, d = (c % CH) * 8, kj = k0 + r;
      tc::cp_async16(ks + r * LD + d, kg + (long long)min(kj, p.Sk - 1) * p.k_ss + d, kj < p.Sk);
    }
    for (int c = tid; c < BK * CHV; c += MMA_THREADS) {
      const int r = c / CHV, d = (c % CHV) * 8, kj = k0 + r;
      tc::cp_async16(vs + r * LDV + d, vg + (long long)min(kj, p.Sk - 1) * p.v_ss + d, kj < p.Sk);
    }
  };
  if (kr.k_lo < kr.k_hi) load_kv(kr.k_lo, 0);
  tc::cp_async_commit();

  // log2 domain: p = 2^(s * scale * log2(e) - m)
  const float sl2 = p.scale * 1.4426950408889634f;
  const int row0 = q0 + 16 * wr + g;  // this lane's rows: row0 and row0 + 8
  uint32_t qf[KD][4];  // this warp's q fragments, read once
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int k0 = kr.k_lo; k0 < kr.k_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < kr.k_hi) load_kv(k0 + BK, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, the first time, q) has landed
    __syncthreads();
    if (k0 == kr.k_lo) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        tc::ldsm_x4(qf[kd], q_s + (16 * wr + tc::x_row(lane)) * LD + 16 * kd + tc::x_col(lane));
    }
    const int kh = k0 + HK * grp;  // this group's first key
    if (kh < kr.k_hi) {            // else every key of its half is masked
      const bf16* ks = k_s + (stage * BK + HK * grp) * LD;
      const bf16* vs = v_s + (stage * BK + HK * grp) * LDV;

      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          tc::ldsm_x4(r, ks + (16 * np + tc::y_row(lane)) * LD + 16 * kd + tc::y_col(lane));
          tc::mma(s[2 * np], qf[kd], r[0], r[1]);
          tc::mma(s[2 * np + 1], qf[kd], r[2], r[3]);
        }
      }

      // online softmax on the fragments; only key halves at the diagonal,
      // the window's edge or the valid length evaluate the mask
      const bool edge = kh + HK > kr.k_valid ||
                        (p.causal && kh + HK - 1 > q0 && kh + HK > p.prefix_len) ||
                        (p.window > 0 && kh <= kr.q_last - p.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (edge && !visible(p, kr.k_valid, row0 + (e >> 1) * 8, kh + 8 * n + 2 * t + (e & 1)))
            x = NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a row's 4 lanes are one quad
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];  // this lane's share of the row sum; quads add up at the end
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_ftz(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) {
        uint32_t a[4];
        tc::pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t r[4];
          tc::ldsm_x4_trans(r, vs + (16 * kk + tc::x_row(lane)) * LDV + 16 * dp + tc::x_col(lane));
          tc::mma(o[2 * dp], a, r[0], r[1]);
          tc::mma(o[2 * dp + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the two groups' (max, sum, output) per row: group 1 leaves its
  // state in shared memory (laid out [slot][value][lane], conflict-free),
  // group 0 rescales both to the common max and writes the rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  constexpr int VALS = 4 * ND + 4;
  tc::cp_async_wait<0>();
  __syncthreads();  // with no key tile at all, q's copy may still have been in flight
  float* red = reinterpret_cast<float*>(smem_raw) + wr * VALS * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = o[n][e];
    red[(4 * ND) * 32] = m[0];
    red[(4 * ND + 1) * 32] = m[1];
    red[(4 * ND + 2) * 32] = l[0];
    red[(4 * ND + 3) * 32] = l[1];
  }
  __syncthreads();
  if (grp == 1) return;
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = red[(4 * ND + i) * 32], l1 = red[(4 * ND + 2 + i) * 32];
    const float mm = fmaxf(m[i], m1);
    a0[i] = exp2_ftz(m[i] - mm);
    a1[i] = exp2_ftz(m1 - mm);
    const float lsum = fmaxf(l[i] * a0[i] + l1 * a1[i], 1e-30f);
    inv[i] = 1.f / lsum;
    // the row statistics for the backward, natural log: (m + log2 l) ln 2
    const int qi = row0 + 8 * i;
    if (p.lse != nullptr && t == 0 && qi < p.Sq)
      p.lse[(long long)bh * p.Sq + qi] = (mm + log2f(lsum)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = (o[n][2 * i] * a0[i] + red[(4 * n + 2 * i) * 32] * a1[i]) * inv[i];
      const float x1 = (o[n][2 * i + 1] * a0[i] + red[(4 * n + 2 * i + 1) * 32] * a1[i]) * inv[i];
      *reinterpret_cast<uint32_t*>(og + qi * p.o_ss + 8 * n + 2 * t) = tc::pack_bf16(x0, x1);
    }
  }
}

// bf16 at Dh = 64 (flash_fwd_wgmma): the CTA, grid, ring and two-group
// split of flash_fwd_mma, each group one warpgroup whose products are
// wgmma: S = Q K^T reads Q and its 64-key half of K straight from shared
// memory (K-major), and O += P V takes P from registers and V from shared
// memory (MN-major). The tiles use the 128-byte swizzle (tensor_core.cuh)
// in place of padded rows, filled by the same cp.async copies, fenced to
// the async proxy before the products read them.

constexpr int WG_BK = 128;  // keys per tile, 64 per warpgroup
constexpr int WG_SMEM = (BQ + 4 * WG_BK) * 128 + 1024;  // tiles of 128-byte rows, 1 KiB alignment slack

__global__ void __launch_bounds__(MMA_THREADS, 2) flash_fwd_wgmma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = WG_BK, HK = BK / 2, NS = HK / 8, ND = 8, CH = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start on 1 KiB boundaries
  unsigned char* q_s = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + BQ * 128;      // [stage][BK rows of 128 bytes]
  unsigned char* v_s = k_s + 2 * BK * 128;  // [stage][BK rows of 128 bytes]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wr = warp & 3;  // warpgroup (key half), 16-row slot
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const KeyRange kr(p, q0, BK);

  for (int c = tid; c < BQ * CH; c += MMA_THREADS) {
    const int r = c / CH, pc = c % CH, qi = q0 + r;
    tc::cp_async16(q_s + tc::swz128(r, pc), qg + (long long)min(qi, p.Sq - 1) * p.q_ss + 8 * pc,
                   qi < p.Sq);
  }
  auto load_kv = [&](int k0, int stage) {
    unsigned char* ks = k_s + stage * BK * 128;
    unsigned char* vs = v_s + stage * BK * 128;
    for (int c = tid; c < BK * CH; c += MMA_THREADS) {
      const int r = c / CH, pc = c % CH, kj = k0 + r;
      const bool in = kj < p.Sk;
      const long long row = min(kj, p.Sk - 1);
      tc::cp_async16(ks + tc::swz128(r, pc), kg + row * p.k_ss + 8 * pc, in);
      tc::cp_async16(vs + tc::swz128(r, pc), vg + row * p.v_ss + 8 * pc, in);
    }
  };
  if (kr.k_lo < kr.k_hi) load_kv(kr.k_lo, 0);
  tc::cp_async_commit();

  const float sl2 = p.scale * 1.4426950408889634f;
  const int row0 = q0 + 16 * wr + g;  // this lane's rows: row0 and row0 + 8
  const uint64_t dq = tc::sw128_desc(q_s);
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int k0 = kr.k_lo; k0 < kr.k_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < kr.k_hi) load_kv(k0 + BK, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, the first time, q) has landed
    tc::fence_proxy_async();
    __syncthreads();
    const int kh = k0 + HK * grp;  // this warpgroup's first key
    if (kh < kr.k_hi) {            // else every key of its half is masked
      const uint64_t dk = tc::sw128_desc(k_s + (stage * BK + HK * grp) * 128);
      const uint64_t dv = tc::sw128_desc(v_s + (stage * BK + HK * grp) * 128);

      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)  // 16 head dims (32 bytes of a swizzled row) a step
        tc::wgmma_ss(s, dq + 2 * kd, dk + 2 * kd, kd);
      tc::wgmma_commit();
      tc::wgmma_wait0();

      const bool edge = kh + HK > kr.k_valid ||
                        (p.causal && kh + HK - 1 > q0 && kh + HK > p.prefix_len) ||
                        (p.window > 0 && kh <= kr.q_last - p.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (edge && !visible(p, kr.k_valid, row0 + (e >> 1) * 8, kh + 8 * n + 2 * t + (e & 1)))
            x = NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_ftz(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      uint32_t a[HK / 16][4];
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) tc::pack_a(a[kk], s[2 * kk], s[2 * kk + 1]);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk)  // 16 keys (rows of V) a step
        tc::wgmma_rs_tb(o, a[kk], dv + (16 * 128 >> 4) * kk);
      tc::wgmma_commit();
      tc::wgmma_wait0();
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  constexpr int VALS = 4 * ND + 4;
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(q_s) + wr * VALS * 32 + lane;
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 32] = o[n][e];
    red[(4 * ND) * 32] = m[0];
    red[(4 * ND + 1) * 32] = m[1];
    red[(4 * ND + 2) * 32] = l[0];
    red[(4 * ND + 3) * 32] = l[1];
  }
  __syncthreads();
  if (grp == 1) return;
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = red[(4 * ND + i) * 32], l1 = red[(4 * ND + 2 + i) * 32];
    const float mm = fmaxf(m[i], m1);
    a0[i] = exp2_ftz(m[i] - mm);
    a1[i] = exp2_ftz(m1 - mm);
    const float lsum = fmaxf(l[i] * a0[i] + l1 * a1[i], 1e-30f);
    inv[i] = 1.f / lsum;
    // the row statistics for the backward, natural log: (m + log2 l) ln 2
    const int qi = row0 + 8 * i;
    if (p.lse != nullptr && t == 0 && qi < p.Sq)
      p.lse[(long long)bh * p.Sq + qi] = (mm + log2f(lsum)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = (o[n][2 * i] * a0[i] + red[(4 * n + 2 * i) * 32] * a1[i]) * inv[i];
      const float x1 = (o[n][2 * i + 1] * a0[i] + red[(4 * n + 2 * i + 1) * 32] * a1[i]) * inv[i];
      *reinterpret_cast<uint32_t*>(og + qi * p.o_ss + 8 * n + 2 * t) = tc::pack_bf16(x0, x1);
    }
  }
}

// bf16 at the wide pairs, 192/128 and 256/256 (flash_fwd_wide): three
// warpgroups, each tile stored as 64-column slabs in the 128-byte swizzle
// (tensor_core.cuh). Warpgroup 0 gives its registers up and one of its
// threads copies Q and every 64-key K/V tile by TMA (the copy writes the
// swizzle) into an NST-stage ring, each stage's arrival counted on an
// mbarrier. Warpgroups 1 and 2 own q rows 0 .. 63 and 64 .. 127 of the
// CTA's 128; each waits for a stage, computes S = Q K^T as a chain of
// m64n64k16 over the depth's slabs (K K-major; Q from registers at 192,
// from its slab tile at 256), the softmax, and O += P V one m64n128k16 a
// k-step per two slabs of V (MN-major) with P from registers, then
// releases the stage on a second mbarrier. No CTA-wide barrier after the
// start: the consumers run apart.
template <int DQK, int DV>
struct Wide {
  static constexpr int KS = DQK / 64, VS = DV / 64;
  static constexpr int TQ = KS * tc::SLAB_BYTES, TV = VS * tc::SLAB_BYTES;
  static constexpr int ROWS = 2 * BQ;
  // as many stages as fit the 227 KiB a CTA may opt in to, up to four
  static constexpr int FIT = (232448 - 2048 - 2 * TQ) / (TQ + TV);
  static constexpr int NST = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 2 * TQ + NST * (TQ + TV) + 2048;  // alignment slack and barriers
  static constexpr bool Q_REGS = DQK <= 192;
  static_assert(NST >= 2, "two ring stages at least");
};

// the tensor maps of q, k and v, and each one's coordinate slot of S,
// heads and B (its dims past D in order of their strides)
struct alignas(64) WideMaps {
  CUtensorMap q, k, v;
  int q_pos[3], k_pos[3], v_pos[3];
};

__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap& map, const int* pos, int col,
                                        int row, int head, int batch, uint64_t* bar) {
  int c[4];
  c[0] = col;
  c[pos[0]] = row;
  c[pos[1]] = head;
  c[pos[2]] = batch;
  tc::tma_load_4d(dst, &map, c[0], c[1], c[2], c[3], bar);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_fwd_wide(const __grid_constant__ WideMaps maps, Params p) {
  using bf16 = __nv_bfloat16;
  using W = Wide<DQK, DV>;
  constexpr int NST = W::NST, KS = W::KS, VS = W::VS, TQ = W::TQ, TV = W::TV;
  constexpr bool QR = W::Q_REGS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + 2 * TQ;  // [stage]
  unsigned char* v_s = k_s + NST * TQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + NST * TV);
  uint64_t* q_full = bars;           // Q has landed
  uint64_t* full = bars + 1;         // [stage]: its K and V tile has landed
  uint64_t* empty = bars + 1 + NST;  // [stage]: both consumers are done with it

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0c = (gridDim.y - 1 - blockIdx.y) * W::ROWS;  // last rows first
  const KeyRange kr(p, q0c, 64, W::ROWS);
  const int n = kr.k_lo < kr.k_hi ? (kr.k_hi - kr.k_lo + 63) / 64 : 0;  // key tiles

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, 256);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    tc::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tc::mbar_expect_tx(q_full, 2 * TQ);
      for (int w = 0; w < 2; ++w)
        for (int i = 0; i < KS; ++i)
          tma_box(q_s + w * TQ + i * tc::SLAB_BYTES, maps.q, maps.q_pos, 64 * i, q0c + BQ * w, h,
                  b, q_full);
      for (int j = 0; j < n; ++j) {
        const int s = j % NST, k0 = kr.k_lo + 64 * j;
        if (j >= NST) tc::mbar_wait(empty + s, (j / NST - 1) & 1);
        tc::mbar_expect_tx(full + s, TQ + TV);
        for (int i = 0; i < KS; ++i)
          tma_box(k_s + s * TQ + i * tc::SLAB_BYTES, maps.k, maps.k_pos, 64 * i, k0, kvh, b,
                  full + s);
        for (int i = 0; i < VS; ++i)
          tma_box(v_s + s * TV + i * tc::SLAB_BYTES, maps.v, maps.v_pos, 64 * i, k0, kvh, b,
                  full + s);
      }
    }
    return;
  }
  tc::setmaxnreg_inc<240>();

  const int c = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0 = q0c + BQ * c;  // this warpgroup's rows
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int q_last = min(q0 + BQ, p.Sq) - 1;  // below q0 when these rows lie past Sq
  const float sl2 = p.scale * 1.4426950408889634f;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const unsigned char* qs = q_s + c * TQ;
  float o[VS][8][4];
#pragma unroll
  for (int i = 0; i < VS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j][0] = o[i][j][1] = o[i][j][2] = o[i][j][3] = 0.f;
  float(&of)[8 * VS][4] = reinterpret_cast<float(&)[8 * VS][4]>(o);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[QR ? 4 * KS : 1][4];

  tc::mbar_wait(q_full, 0);
  if constexpr (QR) {
    const int r = 16 * warp + tc::x_row(lane);
#pragma unroll
    for (int kd = 0; kd < 4 * KS; ++kd)
      tc::ldsm_x4(qf[kd],
                  qs + (kd >> 2) * tc::SLAB_BYTES + tc::swz128(r, 2 * (kd & 3) + (lane >> 4)));
  }
  // whether these rows see a key of the 64 from kh: rows past Sq, keys
  // after the last row (past the prefix span) or before the first row's
  // window are skipped
  auto sees = [&](int kh) {
    return q0 < p.Sq && !(p.causal && kh > q_last && kh >= p.prefix_len) &&
           !(p.window > 0 && kh + 63 <= q0 - p.window);
  };
  // S = Q K^T over the tile's 64 keys: this warp's 16 rows; issued
  auto s_issue = [&](float (&S)[8][4], const unsigned char* ks) {
    if constexpr (QR) {
#pragma unroll
      for (int kd = 0; kd < 4 * KS; ++kd)
        tc::wgmma_rs(S, qf[kd], tc::sw128_desc(ks + (kd >> 2) * tc::SLAB_BYTES) + 2 * (kd & 3),
                     kd);
    } else {
      tc::wg_abt_issue<KS>(S, qs, ks);
    }
  };
  // the online softmax of the tile from kh: S becomes P in f32, the rows'
  // max and sum move, alpha the output's rescale factors. An edge tile (at
  // the diagonal past the prefix span, the window's edge or the valid
  // length) scales and masks each score, a masked one to -1e30 after the
  // scale as in the plain version; elsewhere the scale (> 0) goes to the
  // max and into the exponent. Row maxima and sums are trees.
  auto probs = [&](float (&S)[8][4], int kh, float (&alpha)[2]) {
    const bool edge = kh + 64 > kr.k_valid ||
                      (p.causal && kh + 63 > q0 && kh + 64 > p.prefix_len) ||
                      (p.window > 0 && kh <= q_last - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[i][e] = visible(p, kr.k_valid, row0 + (e >> 1) * 8, kh + 8 * i + 2 * t + (e & 1))
                        ? S[i][e] * sl2
                        : NEG_INF;
    }
    const float sc = edge ? 1.f : sl2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // row r: elements 2 r and 2 r + 1 of each n-tile
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaxf(S[i][2 * r], S[i][2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
      float mx = v[0] * sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // a row's 4 lanes are one quad
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        S[i][2 * r] = exp2_ftz(fmaf(S[i][2 * r], sc, -m_new));
        S[i][2 * r + 1] = exp2_ftz(fmaf(S[i][2 * r + 1], sc, -m_new));
        v[i] = S[i][2 * r] + S[i][2 * r + 1];
      }
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) v[i] += v[i + w];
      l[r] = l[r] * alpha[r] + v[0];  // this lane's share of the row sum; quads add up at the end
    }
  };
  // O rescaled, and P rounded to bf16 as the A operands of P V
  auto rescale_pack = [&](const float (&alpha)[2], const float (&S)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 8 * VS; ++i) {
      of[i][0] *= alpha[0];
      of[i][1] *= alpha[0];
      of[i][2] *= alpha[1];
      of[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::pack_a(a[kk], S[2 * kk], S[2 * kk + 1]);
  };
  // O += P V over the tile's 64 keys: one m64n128k16 a k-step for each
  // two slabs of V (at 256 two of them: an m64n256 beside the 128 output
  // accumulators spilled in K1-bwd's dQ); issued
  auto pv_issue = [&](const uint32_t (&a)[4][4], const unsigned char* vs) {
#pragma unroll
    for (int g = 0; g < VS; g += 2) {
      float(&d)[16][4] = reinterpret_cast<float(&)[16][4]>(o[g]);
      const uint64_t dv = tc::sw128_desc_slabs(vs + g * tc::SLAB_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys (rows of V) a step
        tc::wgmma_rs_tb_n<128>(d, a[kk], dv + (16 * 128 >> 4) * kk);
    }
  };

  float S[8][4], alpha[2];
  uint32_t a[4][4];
  for (int j = 0; j < n; ++j) {
    const int st = j % NST, kh = kr.k_lo + 64 * j;
    tc::mbar_wait(full + st, (j / NST) & 1);
    if (sees(kh)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) S[i][0] = S[i][1] = S[i][2] = S[i][3] = 0.f;
      tc::wgmma_fence();
      s_issue(S, k_s + st * TQ);
      tc::wgmma_commit();
      tc::wgmma_wait0();
      tc::fence_regs(S);
      probs(S, kh, alpha);
      rescale_pack(alpha, S, a);
      tc::wgmma_fence();
      pv_issue(a, v_s + st * TV);
      tc::wgmma_commit();
      tc::wgmma_wait0();
      tc::fence_regs(of);
    }
    tc::mbar_arrive(empty + st);  // this warpgroup is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lsum = fmaxf(l[r], 1e-30f), inv = 1.f / lsum;
    const int qi = row0 + 8 * r;
    if (qi >= p.Sq) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[(long long)bh * p.Sq + qi] = (m[r] + log2f(lsum)) * 0.6931471805599453f;
#pragma unroll
    for (int i = 0; i < 8 * VS; ++i)
      *reinterpret_cast<uint32_t*>(og + qi * p.o_ss + 8 * i + 2 * t) =
          tc::pack_bf16(of[i][2 * r] * inv, of[i][2 * r + 1] * inv);
  }
}

// -- f32: FMA tiles -----------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int DQK, int DV>
constexpr int f32_smem_bytes() {
  // q and k tiles padded to DQK + 1 (conflict-free column walks), v tile,
  // p tile padded to BK + 4 (the two row groups of a warp hit disjoint banks)
  return (BQ * (DQK + 1) + BK * (DQK + 1) + BK * DV + BQ * (BK + 4)) * 4;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32(Params p) {
  constexpr int QS = DQK + 1;
  constexpr int PS = BK + 4;
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = v_s + BK * DV;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16 j, output columns tx + 16 j
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * BQ;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * DQK; i += F32_THREADS) {
    const int r = i / DQK, d = i % DQK, qi = q0 + r;
    q_s[r * QS + d] = qi < p.Sq ? qg[qi * p.q_ss + d] * p.scale : 0.f;
  }
  const KeyRange kr(p, q0, BK);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kr.k_lo; k0 < kr.k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q_s is in)
    for (int i = tid; i < BK * DQK; i += F32_THREADS) {
      const int r = i / DQK, d = i % DQK, kj = k0 + r;
      k_s[r * QS + d] = kj < p.Sk ? kg[kj * p.k_ss + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += F32_THREADS) {
      const int r = i / DV, d = i % DV, kj = k0 + r;
      v_s[r * DV + d] = kj < p.Sk ? vg[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax update; a row's 16 threads are one
    // half-warp, so xor-shuffles over offsets 8..1 reduce a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(p, kr.k_valid, qi, k0 + tx + 16 * j)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(4 * ty + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = v_s[kk * DV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) og[qi * p.o_ss + tx + 16 * c] = acc[i][c] / denom;
    if (p.lse != nullptr && tx == 0) p.lse[(long long)bh * p.Sq + qi] = m[i] + logf(denom);
  }
}

// -- launch ---------------------------------------------------------------------

// the opt-in above 48 KiB belongs to the function on one device: set it once
// per (instantiation, device); a racing second setter is harmless
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, int device, std::atomic<bool>* done) {
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the CUDA
// runtime: the library links the runtime only
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a bf16 (B, S, heads, D) view, D contiguous, as a 4-d tensor map of boxes
// of 64 columns by 64 rows of S in the 128-byte swizzle: D first, then S,
// heads and B in order of their strides (a dim of size 1 takes stride 16,
// as any reads the same); pos gets the coordinate slot of S, heads and B
bool make_map(CUtensorMap* map, int* pos, const void* base, int D, int S, int heads, int B,
              long long ss, long long sh, long long sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long sizes[3] = {S, heads, B};
  long long strides[3] = {ss * 2, sh * 2, sb * 2};  // bytes
  for (int i = 0; i < 3; ++i)
    if (sizes[i] == 1) strides[i] = 16;
  int order[3] = {0, 1, 2};
  std::sort(order, order + 3, [&](int x, int y) { return strides[x] < strides[y]; });
  cuuint64_t dims[4] = {(cuuint64_t)D, 1, 1, 1}, gstrides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estrides[4] = {1, 1, 1, 1};
  for (int slot = 0; slot < 3; ++slot) {
    const int d = order[slot];
    dims[slot + 1] = (cuuint64_t)sizes[d];
    gstrides[slot] = (cuuint64_t)strides[d];
    pos[d] = slot + 1;
    if (d == 0) box[slot + 1] = 64;  // 64 rows of S
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, gstrides,
                box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
cudaError_t launch_wide(const Params& p, int device, std::atomic<bool>* done,
                        cudaStream_t stream) {
  using W = Wide<DQK, DV>;
  const int q_rows = (p.Sq + W::ROWS - 1) / W::ROWS;
  if (q_rows > 65535) return cudaErrorInvalidValue;
  WideMaps maps;
  if (!make_map(&maps.q, maps.q_pos, p.q, DQK, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb) ||
      !make_map(&maps.k, maps.k_pos, p.k, DQK, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb) ||
      !make_map(&maps.v, maps.v_pos, p.v, DV, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb))
    return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(flash_fwd_wide<DQK, DV>, W::SMEM, device, done);
  if (err != cudaSuccess) return err;
  flash_fwd_wide<DQK, DV><<<dim3(p.B * p.H, q_rows), 3 * 128, W::SMEM, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int DQK, int DV>
cudaError_t launch(const Params& p, bool bf16, int device, cudaStream_t stream) {
  static std::atomic<bool> set_bf16[MAX_DEVICES], set_f32[MAX_DEVICES];
  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  if (!bf16) {
    constexpr int smem = f32_smem_bytes<DQK, DV>();
    cudaError_t err = opt_in_smem(flash_fwd_f32<DQK, DV>, smem, device, set_f32);
    if (err != cudaSuccess) return err;
    flash_fwd_f32<DQK, DV><<<dim3(q_tiles, p.B * p.H), F32_THREADS, smem, stream>>>(p);
  } else if constexpr ((DQK == 128 && DV == 128) || (DQK == 192 && DV == 128) ||
                       (DQK == 256 && DV == 256)) {
    return launch_wide<DQK, DV>(p, device, set_bf16, stream);
  } else {
    if (q_tiles > 65535) return cudaErrorInvalidValue;
    if constexpr (DQK == 64 && DV == 64) {
      cudaError_t err = opt_in_smem(flash_fwd_wgmma, WG_SMEM, device, set_bf16);
      if (err != cudaSuccess) return err;
      flash_fwd_wgmma<<<dim3(p.B * p.H, q_tiles), MMA_THREADS, WG_SMEM, stream>>>(p);
    } else {
      constexpr int smem = mma_smem_bytes<DQK, DV>();
      cudaError_t err = opt_in_smem(flash_fwd_mma<DQK, DV>, smem, device, set_bf16);
      if (err != cudaSuccess) return err;
      flash_fwd_mma<DQK, DV><<<dim3(p.B * p.H, q_tiles), MMA_THREADS, smem, stream>>>(p);
    }
  }
  return cudaGetLastError();
}

// makes `device` the calling thread's current device for the scope's life
// and then restores the one that was current
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev) cudaSetDevice(prev);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Dh is the q and k head dim, Dv the v
// and o head dim; (Dh, Dv) is one of (32, 32), (64, 64), (128, 128),
// (192, 128) and (256, 256). Strides are in elements; the last (head) dim
// must be contiguous, and for bfloat16 the base pointers and the other
// strides must be 16-byte aligned (the wrapper checks). With `causal`, keys
// at positions below `prefix_len` (0: none) are visible to every query, the
// prefix-LM mask; the window and `k_len` still apply. `device` is the
// ordinal the tensors live on and `stream` one of its streams; the launch
// makes it the thread's current device of the CUDA runtime this library is
// linked against (with -cudart shared, PyTorch's) and then restores the
// previous one. `lse`, if not null, receives each row's f32 statistics
// m + log(max(l, 1e-30)) in natural-log units, laid out (B, H, Sq)
// contiguous, for the backward (flash_attention_bwd.cu); serving passes
// null. Returns the launch's cudaError_t (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int device,
    int B, int H, int KV, int Sq, int Sk, int Dh, int Dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int k_len, int prefix_len, float scale, float* lse, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  Params p{q, k, v, o, B, H, KV, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           causal, window, k_len, prefix_len, scale, lse};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  if (Dh == 32 && Dv == 32) return (int)launch<32, 32>(p, bf16, device, st);
  if (Dh == 64 && Dv == 64) return (int)launch<64, 64>(p, bf16, device, st);
  if (Dh == 128 && Dv == 128) return (int)launch<128, 128>(p, bf16, device, st);
  if (Dh == 192 && Dv == 128) return (int)launch<192, 128>(p, bf16, device, st);
  if (Dh == 256 && Dv == 256) return (int)launch<256, 256>(p, bf16, device, st);
  return (int)cudaErrorInvalidValue;
}
