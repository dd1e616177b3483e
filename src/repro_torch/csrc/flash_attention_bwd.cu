// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// What it replaces: the reference's Pallas kernel
// (`src/repro/kernels/flash_attention.py:_kernel`) has no VJP, so the JAX
// package trains through XLA's autodiff of the dense einsum `_attend_dense`
// (`src/repro/models/attention.py:58`). This computes the same gradients
// from the forward's output O and row statistics lse = m + log(l)
// (csrc/flash_attention.cu), without the (Sq, Sk) probabilities ever
// reaching device memory:
//   P  = exp(S * scale - lse)      S = Q K^T, masked entries 0
//   D  = rowsum(dO o O)            (preprocess launch, f32)
//   dV = P^T dO                    summed over the G q-heads of a kv-head
//   dP = dO V^T,  dS = P o (dP - D)
//   dK = dS^T Q * scale            summed over the G q-heads
//   dQ = dS K * scale
// with the forward's masks (causal top-left aligned from position 0, with
// keys below prefix_len visible to every query, the prefix-LM span;
// sliding window k > q - window, valid length k < k_len), GQA q-head h
// reading kv-head h / (H / KV), ragged Sq and Sk, inputs and outputs
// addressed through strides, so the model's (B, S, H, Dh) views need no
// copy. A row that sees no key gets zero gradient.
//
// Three launches (four in bf16 at the wide pairs with a head split),
// no float atomics, so the result is the same bit for bit from run to run:
//  - bwd_preprocess: D, one warp per row.
//  - bwd_dkdv: one CTA per (batch * kv-head, key tile), heaviest causal
//    tiles (the first) dispatched first. It keeps its K and V tile in
//    shared memory and dK, dV in registers, walks the G q-heads of its
//    group and, for each, the q tiles the mask lets see its keys,
//    recomputing P and dS per tile, and writes dK and dV once.
//  - bwd_dq: one CTA per (batch * q-head, 64-row q tile), heaviest first,
//    walking the key tiles its rows see, and writes dQ once.
//  - bwd_dkdv_reduce (bf16 wide pairs with n_split > 1 only): the f32 dK
//    and dV partials of a group's q-head subsets summed in split order.
// A per-key-tile dQ partial (the usual way to avoid atomics) would take
// about 2 GB at the training shape; recomputing P and dS in bwd_dq costs
// two of its products instead.
//
// What bounds it on this card: at tinyllama's training shapes (B=4, H=32,
// KV=4, Dh=64, S=2048, causal) the work is 2.5x the forward's FLOPs against
// q, k, v, o, dO and lse read and dq, dk, dv written once, so it is bounded
// by tensor-core operations by a wide margin.
//
// bf16 (the trained path): every product on the tensor cores with bf16
// operands and f32 sums; operands stay bf16 in shared memory, filled by
// 16-byte cp.async, the streamed tiles double-buffered, the next loading
// while this one computes.
//  - bwd_dkdv computes S^T = K Q^T and dP^T = V dO^T with the keys as the M
//    dimension, so P^T and dS^T come out in the accumulator layout that is
//    the A operand of dV += P^T dO and dK += dS^T Q: they never leave
//    registers (the layout the forward uses for P V). bwd_dq computes
//    S = Q K^T and dP = dO V^T, then dQ += dS K with dS from registers.
//  - Precision: S and dP are exact products of bf16 inputs. P and dS are
//    f32 in registers; one bf16 rounding of them before their products
//    would cost tens of bf16 ulps in the gradients, so each is split into a
//    bf16 hi part and a bf16 lo part (lo = bf16(x - hi)) and each product
//    that takes P or dS (dV, dK, dQ) is issued twice into the same f32 sum:
//    10 tensor-core products a (q, key) tile pair where the bound counts 5.
//  - Head dims 32 and 64 (bwd_dkdv_mma, bwd_dq_mma): 4 warps (one
//    warpgroup) a CTA, warp w owning rows 16 w .. 16 w + 15 of the CTA's
//    64-row tile (keys in bwd_dkdv, q rows in bwd_dq), 64-row streamed
//    tiles. At 64 (tinyllama's, hymba's, whisper's) wgmma.m64n64k16 from
//    tiles in the 128-byte swizzle: the score products read both operands
//    from shared memory (K-major), the gradient products take P^T, dS^T or
//    dS from registers and dO, Q or K from shared memory (MN-major). At 32
//    mma.sync.m16n8k16 fed by ldmatrix from rows padded by 16 bytes.
//  - The wide pairs, 128/128 (the dense configs': phi4-mini, qwen1.5),
//    256/256 (gemma's, in paligemma: MQA, a prefix-LM span) and 192/128
//    (deepseek-v2's expanded MLA: Q, K, dQ, dK 192 wide, V, O, dO, dV 128;
//    S^T runs 192 deep, dP^T 128): one warpgroup cannot hold a key tile's
//    dK and dV beside the score fragments (128 f32 registers a thread at
//    128/128, 160 at 192/128, 256 at 256/256), so bwd_dkdv_wg2 gives
//    each 64-key tile two warpgroups on wgmma. Warpgroup 0 computes S^T =
//    K Q^T once, forms P^T, writes it to shared memory (32 f32 a thread, in
//    the fragment layout the other warpgroup's thread of the same rank
//    holds, so the exchange is one conflict-free store and load each) and
//    accumulates dV += P^T dO (64 or 128 f32 a thread); warpgroup 1
//    computes dP^T = V dO^T, takes P^T across a named barrier, forms dS^T
//    and accumulates dK += dS^T Q (64, 96 or 128). Six products a tile pair
//    (S^T, dP^T, dV and dK twice), where the earlier dV and dK passes
//    issued S^T twice. Every tile is 64 rows, stored as 64-column slabs of
//    8 KiB in the 128-byte swizzle. The score products are chains of
//    m64n64k16 whose K-major operands step slab by slab over the depth;
//    each gradient product is one m64nNk16 a k-step over all of its
//    MN-major operand's slabs (N = Dv or Dqk: 128, 192 or 256; dQ at 256
//    two of N = 128, as one of 256 spills), the slabs one descriptor's
//    leading byte offset apart. Shared memory: K, V, two
//    stages of Q, dO and their lse and D, the exchange (215 040 bytes at
//    256/256, 141 312 at 192/128, 115 712 at 128/128); no instantiation
//    spills.
//  - Head split: with MQA or few heads, B * KV * key tiles CTAs leave most
//    of the card idle (paligemma's training shape: 4 * 1 * 8 = 32 on 132
//    SMs), so a group's G q-heads are split over n_split CTAs (the wrapper's
//    bwd_head_split: the largest divisor of G that keeps the grid within
//    the SM count; 4 there, 1 at deepseek-v2's 128 * 32 CTAs and at the
//    dense configs' 2048 or more). A split CTA writes f32 partials to a
//    scratch the wrapper allocates, and bwd_dkdv_reduce sums them in split
//    order: no atomics, fixed bits.
//  - bwd_dq_wg: dQ on wgmma over Dqk / 64 slabs of accumulators (64, 96 or
//    128 f32 a thread), one warpgroup per 64 q rows; at 128/128 and 192/128
//    two warpgroups (128 q rows) share a CTA's K/V ring, at 256/256 the
//    tiles leave room for one (197 632 bytes). A warpgroup skips the key
//    tiles none of its rows sees.
//  - Design choices the card settled, in trials at deepseek-v2's shape:
//    the two dK/dV warpgroups run in lockstep, one CTA-wide barrier
//    opening each ring stage; letting them run an iteration apart
//    (parity-alternating named barriers, a second exchange buffer, the
//    ring filled by warpgroup 0 alone) read slower. Dispatching a group's
//    key tiles together (for L2 reuse of Q and dO) read slower than the
//    groups first; a third ring stage, issuing the next stage's copies
//    behind the score products and splitting a score product into two
//    accumulator chains did not help, nor, in a trial left unfinished
//    (its dK and dV still wrong), 128-row q tiles at 192/128 (K held in
//    registers, m64n128 score products, half the barriers a q row). One
//    wide-N product per k-step in place of one m64n64k16 per slab did. No producer warp: a cp.async producer warp would issue
//    2 560 16-byte copies a tile pair at 192/128, where both warpgroups'
//    copies take 10 a thread; TMA needs tensor maps over the strided
//    views, built on the host each launch.
// What bounds it (deepseek-v2's training shape, B=1 H=KV=128 S=2048 causal,
// on an H100 SXM at 700 W): the bound is 4.47e11 FLOP of tensor-core work,
// 0.452 ms; the hi + lo split issues twice that, 0.904 ms at peak. The
// kernels read about 2.7 ms (PERF.md), a third of peak on the work they
// issue; SDPA's backward, which rounds P and dS once, reads 1.22 ms. What
// holds it back next is not settled: taking products out shortens the
// dK/dV launch far less than their share of its tensor-core work, yet
// halving the tile pairs (and with them the barriers and waits) did not
// shorten the unfinished trial either. Without stall counters (no profiler here reads
// them) the candidates are each warpgroup's wait for its products before
// its softmax, with nothing of its own to overlap them, and the shared
// memory the m64n64 score products read; a TMA producer with mbarriers
// and a second score fragment in flight a warpgroup are the next trials.
//
// At 128/128 (one chip call, in turns with the replaced mma.sync form, whose
// streamed tiles held 32 rows so a warp's dK and dV fitted beside its
// score fragments; device ms at phi4-mini's B=4 H=48 KV=16 S=2048 causal /
// qwen1.5's H=KV=32, H100 80GB HBM3 at 700 W): this form 3.588 / 2.474
// (dK/dV 2.319 / 1.597, dQ 1.259 / 0.823), six runs within 1 %;
// mma.sync 3.681 / 2.502 (dK/dV 2.225 / 1.505, dQ 1.432 / 0.941) and
// 3.681 / 2.502; SDPA's backward, which rounds P and dS once, 1.349 /
// 0.861. The gain is dQ's (wgmma over 128 q rows a CTA); the dK/dV launch
// reads 4-6 % slower than mma.sync's, at 27 % of peak on the products it
// issues (S^T, dP^T, dV and dK twice: 6.2e11 FLOP at phi4-mini's shape):
// the two warpgroups' products are a third smaller than at 192/128 while
// the exchange, barriers and waits a tile pair stay.
//
// f32 (the parity path; bwd_dkdv, bwd_dq): FMA tiles on the FP32 pipes, as
// the forward's f32 form: the tensor cores take no f32 operand that holds a
// 1e-4 tolerance. Each thread owns a 4 x 4 micro-tile of the 64 x 64 score
// tile and 4 rows x Dh/16 columns of its gradient tile, operands in padded
// f32 shared-memory tiles. At Dh = 256 the key tiles hold 32 keys (a 4 x 2
// micro-tile, 2 keys x 16 columns of dK and dV a thread): 64-key K and V
// tiles beside the 64-row Q and dO tiles would take 298 496 bytes of
// shared memory, over the 232 448 a CTA may opt in to, and 128 dK and dV
// registers a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* lse;  // (B, H, Sq) contiguous
  float* delta;      // (B, H, Sq) contiguous scratch: D
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal;
  int window;  // <= 0: no window
  int k_len;   // keys at positions >= k_len are masked
  int prefix_len;  // causal: keys at positions < prefix_len are visible to every query
  float scale;
  // bf16 at 192/128 and 256/256: the CTAs a group's q-heads are split over,
  // and with n_split > 1 their f32 dK and dV partials, (n_split, B, KV, Sk,
  // Dqk) then (n_split, B, KV, Sk, Dv)
  int n_split;
  float* dk_part;
  float* dv_part;
};

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ bool visible(const Params& p, int k_valid, int qi, int kj) {
  bool ok = kj < k_valid;
  if (p.causal) ok = ok && (kj <= qi || kj < p.prefix_len);
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// -- D = rowsum(dO o O) ----------------------------------------------------------

template <typename T, int DV>
__global__ void __launch_bounds__(THREADS) bwd_preprocess(Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (THREADS / 32) + warp;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  if (qi >= p.Sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h + qi * p.so.s;
  const T* dO = static_cast<const T*>(p.dO) + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DV; d += 32) acc = fmaf(ld(o + d), ld(dO + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(long long)bh * p.Sq + qi] = acc;
}

// -- f32: FMA tiles ----------------------------------------------------------------

// keys of a key tile: 64, and 32 at head dim 256
template <int DQK, int DV>
__host__ __device__ constexpr int f32_keys() {
  return DQK == 256 || DV == 256 ? 32 : BK;
}
// a score-tile row (the tile's keys + 4): the warp's two row groups hit disjoint banks
template <int DQK, int DV>
__host__ __device__ constexpr int f32_ps() {
  return f32_keys<DQK, DV>() + 4;
}

template <int DQK, int DV>
constexpr int smem_bytes() {
  // q and k tiles (64 and f32_keys rows) padded to DQK + 1, dO and v tiles
  // padded to DV + 1 (conflict-free column walks), the P and dS tiles, and a
  // q tile's lse and D (at 192/128: 200 192 bytes)
  return ((BQ + f32_keys<DQK, DV>()) * (DQK + DV + 2) + 2 * BQ * f32_ps<DQK, DV>() + 2 * BQ) *
         4;
}

// rows [r0, r0 + ROWS) of a (seq, Dh) slice into a padded f32 tile, zeros past n
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r0 + r < n ? src[(long long)(r0 + r) * ss + d] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, key tile) pair, then P and dS
// into shared memory. Thread (ty, tx) owns q rows 4 ty + i, keys tx + 16 j.
// Q and K rows are DQK + 1 floats apart, dO and V rows DV + 1.
template <int DQK, int DV>
__device__ __forceinline__ void scores(const Params& p, int k_valid, int q0, int k0,
                                       const float* q_s, const float* do_s, const float* k_s,
                                       const float* v_s, const float* lse_s, const float* dl_s,
                                       float* p_s, float* ds_s) {
  constexpr int QS = DQK + 1, VS = DV + 1, KJ = f32_keys<DQK, DV>() / 16;
  constexpr int PS = f32_ps<DQK, DV>();
  // at 256 the caller's 64 dQ (or dK and dV) registers stay live: a
  // shallower unroll keeps the loads in flight within 128 registers
  constexpr int UNROLL = DQK == 256 ? 2 : 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][KJ], dp[4][KJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (DQK == DV) {  // one walk over the head dim feeds both products
#pragma unroll UNROLL
    for (int d = 0; d < DQK; ++d) {
      float qv[4], gv[4], kv[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(4 * ty + i) * QS + d];
        gv[i] = do_s[(4 * ty + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = k_s[(tx + 16 * j) * QS + d];
        vv[j] = v_s[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
  } else {  // S over the DQK dims, dP over the DV dims
#pragma unroll UNROLL
    for (int d = 0; d < DQK; ++d) {
      float qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll UNROLL
    for (int d = 0; d < DV; ++d) {
      float gv[4], vv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = do_s[(4 * ty + i) * VS + d];
#pragma unroll
      for (int j = 0; j < KJ; ++j) vv[j] = v_s[(tx + 16 * j) * VS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = tx + 16 * j;
      float pr = 0.f;
      if (qi < p.Sq && visible(p, k_valid, qi, k0 + c)) pr = __expf(s[i][j] * p.scale - lse_s[r]);
      p_s[r * PS + c] = pr;
      ds_s[r * PS + c] = pr * (dp[i][j] - dl_s[r]);
    }
  }
}

// -- dK, dV ---------------------------------------------------------------------

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Params p) {
  constexpr int QS = DQK + 1, VS = DV + 1;
  constexpr int CK = DQK / 16, CV = DV / 16;  // dK and dV columns per thread
  constexpr int KR = f32_keys<DQK, DV>(), KI = KR / 16, PS = f32_ps<DQK, DV>();  // KI keys per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* k_s = do_s + BQ * VS;
  float* v_s = k_s + KR * QS;
  float* p_s = v_s + KR * VS;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int k0 = blockIdx.y * KR;  // the first key tiles see the most q rows under causality
  const int G = p.H / p.KV;
  const int k_valid = min(p.k_len, p.Sk);

  load_tile<DQK, KR>(k_s, static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h, p.sk.s,
                     k0, p.Sk);
  load_tile<DV, KR>(v_s, static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0,
                    p.Sk);

  // the q rows that can see a key of this tile: causal q >= k0, every q
  // from 0 when the tile starts inside the prefix span; window q < k_last +
  // window; none when the tile lies past the valid length
  int q_lo = p.causal && k0 >= p.prefix_len ? k0 / BQ * BQ : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + KR - 1 + p.window);
  if (k0 >= k_valid) q_hi = 0;

  float dk[KI][CK], dv[KI][CV];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
#pragma unroll
    for (int c = 0; c < CK; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) dv[i][c] = 0.f;
  }

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg, bh = b * p.H + h;
    const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
    const float* dog = static_cast<const float*>(p.dO) + b * p.sdo.b + h * p.sdo.h;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<DQK, BQ>(q_s, qg, p.sq.s, q0, p.Sq);
      load_tile<DV, BQ>(do_s, dog, p.sdo.s, q0, p.Sq);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q0 + r < p.Sq;
        lse_s[r] = in ? p.lse[(long long)bh * p.Sq + q0 + r] : 0.f;
        dl_s[r] = in ? p.delta[(long long)bh * p.Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      scores<DQK, DV>(p, k_valid, q0, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s);
      __syncthreads();
      // dV[key, d] += sum_q P[q, key] dO[q, d];  dK[key, d] += sum_q dS[q, key] Q[q, d]
      // thread (ty, tx) owns keys KI ty + i and columns tx + 16 c
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[KI], sv[KI], gv[CV], qv[CK];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pv[i] = p_s[r * PS + KI * ty + i];
          sv[i] = ds_s[r * PS + KI * ty + i];
        }
#pragma unroll
        for (int c = 0; c < CV; ++c) gv[c] = do_s[r * VS + tx + 16 * c];
#pragma unroll
        for (int c = 0; c < CK; ++c) qv[c] = q_s[r * QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
#pragma unroll
          for (int c = 0; c < CV; ++c) dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
#pragma unroll
          for (int c = 0; c < CK; ++c) dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  float* dvg = static_cast<float*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kj = k0 + KI * ty + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < CK; ++c) dkg[(long long)kj * p.sdk.s + tx + 16 * c] = dk[i][c] * p.scale;
#pragma unroll
    for (int c = 0; c < CV; ++c) dvg[(long long)kj * p.sdv.s + tx + 16 * c] = dv[i][c];
  }
}

// -- dQ -------------------------------------------------------------------------

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS) bwd_dq(Params p) {
  constexpr int QS = DQK + 1, VS = DV + 1;
  constexpr int CK = DQK / 16;
  constexpr int KR = f32_keys<DQK, DV>(), PS = f32_ps<DQK, DV>();
  constexpr int UNROLL = DQK == 256 ? 2 : 4;  // at 256, within 128 registers beside dQ
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* k_s = do_s + BQ * VS;
  float* v_s = k_s + KR * QS;
  float* p_s = v_s + KR * VS;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (heaviest causal) tiles first
  const int k_valid = min(p.k_len, p.Sk);

  load_tile<DQK, BQ>(q_s, static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                     p.Sq);
  load_tile<DV, BQ>(do_s, static_cast<const float*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s,
                    q0, p.Sq);
  for (int r = tid; r < BQ; r += THREADS) {
    const bool in = q0 + r < p.Sq;
    lse_s[r] = in ? p.lse[(long long)bh * p.Sq + q0 + r] : 0.f;
    dl_s[r] = in ? p.delta[(long long)bh * p.Sq + q0 + r] : 0.f;
  }
  // the keys these rows see, as the forward walks them: a causal tile's
  // run to its diagonal or to the end of the prefix span
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(k_valid, max(q_last + 1, p.prefix_len)) : k_valid;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) / KR * KR : 0;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  float dq[4][CK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CK; ++c) dq[i][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += KR) {
    __syncthreads();  // the previous tile's readers are done (and q, dO are in)
    load_tile<DQK, KR>(k_s, kg, p.sk.s, k0, p.Sk);
    load_tile<DV, KR>(v_s, vg, p.sv.s, k0, p.Sk);
    __syncthreads();
    scores<DQK, DV>(p, k_valid, q0, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s);
    __syncthreads();
    // dQ[q, d] += sum_key dS[q, key] K[key, d]; thread owns rows 4 ty + i
#pragma unroll UNROLL
    for (int c0 = 0; c0 < KR; ++c0) {
      float sv[4], kv[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(4 * ty + i) * PS + c0];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = k_s[c0 * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < CK; ++c) dqg[(long long)qi * p.sdq.s + tx + 16 * c] = dq[i][c] * p.scale;
  }
}

// -- bf16: tensor cores ------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps (one warpgroup), each 16 rows of the CTA's tile
constexpr float LOG2E = 1.4426950408889634f;

// A bf16 tile's layout in shared memory. For mma.sync (WG false): rows
// padded by 16 bytes, so each ldmatrix phase reads 8 rows from 8 distinct
// bank groups. For wgmma (WG, Dh = 64 only): 128-byte rows in the 128-byte
// swizzle of tensor_core.cuh, tiles 1 KiB aligned.
template <int DH, bool WG>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return WG ? rows * 128 : rows * (DH + 8) * 2;
}
// the byte offset of 16-byte piece pc of row r
template <int DH, bool WG>
__device__ __forceinline__ int piece_at(int r, int pc) {
  if constexpr (WG) {
    return tc::swz128(r, pc);
  } else {
    return r * (DH + 8) * 2 + pc * 16;
  }
}
// element (r, c) of a padded tile, for ldmatrix
template <int DH>
__device__ __forceinline__ const __nv_bfloat16* at(const unsigned char* tile, int r, int c) {
  return reinterpret_cast<const __nv_bfloat16*>(tile) + r * (DH + 8) + c;
}

// the fixed 64-row tiles and two stages of the two streamed 64-row tiles,
// one of each pair DQK wide (Q, K) and one DV wide (dO, V); bwd_dkdv adds
// two stages of the streamed q rows' lse and D, and the swizzled layout 1
// KiB of alignment slack
template <int DQK, int DV, bool WG>
constexpr int tc_smem_bytes(bool stats) {
  return 3 * tile_bytes<DQK, WG>(64) + 3 * tile_bytes<DV, WG>(64) + (stats ? 4 * 64 * 4 : 0) +
         (WG ? 1024 : 0);
}

template <bool WG>
__device__ __forceinline__ unsigned char* tiles_base(unsigned char* smem) {
  if constexpr (WG) {  // the swizzle is a function of the address
    return smem + ((1024 - (tc::smem_u32(smem) & 1023)) & 1023);
  } else {
    return smem;
  }
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + n) of a (seq, Dh) slice into a tile by 16-byte copies,
// zeros from row `len` of the slice on
template <int DH, bool WG>
__device__ __forceinline__ void cp_rows(unsigned char* dst, const __nv_bfloat16* src,
                                        long long ss, int r0, int n, int len) {
  constexpr int CH = DH / 8;
  for (int c = threadIdx.x; c < n * CH; c += MMA_THREADS) {
    const int r = c / CH, pc = c % CH, i = r0 + r;
    tc::cp_async16(dst + piece_at<DH, WG>(r, pc), src + (long long)min(i, len - 1) * ss + 8 * pc,
                   i < len);
  }
}

// X = Y Z^T for one warp's 16 rows of Y (rows y0.. of tile y) against the
// n rows of tile z, both padded (mma.sync); acc zeroed first
template <int DH, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const unsigned char* y, int y0,
                                        const unsigned char* z, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    uint32_t a[4];
    tc::ldsm_x4(a, at<DH>(y, y0 + tc::x_row(lane), 16 * kd + tc::x_col(lane)));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t r[4];
      tc::ldsm_x4(r, at<DH>(z, 16 * np + tc::y_row(lane), 16 * kd + tc::y_col(lane)));
      tc::mma(acc[2 * np], a, r[0], r[1]);
      tc::mma(acc[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// acc += X Z over the m rows of padded tile z, X (16 x m) an f32 fragment
// split into hi + lo A operands (mma.sync)
template <int DH, int M>
__device__ __forceinline__ void mma_split_ab(float (&acc)[DH / 8][4], const float (&x)[M / 8][4],
                                             const unsigned char* z, int lane) {
#pragma unroll
  for (int kk = 0; kk < M / 16; ++kk) {
    uint32_t hi[4], lo[4];
    tc::pack_a_split(hi, lo, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dn = 0; dn < DH / 16; ++dn) {
      uint32_t r[4];
      tc::ldsm_x4_trans(r, at<DH>(z, 16 * kk + tc::x_row(lane), 16 * dn + tc::x_col(lane)));
      tc::mma(acc[2 * dn], hi, r[0], r[1]);
      tc::mma(acc[2 * dn], lo, r[0], r[1]);
      tc::mma(acc[2 * dn + 1], hi, r[2], r[3]);
      tc::mma(acc[2 * dn + 1], lo, r[2], r[3]);
    }
  }
}

// The products of the wgmma form (Dh = 64, 64 x 64 tiles over the
// warpgroup).

// x = Y Z^T and x2 = Y2 Z2^T, one group: all four tiles K-major in shared memory
__device__ __forceinline__ void wgmma_abt2(float (&x)[8][4], uint64_t y, uint64_t z,
                                           float (&x2)[8][4], uint64_t y2, uint64_t z2) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = x2[n][e] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < 4; ++kd)  // 16 head dims (32 bytes of a swizzled row) a step
    tc::wgmma_ss(x, y + 2 * kd, z + 2 * kd, kd);
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) tc::wgmma_ss(x2, y2 + 2 * kd, z2 + 2 * kd, kd);
  tc::wgmma_commit();
  tc::wgmma_wait0();
}

// acc += X Z: X an f32 fragment as hi + lo register A operands, Z MN-major
// in shared memory
__device__ __forceinline__ void wgmma_split_ab(float (&acc)[8][4], const float (&x)[8][4],
                                               uint64_t z) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) tc::pack_a_split(hi[kk], lo[kk], x[2 * kk], x[2 * kk + 1]);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 rows of Z a step
    tc::wgmma_rs_tb(acc, hi[kk], z + (16 * 128 >> 4) * kk);
    tc::wgmma_rs_tb(acc, lo[kk], z + (16 * 128 >> 4) * kk);
  }
  tc::wgmma_commit();
  tc::wgmma_wait0();
}

// Q and K rows are DQK wide, dO and V rows DV wide; S^T and dK take the
// DQK dims, dP^T and dV the DV dims
template <int DQK, int DV, bool WG>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dkdv_mma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int QN = BQ;                      // q rows of a streamed tile
  constexpr int NQ = QN / 8;                  // n-tiles of S^T (q columns)
  constexpr int NK = DQK / 8, NV = DV / 8;    // n-tiles of dK and of dV
  constexpr int TK = tile_bytes<DQK, WG>(BK), TV = tile_bytes<DV, WG>(BK);
  constexpr int TQ = tile_bytes<DQK, WG>(QN), TO = tile_bytes<DV, WG>(QN);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = tiles_base<WG>(smem_raw);
  unsigned char* v_s = k_s + TK;
  unsigned char* q_s = v_s + TV;       // [stage]
  unsigned char* do_s = q_s + 2 * TQ;  // [stage]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * TO);  // [stage][QN]
  float* dl_s = lse_s + 2 * QN;                             // [stage][QN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most q rows under causality
  const int G = p.H / p.KV;
  const int k_valid = min(p.k_len, p.Sk);

  cp_rows<DQK, WG>(k_s, static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h, p.sk.s, k0,
                   BK, p.Sk);
  cp_rows<DV, WG>(v_s, static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0,
                  BK, p.Sk);

  // the q rows that can see a key of this tile: causal q >= k0, every q
  // from 0 when the tile starts inside the prefix span; window q < k_last +
  // window; none when the tile lies past the valid length.
  // The CTA walks n_q q tiles for each of the G q-heads, one stream.
  const int q_lo = p.causal && k0 >= p.prefix_len ? k0 / QN * QN : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + BK - 1 + p.window);
  if (k0 >= k_valid) q_hi = 0;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + QN - 1) / QN : 0;
  const int n_it = G * n_q;

  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / n_q, q0 = q_lo + (it % n_q) * QN;
    cp_rows<DQK, WG>(q_s + stage * TQ, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h,
                     p.sq.s, q0, QN, p.Sq);
    cp_rows<DV, WG>(do_s + stage * TO,
                    static_cast<const bf16*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0, QN,
                    p.Sq);
    const long long row = (long long)(b * p.H + h) * p.Sq;
    for (int r = threadIdx.x; r < QN; r += MMA_THREADS) {
      const int qi = q0 + r;
      const long long at_ = row + min(qi, p.Sq - 1);
      tc::cp_async4(lse_s + stage * QN + r, p.lse + at_, qi < p.Sq);
      tc::cp_async4(dl_s + stage * QN + r, p.delta + at_, qi < p.Sq);
    }
  };
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();  // with K and V

  const float sl2 = p.scale * LOG2E;  // P = 2^(S * scale * log2(e) - lse * log2(e))
  const int kr = k0 + 16 * warp + (lane >> 2);  // this lane's keys: kr and kr + 8
  float dk[NK][4], dv[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_q(it + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, the first time, K and V) has landed
    if constexpr (WG) tc::fence_proxy_async();
    __syncthreads();
    const int q0 = q_lo + (it % n_q) * QN;
    const unsigned char* qs = q_s + stage * TQ;
    const unsigned char* ds = do_s + stage * TO;
    const float* ls = lse_s + stage * QN;
    const float* dls = dl_s + stage * QN;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QN q rows
    float s[NQ][4], dp[NQ][4];
    if constexpr (WG) {
      wgmma_abt2(s, tc::sw128_desc(k_s), tc::sw128_desc(qs), dp, tc::sw128_desc(v_s),
                 tc::sw128_desc(ds));
    } else {
      mma_abt<DQK, QN>(s, k_s, 16 * warp, qs, lane);
      mma_abt<DV, QN>(dp, v_s, 16 * warp, ds, lane);
    }

    // P^T and dS^T in place, f32; only tiles at the diagonal (past the
    // prefix span), the window's edge, the valid length or the ragged q end
    // evaluate the mask
    const bool edge = (p.causal && q0 < k0 + BK - 1 && k0 + BK > p.prefix_len) ||
                      (p.window > 0 && k0 <= q0 + QN - 1 - p.window) || k0 + BK > k_valid ||
                      q0 + QN > p.Sq;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * n + 2 * t + (e & 1), kj = kr + 8 * (e >> 1);
        float pr = exp2_ftz(s[n][e] * sl2 - ((e & 1) ? l.y : l.x) * LOG2E);
        if (edge && !(qi < p.Sq && visible(p, k_valid, qi, kj))) pr = 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - ((e & 1) ? d.y : d.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as hi + lo A operands
    if constexpr (WG) {
      wgmma_split_ab(dv, s, tc::sw128_desc(ds));
      wgmma_split_ab(dk, dp, tc::sw128_desc(qs));
    } else {
      mma_split_ab<DV, QN>(dv, s, ds, lane);
      mma_split_ab<DQK, QN>(dk, dp, qs, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  tc::cp_async_wait<0>();  // with no q tile at all, K and V may still be in flight

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr + 8 * i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<uint32_t*>(dkg + kj * p.sdk.s + 8 * n + 2 * t) =
          tc::pack_bf16(dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<uint32_t*>(dvg + kj * p.sdv.s + 8 * n + 2 * t) =
          tc::pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
  }
}

template <int DQK, int DV, bool WG>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dq_mma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int KN = BK;                      // keys of a streamed tile
  constexpr int NK = KN / 8;                  // n-tiles of S (keys)
  constexpr int ND = DQK / 8;                 // n-tiles of dQ
  constexpr int TQ = tile_bytes<DQK, WG>(BQ), TO = tile_bytes<DV, WG>(BQ);
  constexpr int TK = tile_bytes<DQK, WG>(KN), TV = tile_bytes<DV, WG>(KN);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = tiles_base<WG>(smem_raw);
  unsigned char* do_s = q_s + TQ;
  unsigned char* k_s = do_s + TO;     // [stage]
  unsigned char* v_s = k_s + 2 * TK;  // [stage]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (heaviest causal) tiles first
  const int k_valid = min(p.k_len, p.Sk);

  cp_rows<DQK, WG>(q_s, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.s, q0, BQ,
                   p.Sq);
  cp_rows<DV, WG>(do_s, static_cast<const bf16*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                  BQ, p.Sq);
  // the keys these rows see, as the forward walks them: a causal tile's
  // run to its diagonal or to the end of the prefix span
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(k_valid, max(q_last + 1, p.prefix_len)) : k_valid;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) / KN * KN : 0;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  auto load_kv = [&](int kt, int stage) {
    cp_rows<DQK, WG>(k_s + stage * TK, kg, p.sk.s, kt, KN, p.Sk);
    cp_rows<DV, WG>(v_s + stage * TV, vg, p.sv.s, kt, KN, p.Sk);
  };
  if (k_lo < k_hi) load_kv(k_lo, 0);
  tc::cp_async_commit();  // with Q and dO

  // this lane's q rows qr and qr + 8, and their lse (log2 domain) and D
  const int qr = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qr + 8 * i;
    const long long at_ = (long long)bh * p.Sq + min(qi, p.Sq - 1);
    lse2[i] = qi < p.Sq ? p.lse[at_] * LOG2E : 0.f;
    dl[i] = qi < p.Sq ? p.delta[at_] : 0.f;
  }
  const float sl2 = p.scale * LOG2E;
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int stage = 0;
  for (int kt = k_lo; kt < k_hi; kt += KN, stage ^= 1) {
    if (kt + KN < k_hi) load_kv(kt + KN, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and, the first time, Q and dO) has landed
    if constexpr (WG) tc::fence_proxy_async();
    __syncthreads();
    const unsigned char* ks = k_s + stage * TK;
    const unsigned char* vs = v_s + stage * TV;

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x KN keys
    float s[NK][4], dp[NK][4];
    if constexpr (WG) {
      wgmma_abt2(s, tc::sw128_desc(q_s), tc::sw128_desc(ks), dp, tc::sw128_desc(do_s),
                 tc::sw128_desc(vs));
    } else {
      mma_abt<DQK, KN>(s, q_s, 16 * warp, ks, lane);
      mma_abt<DV, KN>(dp, do_s, 16 * warp, vs, lane);
    }

    const bool edge = (p.causal && kt + KN - 1 > q0 && kt + KN > p.prefix_len) ||
                      (p.window > 0 && kt <= q_last - p.window) || kt + KN > k_valid ||
                      q0 + BQ > p.Sq;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = qr + 8 * i, kj = kt + 8 * n + 2 * t + (e & 1);
        float pr = exp2_ftz(s[n][e] * sl2 - lse2[i]);
        if (edge && !(qi < p.Sq && visible(p, k_valid, qi, kj))) pr = 0.f;
        dp[n][e] = pr * (dp[n][e] - dl[i]);
      }

    // dQ += dS K, dS as hi + lo A operands
    if constexpr (WG) {
      wgmma_split_ab(dq, dp, tc::sw128_desc(ks));
    } else {
      mma_split_ab<DQK, KN>(dq, dp, ks, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  tc::cp_async_wait<0>();  // with no key tile at all, Q and dO may still be in flight

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qr + 8 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqg + qi * p.sdq.s + 8 * n + 2 * t) =
          tc::pack_bf16(dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
  }
}

// -- bf16 at 192/128 and 256/256: two warpgroups on wgmma over 64-column slabs ----
//
// Every operand tile has 64 rows and is stored as Dh / 64 slabs of 64 x 64
// bf16 (8 KiB each) in the 128-byte swizzle. A score product is a chain of
// wgmma.m64n64k16 whose K-major operands step 32 bytes a k-step inside a
// slab and move to the next slab after four; a gradient product is one
// m64nNk16 a k-step over all the slabs of its MN-major operand.

using tc::SLAB_BYTES;  // one 64-row slab (tensor_core.cuh)
constexpr int WIDE_DKDV_THREADS = 256;   // warpgroup 0 (S^T, P^T, dV) and 1 (dP^T, dS^T, dK)
// P^T, 32 f32 a thread (the m64n64 fragment), exchanged between the two
// warpgroups' threads of the same rank, which hold the same fragment layout
constexpr int PX_FLOATS = 32 * 128;

template <int D>
__host__ __device__ constexpr int slab_tile_bytes() {
  return D / 64 * SLAB_BYTES;
}

// the K and V tiles, two stages of Q and dO, the P^T exchange, two stages
// of the q rows' lse and D, and 1 KiB of alignment slack (192/128: 141 312
// bytes; 256/256: 215 040)
template <int DQK, int DV>
constexpr int wide_dkdv_smem() {
  return 3 * slab_tile_bytes<DQK>() + 3 * slab_tile_bytes<DV>() + PX_FLOATS * 4 + 4 * 64 * 4 +
         1024;
}
// QW warpgroups' Q and dO tiles and two stages of K and V (192/128 with
// QW = 2: 164 864 bytes; 256/256 with QW = 1: 197 632)
template <int DQK, int DV, int QW>
constexpr int wide_dq_smem() {
  return (QW + 2) * (slab_tile_bytes<DQK>() + slab_tile_bytes<DV>()) + 1024;
}
// q warpgroups of a dQ CTA: two sharing the K/V ring where their tiles fit
// the 232 448 bytes a CTA may opt in to
template <int DQK, int DV>
constexpr int wide_dq_warpgroups() {
  return wide_dq_smem<DQK, DV, 2>() <= 232448 ? 2 : 1;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// acc[n] += X Z[:, 64 n .. 64 n + 63] for the NS slabs of Z's columns, one
// m64n(64 NW)k16 product a k-step, part and NW slabs: X (64 x 64) an f32
// fragment as hi + lo register A operands, Z (64 rows, the product's depth)
// MN-major; waited for
template <int NS, int NW = NS>
__device__ __forceinline__ void wg_split_ab(float (&acc)[NS][8][4], const float (&x)[8][4],
                                            const unsigned char* z) {
  static_assert(NS % NW == 0, "whole products");
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) tc::pack_a_split(hi[kk], lo[kk], x[2 * kk], x[2 * kk + 1]);
  tc::wgmma_fence();
#pragma unroll
  for (int g = 0; g < NS; g += NW) {
    float(&d)[NW * 8][4] = reinterpret_cast<float(&)[NW * 8][4]>(acc[g]);
    const uint64_t dz = tc::sw128_desc_slabs(z + g * SLAB_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 rows of Z a step
      tc::wgmma_rs_tb_n<64 * NW>(d, hi[kk], dz + (16 * 128 >> 4) * kk);
      tc::wgmma_rs_tb_n<64 * NW>(d, lo[kk], dz + (16 * 128 >> 4) * kk);
    }
  }
  tc::wgmma_commit();
  tc::wgmma_wait0();
}

constexpr int ROLE_DV = 0, ROLE_DK = 1;

// One warpgroup's part of a dK/dV CTA. Both walk the same (q-head, q tile)
// stream and fill the ring together. ROLE_DV computes S^T = K Q^T once,
// forms P^T, hands it to ROLE_DK through shared memory and accumulates
// dV += P^T dO; ROLE_DK computes dP^T = V dO^T, takes P^T, forms dS^T =
// P^T o (dP^T - D) and accumulates dK += dS^T Q. Named barrier 1 (all 256
// threads) opens each ring stage, barrier 2 hands P^T over.
template <int DQK, int DV, int ROLE>
__device__ __forceinline__ void dkdv_wide_role(const Params& p, unsigned char* k_s) {
  using bf16 = __nv_bfloat16;
  constexpr int KS = DQK / 64, VS = DV / 64, NT = WIDE_DKDV_THREADS;
  constexpr int TK = slab_tile_bytes<DQK>(), TV = slab_tile_bytes<DV>();
  constexpr int NA = ROLE == ROLE_DV ? VS : KS;  // accumulator slabs
  unsigned char* v_s = k_s + TK;
  unsigned char* q_s = v_s + TV;       // [stage]
  unsigned char* do_s = q_s + 2 * TK;  // [stage]
  float* px = reinterpret_cast<float*>(do_s + 2 * TV);
  float* lse_s = px + PX_FLOATS;  // [stage][64]
  float* dl_s = lse_s + 2 * BQ;   // [stage][64]

  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  // x: (batch * kv-head, split) with the split fastest; y: the key tile,
  // the first (heaviest under causality) dispatched first
  const int split = blockIdx.x % p.n_split, bkv = blockIdx.x / p.n_split;
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int k0 = blockIdx.y * BK;
  const int G = p.H / p.KV, GS = G / p.n_split, h0 = kvh * G + split * GS;
  const int k_valid = min(p.k_len, p.Sk);

  tc::cp_slabs<DQK, NT>(k_s, static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h,
                        p.sk.s, k0, p.Sk);
  tc::cp_slabs<DV, NT>(v_s, static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h,
                       p.sv.s, k0, p.Sk);

  // the q rows that can see a key of this tile, as in bwd_dkdv_mma; the
  // CTA walks n_q q tiles for each of its GS q-heads
  const int q_lo = p.causal && k0 >= p.prefix_len ? k0 : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + BK - 1 + p.window);
  if (k0 >= k_valid) q_hi = 0;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_it = GS * n_q;

  auto load_q = [&](int it, int stage) {
    const int h = h0 + it / n_q, q0 = q_lo + (it % n_q) * BQ;
    tc::cp_slabs<DQK, NT>(q_s + stage * TK,
                          static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                          p.Sq);
    tc::cp_slabs<DV, NT>(do_s + stage * TV,
                         static_cast<const bf16*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                         p.Sq);
    if (threadIdx.x < 2 * BQ) {  // 64 threads the lse, 64 the D
      const int r = threadIdx.x & (BQ - 1), qi = q0 + r;
      const long long at_ = (long long)(b * p.H + h) * p.Sq + min(qi, p.Sq - 1);
      if (threadIdx.x < BQ)
        tc::cp_async4(lse_s + stage * BQ + r, p.lse + at_, qi < p.Sq);
      else
        tc::cp_async4(dl_s + stage * BQ + r, p.delta + at_, qi < p.Sq);
    }
  };
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();  // with K and V

  const float sl2 = p.scale * LOG2E;
  const int kr = k0 + 16 * warp + (lane >> 2);  // this lane's keys: kr and kr + 8
  float acc[NA][8][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    tc::cp_async_wait<0>();  // this stage (and, the first time, K and V) has landed
    tc::fence_proxy_async();
    // every thread is past the previous iteration: the other stage and the
    // P^T exchange are free
    bar_sync(1, NT);
    const int q0 = q_lo + (it % n_q) * BQ;
    const unsigned char* qs = q_s + stage * TK;
    const unsigned char* ds = do_s + stage * TV;
    // the next stage's copies are issued while the score product runs
    auto load_next = [&] {
      if (it + 1 < n_it) load_q(it + 1, stage ^ 1);
      tc::cp_async_commit();
    };
    float x[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
    tc::wgmma_fence();
    if constexpr (ROLE == ROLE_DV)
      tc::wg_abt_issue<KS>(x, k_s, qs);  // S^T: this warp's 16 keys x 64 q rows
    else
      tc::wg_abt_issue<VS>(x, v_s, ds);  // dP^T
    tc::wgmma_commit();
    load_next();
    tc::wgmma_wait0();
    if constexpr (ROLE == ROLE_DV) {
      const float* ls = lse_s + stage * BQ;
      // only tiles at the diagonal (past the prefix span), the window's
      // edge, the valid length or the ragged q end evaluate the mask
      const bool edge = (p.causal && q0 < k0 + BK - 1 && k0 + BK > p.prefix_len) ||
                        (p.window > 0 && k0 <= q0 + BQ - 1 - p.window) || k0 + BK > k_valid ||
                        q0 + BQ > p.Sq;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * n + 2 * t + (e & 1), kj = kr + 8 * (e >> 1);
          float pr = exp2_ftz(x[n][e] * sl2 - ((e & 1) ? l.y : l.x) * LOG2E);
          if (edge && !(qi < p.Sq && visible(p, k_valid, qi, kj))) pr = 0.f;
          x[n][e] = pr;
          px[(4 * n + e) * 128 + tid] = pr;
        }
      }
      bar_arrive(2, NT);
      wg_split_ab<VS>(acc, x, ds);  // dV += P^T dO
    } else {
      const float* dls = dl_s + stage * BQ;
      bar_sync(2, NT);  // P^T is in
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[n][e] = px[(4 * n + e) * 128 + tid] * (x[n][e] - ((e & 1) ? d.y : d.x));
      }
      wg_split_ab<KS>(acc, x, qs);  // dK += dS^T Q
    }
  }
  tc::cp_async_wait<0>();  // with no q tile at all, K and V may still be in flight

  // dV, or dK * scale, into the bf16 gradient; with the head split this
  // CTA's f32 partial instead
  constexpr int W = ROLE == ROLE_DV ? DV : DQK;
  if (p.n_split == 1) {
    bf16* g = ROLE == ROLE_DV ? static_cast<bf16*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h
                              : static_cast<bf16*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
    const long long gs = ROLE == ROLE_DV ? p.sdv.s : p.sdk.s;
    const float mul = ROLE == ROLE_DV ? 1.f : p.scale;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = kr + 8 * i;
      if (kj >= p.Sk) continue;
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(g + kj * gs + 64 * n + 8 * j + 2 * t) =
              tc::pack_bf16(acc[n][j][2 * i] * mul, acc[n][j][2 * i + 1] * mul);
    }
  } else {
    float* part = (ROLE == ROLE_DV ? p.dv_part : p.dk_part) +
                  ((long long)split * p.B * p.KV + bkv) * p.Sk * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = kr + 8 * i;
      if (kj >= p.Sk) continue;
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(part + (long long)kj * W + 64 * n + 8 * j + 2 * t) =
              make_float2(acc[n][j][2 * i], acc[n][j][2 * i + 1]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(WIDE_DKDV_THREADS, 1) bwd_dkdv_wg2(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = tiles_base<true>(smem_raw);
  // a warpgroup-uniform branch: each role keeps only its own accumulators live
  if (threadIdx.x < 128)
    dkdv_wide_role<DQK, DV, ROLE_DV>(p, k_s);
  else
    dkdv_wide_role<DQK, DV, ROLE_DK>(p, k_s);
}

// the head split's reduction: one CTA per (batch * kv-head, key), the
// n_split partials summed in split order, dK scaled, both rounded to bf16
template <int DQK, int DV>
__global__ void __launch_bounds__(128) bwd_dkdv_reduce(Params p) {
  using bf16 = __nv_bfloat16;
  const long long row = blockIdx.x, rows = (long long)p.B * p.KV * p.Sk;
  const int kj = (int)(row % p.Sk), bkv = (int)(row / p.Sk), b = bkv / p.KV, kvh = bkv % p.KV;
  for (int c = threadIdx.x; c < (DQK + DV) / 2; c += blockDim.x) {
    const bool is_k = c < DQK / 2;
    const int W = is_k ? DQK : DV, col = 2 * (is_k ? c : c - DQK / 2);
    const float* src = (is_k ? p.dk_part : p.dv_part) + row * W + col;
    float2 s = *reinterpret_cast<const float2*>(src);
    for (int i = 1; i < p.n_split; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(src + i * rows * W);
      s.x += x.x;
      s.y += x.y;
    }
    if (is_k) {
      bf16* g = static_cast<bf16*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h + kj * p.sdk.s + col;
      *reinterpret_cast<uint32_t*>(g) = tc::pack_bf16(s.x * p.scale, s.y * p.scale);
    } else {
      bf16* g = static_cast<bf16*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h + kj * p.sdv.s + col;
      *reinterpret_cast<uint32_t*>(g) = tc::pack_bf16(s.x, s.y);
    }
  }
}

// dQ at the wide pairs: one CTA per (batch * q-head, QW * 64 q rows),
// warpgroup w owning rows 64 w .. 64 w + 63, all of them sharing a
// two-stage ring of 64-key K and V tiles; S = Q K^T and dP = dO V^T in one
// wgmma group, then dQ += dS K with dS as hi + lo register operands
template <int DQK, int DV, int QW>
__global__ void __launch_bounds__(128 * QW, 1) bwd_dq_wg(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int KS = DQK / 64, VS = DV / 64, NT = 128 * QW;
  constexpr int TQ = slab_tile_bytes<DQK>(), TO = slab_tile_bytes<DV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = tiles_base<true>(smem_raw);  // [warpgroup]
  unsigned char* do_s = q_s + QW * TQ;              // [warpgroup]
  unsigned char* k_s = do_s + QW * TO;              // [stage]
  unsigned char* v_s = k_s + 2 * TQ;                // [stage]

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0c = (gridDim.y - 1 - blockIdx.y) * BQ * QW;  // last (heaviest causal) tiles first
  const int q0 = q0c + BQ * wg;
  const int k_valid = min(p.k_len, p.Sk);

#pragma unroll
  for (int w = 0; w < QW; ++w) {
    tc::cp_slabs<DQK, NT>(q_s + w * TQ, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h,
                          p.sq.s, q0c + BQ * w, p.Sq);
    tc::cp_slabs<DV, NT>(do_s + w * TO,
                         static_cast<const bf16*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s,
                         q0c + BQ * w, p.Sq);
  }
  // the keys the CTA's rows see, as bwd_dq_mma walks them
  const int q_last_c = min(q0c + BQ * QW, p.Sq) - 1;
  const int k_hi = p.causal ? min(k_valid, max(q_last_c + 1, p.prefix_len)) : k_valid;
  const int k_lo = p.window > 0 ? max(0, q0c - p.window + 1) / BK * BK : 0;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  auto load_kv = [&](int kt, int stage) {
    tc::cp_slabs<DQK, NT>(k_s + stage * TQ, kg, p.sk.s, kt, p.Sk);
    tc::cp_slabs<DV, NT>(v_s + stage * TO, vg, p.sv.s, kt, p.Sk);
  };
  if (k_lo < k_hi) load_kv(k_lo, 0);
  tc::cp_async_commit();  // with Q and dO

  // this lane's q rows qr and qr + 8, and their lse (log2 domain) and D
  const int qr = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qr + 8 * i;
    const long long at_ = (long long)bh * p.Sq + min(qi, p.Sq - 1);
    lse2[i] = qi < p.Sq ? p.lse[at_] * LOG2E : 0.f;
    dl[i] = qi < p.Sq ? p.delta[at_] : 0.f;
  }
  const int q_last = min(q0 + BQ, p.Sq) - 1;  // below q0 when these rows lie past Sq
  const float sl2 = p.scale * LOG2E;
  float dq[KS][8][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][j][e] = 0.f;

  int stage = 0;
  for (int kt = k_lo; kt < k_hi; kt += BK, stage ^= 1) {
    tc::cp_async_wait<0>();  // this tile (and, the first time, Q and dO) has landed
    tc::fence_proxy_async();
    __syncthreads();  // and every warpgroup is done with the other stage
    // the next stage's copies are issued while the score products run
    auto load_next = [&] {
      if (kt + BK < k_hi) load_kv(kt + BK, stage ^ 1);
      tc::cp_async_commit();
    };
    // a warpgroup none of whose rows sees this tile skips it: rows past
    // Sq, keys after its last row (past the prefix span), or keys before
    // its first row's window
    if (q0 >= p.Sq || (p.causal && kt > q_last && kt >= p.prefix_len) ||
        (p.window > 0 && kt + BK - 1 <= q0 - p.window)) {
      load_next();
      continue;
    }
    const unsigned char* ks = k_s + stage * TQ;
    const unsigned char* vs = v_s + stage * TO;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    tc::wgmma_fence();
    tc::wg_abt_issue<KS>(s, q_s + wg * TQ, ks);    // S: this warp's 16 q rows x 64 keys
    tc::wg_abt_issue<VS>(dp, do_s + wg * TO, vs);  // dP
    tc::wgmma_commit();
    load_next();
    tc::wgmma_wait0();

    const bool edge = (p.causal && kt + BK - 1 > q0 && kt + BK > p.prefix_len) ||
                      (p.window > 0 && kt <= q_last - p.window) || kt + BK > k_valid ||
                      q0 + BQ > p.Sq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = qr + 8 * i, kj = kt + 8 * n + 2 * t + (e & 1);
        float pr = exp2_ftz(s[n][e] * sl2 - lse2[i]);
        if (edge && !(qi < p.Sq && visible(p, k_valid, qi, kj))) pr = 0.f;
        dp[n][e] = pr * (dp[n][e] - dl[i]);
      }
    // dQ += dS K; at 256 two m64n128 products a k-step: an m64n256 product
    // beside dQ's 128 accumulators spills
    wg_split_ab<KS, KS == 4 ? 2 : KS>(dq, dp, ks);
  }
  tc::cp_async_wait<0>();  // with no key tile at all, Q and dO may still be in flight

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qr + 8 * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dqg + qi * p.sdq.s + 64 * n + 8 * j + 2 * t) =
            tc::pack_bf16(dq[n][j][2 * i] * p.scale, dq[n][j][2 * i + 1] * p.scale);
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

// one kernel launch with `smem` bytes of dynamic shared memory, opted in first
template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, int smem, int device,
                       std::atomic<bool>* done, cudaStream_t stream, const Params& p) {
  cudaError_t err = opt_in_smem(kernel, smem, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_dkdv[MAX_DEVICES], set_dq[MAX_DEVICES];
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int key_tile = F32 ? f32_keys<DQK, DV>() : BK;
  const int q_tiles = (p.Sq + BQ - 1) / BQ, k_tiles = (p.Sk + key_tile - 1) / key_tile;
  if (q_tiles > 65535 || k_tiles > 65535) return cudaErrorInvalidValue;
  bwd_preprocess<T, DV><<<dim3((p.Sq + 7) / 8, p.B * p.H), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid(p.B * p.KV, k_tiles), dq_grid(p.B * p.H, q_tiles);
  if constexpr (F32) {
    constexpr int smem = smem_bytes<DQK, DV>();
    err = launch_one(bwd_dkdv<DQK, DV>, dkdv_grid, THREADS, smem, device, set_dkdv, stream, p);
    if (err != cudaSuccess) return err;
    return launch_one(bwd_dq<DQK, DV>, dq_grid, THREADS, smem, device, set_dq, stream, p);
  } else if constexpr (DQK >= 128) {
    // 128/128, 192/128 and 256/256: two warpgroups a dK/dV CTA sharing S^T,
    // the group's q-heads split over n_split CTAs (then a reduce launch),
    // and dQ on QW warpgroups
    constexpr int QW = wide_dq_warpgroups<DQK, DV>();
    err = launch_one(bwd_dkdv_wg2<DQK, DV>, dim3(p.B * p.KV * p.n_split, k_tiles),
                     WIDE_DKDV_THREADS, wide_dkdv_smem<DQK, DV>(), device, set_dkdv, stream, p);
    if (err != cudaSuccess) return err;
    if (p.n_split > 1) {
      bwd_dkdv_reduce<DQK, DV><<<p.B * p.KV * p.Sk, 128, 0, stream>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return launch_one(bwd_dq_wg<DQK, DV, QW>, dim3(p.B * p.H, (p.Sq + BQ * QW - 1) / (BQ * QW)),
                      128 * QW, wide_dq_smem<DQK, DV, QW>(), device, set_dq, stream, p);
  } else {
    // wgmma at head dim 64, mma.sync at 32
    constexpr bool WG = DQK == 64;
    constexpr int smem_kv = tc_smem_bytes<DQK, DV, WG>(true);
    constexpr int smem_q = tc_smem_bytes<DQK, DV, WG>(false);
    err = launch_one(bwd_dkdv_mma<DQK, DV, WG>, dkdv_grid, MMA_THREADS, smem_kv, device, set_dkdv,
                     stream, p);
    if (err != cudaSuccess) return err;
    return launch_one(bwd_dq_mma<DQK, DV, WG>, dq_grid, MMA_THREADS, smem_q, device, set_dq,
                      stream, p);
  }
}

template <typename T>
cudaError_t launch_dims(const Params& p, int Dqk, int Dv, int device, cudaStream_t stream) {
  if (Dqk == 192 && Dv == 128) return launch<T, 192, 128>(p, device, stream);  // MLA
  if (Dqk != Dv) return cudaErrorInvalidValue;
  switch (Dqk) {
    case 32: return launch<T, 32, 32>(p, device, stream);
    case 64: return launch<T, 64, 64>(p, device, stream);
    case 128: return launch<T, 128, 128>(p, device, stream);
    case 256: return launch<T, 256, 256>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
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

// dtype: 0 = float32, 1 = bfloat16, the same for q, k, v, o, dO and the
// gradients. (Dqk, Dv): (32, 32), (64, 64), (128, 128), (256, 256) or MLA's
// (192, 128); q, k and dq, dk are Dqk wide, v, o, dO and dv Dv wide.
// `strides` holds, in elements, (batch, head, seq) strides of q, k, v, o,
// dO, dq, dk, dv in that order (24 values); the last dim of each must be
// contiguous. lse is the
// forward's (B, H, Sq) f32 output and delta a (B, H, Sq) f32 scratch. With
// `causal`, keys at positions below `prefix_len` (0: none) are visible to
// every query, as in the forward. `n_split`: in bf16 at (128, 128),
// (192, 128) and (256, 256), the CTAs each kv-head's H / KV q-heads are
// split over (a divisor of H / KV), and with n_split > 1 `part` an f32
// scratch of n_split * B * KV * Sk * (Dqk + Dv) values; elsewhere 1.
// Launches the
// kernels (preprocess, dK/dV, the reduce with n_split > 1, dQ) on `stream`
// of `device` (made the thread's current device for the call, then
// restored). Returns the first launch's error that is not cudaSuccess.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int device,
    int B, int H, int KV, int Sq, int Sk, int Dqk, int Dv, const long long* strides,
    int causal, int window, int k_len, int prefix_len, float scale, void* stream, int n_split,
    float* part) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || prefix_len < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool wide = dtype == 1 && Dqk >= 128;
  if (n_split < 1 || (H / KV) % n_split != 0 || (n_split > 1 && (!wide || !part)))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dO = dO;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  Strides* s[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.causal = causal;
  p.window = window;
  p.k_len = k_len;
  p.prefix_len = prefix_len;
  p.scale = scale;
  p.n_split = n_split;
  p.dk_part = n_split > 1 ? part : nullptr;
  p.dv_part = n_split > 1 ? part + (long long)n_split * B * KV * Sk * Dqk : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_dims<__nv_bfloat16>(p, Dqk, Dv, device, st)
                          : launch_dims<float>(p, Dqk, Dv, device, st));
}
