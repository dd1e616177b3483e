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
// bf16, the served path: one CTA of 8 warps per (batch * q-head, 64-row q
// tile); the grid dispatches every head's last q tile first, since on the
// causal diagonal it sees the most keys. K and V stay bf16 in a two-stage
// shared-memory ring of 128-key tiles (64 at Dh = 128) filled by 16-byte
// cp.async copies, so the next tile loads while this one computes. Two
// groups of 4 warps (two warpgroups) split each tile's keys in halves: at
// prefill batch 1 the card holds too few CTAs to hide the latency of one
// group walking every key tile, and the split halves each group's walk. The
// online softmax (running max, denominator, rescale, all f32, -1e30 masking
// before the max) runs on the score fragments in registers, and P is
// rounded to bf16 in registers and fed straight back as the A operand of
// P V; only key halves on the diagonal, at the window's edge or at the valid
// length evaluate the mask. At the end the groups merge (max, sum, output)
// per row through shared memory, exactly: both rescale to the common max.
//  - Dh = 64, the served head dim (flash_fwd_wgmma): each group is one
//    warpgroup issuing wgmma.m64n64k16 (bf16 operands, f32 accumulators):
//    Q K^T with Q and K read by the tensor cores from 128-byte-swizzled
//    shared memory, P V with P from registers and V from shared memory.
//  - Dh = 32 and 128 (flash_fwd_mma): each warp of a group owns 16 q rows
//    and runs mma.sync.m16n8k16 fed by ldmatrix from rows padded by 16
//    bytes. Each warp re-reads K and V fragments for only 16 rows, the
//    shared-memory traffic that wgmma's direct B reads remove.
//  - Dqk = 192, Dv = 128 (flash_fwd_mma<192, 128>), MLA's expanded prefill
//    (deepseek-v2: 128 nope + 64 rope dims of q and k, 128 of v): the same
//    kernel with Q and K tiles 192 wide and V tiles 128 wide, so Q K^T runs
//    12 k-steps (50 % deeper than at 128) and the output fragment stays 16
//    n-tiles of 8. V is not padded to 192: that would waste a third of the
//    P V products and of the output traffic. 64-key tiles, as at 128: the
//    CTA holds q (64 x 200), two stages of K (64 x 200) and of V (64 x 136),
//    109 KiB, one CTA an SM; each warp keeps its q fragments (48 registers)
//    beside its 64 output accumulators. The work per head is
//    2 Sq Sk/2 (192 + 128) FLOPs against q, k, v and o read or written once.
//  - Dqk = Dv = 256 (flash_fwd_mma<256, 256>), gemma's head dim (paligemma:
//    MQA, 8 q-heads on one kv-head, a prefix-LM mask over its 256 image
//    tokens): Q, K and V tiles 256 wide, 64-key tiles. A warp's 16-row
//    output is 32 n-tiles, 128 f32 registers a thread, so it does not keep
//    its q fragments (64 more registers, which would spill): each of the 16
//    k-steps of Q K^T reads them from the q tile by ldmatrix. The CTA holds
//    q and two stages of K and V, rows of 264, 165 KiB, one CTA an SM.
// What holds the wgmma form back next: each group waits for its Q K^T
// before the softmax and for its P V before the next tile (no overlap of
// the two within a warpgroup), and the loads come from cp.async issued by
// the same warps rather than TMA from a producer warp. The wrapper requires
// 16-byte aligned base pointers and strides and raises otherwise.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// the key range [k_lo, k_hi) a q tile starting at q0 can see, k_lo on a
// boundary of bk-key tiles; a causal tile's keys run to its diagonal or to
// the end of the prefix-LM span, whichever is further
struct KeyRange {
  int k_valid, q_last, k_lo, k_hi;
  __device__ KeyRange(const Params& p, int q0, int bk) {
    k_valid = min(p.k_len, p.Sk);
    q_last = min(q0 + BQ, p.Sq) - 1;
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

// Keys per shared-memory tile, half of them to each warp group: 128 where
// a warp's score and output fragments fit 128 registers (Dqk <= 64, two
// CTAs an SM), 64 at Dqk = 128 and 192 (one CTA an SM).
template <int DQK>
__host__ __device__ constexpr int mma_bk() {
  return DQK <= 64 ? 128 : 64;
}
template <int DQK>
__host__ __device__ constexpr int mma_min_blocks() {
  return DQK <= 64 ? 2 : 1;
}

template <int DQK, int DV>
constexpr int mma_smem_bytes() {
  // the q tile and two stages of k, rows of Dqk + 8; two stages of v, rows
  // of Dv + 8; the groups' merge reuses it
  return ((BQ + 2 * mma_bk<DQK>()) * (DQK + 8) + 2 * mma_bk<DQK>() * (DV + 8)) * 2;
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(MMA_THREADS, mma_min_blocks<DQK>()) flash_fwd_mma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = mma_bk<DQK>();
  constexpr int HK = BK / 2;    // keys of a tile for one warp group
  constexpr int LD = DQK + 8;   // padded q and k row, in elements
  constexpr int LDV = DV + 8;   // padded v row
  constexpr int KD = DQK / 16;  // k-steps of Q K^T
  constexpr int ND = DV / 8;    // n-tiles of O
  constexpr int NS = HK / 8;    // n-tiles of a warp's S
  constexpr int CH = DQK / 8;   // 16-byte pieces of a q or k row
  constexpr int CHV = DV / 8;   // of a v row
  // a warp keeps its q fragments in registers up to Dqk = 192 (48
  // registers there); at 256 they would take 64 beside the 128 output
  // accumulators and spill, so each k-step of Q K^T reads them again from
  // the q tile in shared memory (ldmatrix)
  constexpr bool Q_REGS = DQK <= 192;
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
  uint32_t qf[Q_REGS ? KD : 1][4];
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
    if constexpr (Q_REGS) {
      if (k0 == kr.k_lo) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          tc::ldsm_x4(qf[kd], q_s + (16 * wr + tc::x_row(lane)) * LD + 16 * kd + tc::x_col(lane));
      }
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
        uint32_t a[4];
        if constexpr (Q_REGS) {
          a[0] = qf[kd][0], a[1] = qf[kd][1], a[2] = qf[kd][2], a[3] = qf[kd][3];
        } else {
          tc::ldsm_x4(a, q_s + (16 * wr + tc::x_row(lane)) * LD + 16 * kd + tc::x_col(lane));
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          tc::ldsm_x4(r, ks + (16 * np + tc::y_row(lane)) * LD + 16 * kd + tc::y_col(lane));
          tc::mma(s[2 * np], a, r[0], r[1]);
          tc::mma(s[2 * np + 1], a, r[2], r[3]);
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

template <int DQK, int DV>
cudaError_t launch(const Params& p, bool bf16, int device, cudaStream_t stream) {
  static std::atomic<bool> set_bf16[MAX_DEVICES], set_f32[MAX_DEVICES];
  const int q_tiles = (p.Sq + BQ - 1) / BQ;
  if (bf16) {
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
  } else {
    constexpr int smem = f32_smem_bytes<DQK, DV>();
    cudaError_t err = opt_in_smem(flash_fwd_f32<DQK, DV>, smem, device, set_f32);
    if (err != cudaSuccess) return err;
    flash_fwd_f32<DQK, DV><<<dim3(q_tiles, p.B * p.H), F32_THREADS, smem, stream>>>(p);
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
