// Mamba2 SSD chunked scan forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the reference's Pallas TPU kernel `src/repro/kernels/ssd.py:_kernel`
// (launched by `ssd_bshp`). It computes, per (batch, head), over chunks of
// length cl taken in order, with dA = dt * A and cum the inclusive prefix
// sum of dA inside the chunk:
//
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//            + exp(cum_i) C_i . state                                 (inter)
//   state   <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// and, unlike the TPU kernel, it writes out the f32 state after the last
// real position, so a prefill can hand it to decode (the function of the
// reference's `ssd_reference(..., return_final_state=True)`), starting from
// a zero state. A ragged last chunk is masked: rows >= S are not
// loaded, not stored and add nothing to the state, which is what the
// reference's zero-dt padding computes. exp is evaluated only where j <= i,
// so exp of a positive segment sum never overflows into inf * 0.
//
// What bounds it on this card: each input is read once and y written once,
// and the FLOPs are C B^T and the causal half of M x per chunk plus the
// inter-chunk term and the state update per head; at mamba2-1.3b's shapes
// (H=64, P=64, N=128, chunk 256, bf16) that is bytes-bound at the H100's
// peaks. At batch 1 the grid is a few hundred CTAs, so latency decides.
//
// bf16, the served path: three launches, none of which walks the chunks
// inside one CTA except the elementwise middle one.
//  1. ssd_chunk_state, a CTA per (batch, chunk, head, 64-column tile of P):
//     S_c = (exp(cum_last - cum_j) dt_j x_j)^T B_j over the chunk's rows,
//     (P, N), on the tensor cores, and the chunk's sum of dA, into f32
//     scratch.
//  2. ssd_state_pass, a thread per (batch, head, state element): walks the
//     chunks in order, h_c = h_{c-1} exp(sum dA_{c-1}) + S_{c-1}, writes the
//     state entering each chunk over S_c and the final state to `fin`.
//  3. ssd_chunk_scan, a CTA per (batch, chunk, head, 64-row tile of the
//     chunk, 64-column tile of P), the row tiles with the most B and x
//     tiles to their left dispatched first: C_i B_j^T, the masked and
//     decayed M = (C_i B_j^T) exp(cum_i - cum_j) dt_j times x_j, and
//     exp(cum_i) C_i h_c, all on the tensor cores; y written once in bf16.
// Products are mma.sync.m16n8k16 (bf16 operands, f32 accumulators) fed by
// ldmatrix from bf16 tiles filled by 16-byte cp.async copies, the B and x
// tiles of the next 64 rows loading while this one computes (two stages).
// M and h_c are rounded to bf16 as operands; the decays, the prefix sums
// and every accumulation stay f32. C B^T is recomputed per head on the
// tensor cores rather than shared: at chunk 256 it is 64 x 256 x 128 MACs a
// CTA at most, a few microseconds of one SM in all. N and the P tile are
// padded to multiples of 16 with zeros in shared memory, chunk rows past
// the end with zero loads and dt = 0. The wrapper requires 16-byte aligned
// base pointers and strides, and P and N multiples of 8, and raises
// otherwise.
//
// f32, the parity path (ssd_fwd_f32): FMA tiles on the FP32 pipes (the
// tensor cores take no f32 operand that holds a 1e-4 tolerance). One CTA of
// 256 threads per (batch, head, PT-column tile of P) loops over the chunks
// in order with its (PT, N) state tile in shared memory; each state row p
// depends only on x[..., p], dt and the shared B, so P splits across CTAs
// without communication. PT is 64, 32 or 16, the widest that still puts
// about 3/4 of the SMs to work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "tensor_core.cuh"

namespace {

constexpr int TILE = 64;  // rows of a C, B or x tile
constexpr int F32_THREADS = 256;
constexpr int MMA_THREADS = 128;
constexpr int PS = TILE + 4;  // padded row stride of the f32 score tile
constexpr int MAX_N = 128;    // state columns
constexpr int PT_MMA = 64;    // P columns of a bf16 CTA
constexpr int LDX = PT_MMA + 8;  // padded row of a bf16 x tile, in elements
constexpr int PASS_THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;            // (B, S, H, P) strided, x's dtype
  float* fin;         // (B, H, P, N) f32 contiguous
  float* states;      // bf16 path: (B, nc, H, P, N) f32 scratch
  float* chunk_sum;   // bf16 path: (B, nc, H) f32 scratch, sum of dA * log2(e) per chunk
  int B, S, H, P, N, cl;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// -- bf16: chunk-parallel, tensor cores -----------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// cum_s[r] = a log2(e) sum_{k <= r} dt[t0 + k] (the prefix sum of dA in
// log2 units, so a decay is one exp2f) and dt_s[r] = dt[t0 + r] for r < n;
// for n <= r < n_pad, dt_s[r] = 0 and cum_s[r] = cum_s[n - 1]. All
// MMA_THREADS threads call it; it ends with a barrier.
__device__ void chunk_cumsum(float* cum_s, float* dt_s, float* wsum, const float* dtg,
                             long long dt_ss, int t0, int n, int n_pad, float a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int r0 = 0; r0 < n_pad; r0 += MMA_THREADS) {
    const int r = r0 + threadIdx.x;
    const float d = r < n ? dtg[(long long)(t0 + r) * dt_ss] : 0.f;
    float v = d * a * LOG2E;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    v += carry;
    if (r < n_pad) {
      cum_s[r] = v;
      dt_s[r] = d;
    }
    carry += wsum[0] + wsum[1] + wsum[2] + wsum[3];
    __syncthreads();  // wsum is rewritten by the next round
  }
}

// rows [j0, j0 + TILE) of the chunk (real below `len`) of an (S, ncols)
// bf16 matrix into a TILE x ld tile of `width` columns; the rest zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, int width,
                                          const __nv_bfloat16* src, long long ss, int t0, int j0,
                                          int len, int ncols) {
  const int pieces = width / 8;
  for (int e = threadIdx.x; e < TILE * pieces; e += MMA_THREADS) {
    const int r = e / pieces, col = (e % pieces) * 8, j = j0 + r;
    const bool in = j < len && col < ncols;
    tc::cp_async16(dst + r * ld + col, in ? src + (long long)(t0 + j) * ss + col : src, in);
  }
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo, float hi) {
  const float2 f = tc::unpack_bf16(v);
  return tc::pack_bf16(f.x * lo, f.y * hi);
}

size_t chunk_state_smem(int n, int cl) {
  const int ldn = round_up(n, 16) + 8;
  return 2 * TILE * (LDX + ldn) * 2 + (2 * round_up(cl, TILE) + 4) * 4;
}

__global__ void __launch_bounds__(MMA_THREADS) ssd_chunk_state(Params p) {
  using bf16 = __nv_bfloat16;
  const int NPAD = round_up(p.N, 16), LDN = NPAD + 8, CLP = round_up(p.cl, TILE);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [2][TILE][LDX]
  bf16* b_s = x_s + 2 * TILE * LDX;                // [2][TILE][LDN]
  float* cum_s = reinterpret_cast<float*>(b_s + 2 * TILE * LDN);
  float* w_s = cum_s + CLP;  // dt, then the weight exp(cum_last - cum_j) dt_j
  float* wsum = w_s + CLP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = (p.S + p.cl - 1) / p.cl;
  const int pt = blockIdx.x, h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0);
  const int p0 = pt * PT_MMA, pcols = min(PT_MMA, p.P - p0);
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;

  auto load = [&](int j0, int stage) {
    load_tile(x_s + stage * TILE * LDX, LDX, PT_MMA, xg, p.x_ss, t0, j0, len, pcols);
    load_tile(b_s + stage * TILE * LDN, LDN, NPAD, bg, p.b_ss, t0, j0, len, p.N);
  };
  load(0, 0);
  tc::cp_async_commit();  // lands while the prefix sum runs

  chunk_cumsum(cum_s, w_s, wsum, dtg, p.dt_ss, t0, len, CLP, p.A[h]);
  const float cum_last = cum_s[len - 1];
  for (int r = tid; r < CLP; r += MMA_THREADS) w_s[r] *= exp2f(cum_last - cum_s[r]);
  if (tid == 0 && pt == 0) p.chunk_sum[(long long)blockIdx.z * p.H + h] = cum_last;

  const int NT = NPAD / 8;
  const bool active = 16 * warp < pcols;  // this warp's 16 rows of the P tile
  float acc[MAX_N / 8][4];
#pragma unroll
  for (int n = 0; n < MAX_N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (len + TILE - 1) / TILE;
  int stage = 0;
  for (int jt = 0; jt < ntiles; ++jt, stage ^= 1) {
    if (jt + 1 < ntiles) load((jt + 1) * TILE, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile has landed, and w_s is written
    const bf16* xs = x_s + stage * TILE * LDX;
    const bf16* bs = b_s + stage * TILE * LDN;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks) {
        const int j = jt * TILE + 16 * ks;  // chunk row of this k-step
        if (j >= len) break;
        // A = x^T (P rows by chunk rows), weighted along the chunk rows
        uint32_t a[4];
        tc::ldsm_x4_trans(a, xs + (16 * ks + tc::y_row(lane)) * LDX + 16 * warp + tc::y_col(lane));
        const float w0 = w_s[j + 2 * t], w1 = w_s[j + 2 * t + 1];
        const float w8 = w_s[j + 2 * t + 8], w9 = w_s[j + 2 * t + 9];
        a[0] = scale_bf16x2(a[0], w0, w1);
        a[1] = scale_bf16x2(a[1], w0, w1);
        a[2] = scale_bf16x2(a[2], w8, w9);
        a[3] = scale_bf16x2(a[3], w8, w9);
#pragma unroll
        for (int np = 0; np < MAX_N / 16; ++np) {
          if (2 * np < NT) {
            uint32_t r[4];
            tc::ldsm_x4_trans(r, bs + (16 * ks + tc::x_row(lane)) * LDN + 16 * np + tc::x_col(lane));
            tc::mma(acc[2 * np], a, r[0], r[1]);
            tc::mma(acc[2 * np + 1], a, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!active) return;
  float* st = p.states + ((long long)blockIdx.z * p.H + h) * p.P * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = 16 * warp + g + 8 * half;
    if (pr >= pcols) continue;
#pragma unroll
    for (int n = 0; n < MAX_N / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (n < NT && col < p.N)
        *reinterpret_cast<float2*>(st + (long long)(p0 + pr) * p.N + col) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass(Params p) {
  const int nc = (p.S + p.cl - 1) / p.cl;
  const long long PN = (long long)p.P * p.N;
  const long long e = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float s = 0.f;
  long long bch = (long long)b * nc * p.H + h;  // (b, c, h) for c = 0
  float local = p.states[bch * PN + e];
  for (int c = 0; c < nc; ++c, bch += p.H) {
    const float next = c + 1 < nc ? p.states[(bch + p.H) * PN + e] : 0.f;
    p.states[bch * PN + e] = s;  // the state entering chunk c
    s = s * exp2f(p.chunk_sum[bch]) + local;
    local = next;
  }
  p.fin[((long long)b * p.H + h) * PN + e] = s;
}

size_t chunk_scan_smem(int n, int cl) {
  const int ldn = round_up(n, 16) + 8;
  return (TILE + PT_MMA + 2 * TILE) * ldn * 2 + 2 * TILE * LDX * 2 +
         (2 * round_up(cl, TILE) + 4) * 4;
}

__global__ void __launch_bounds__(MMA_THREADS) ssd_chunk_scan(Params p) {
  using bf16 = __nv_bfloat16;
  const int NPAD = round_up(p.N, 16), LDN = NPAD + 8, CLP = round_up(p.cl, TILE);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LDN]
  bf16* h_s = c_s + TILE * LDN;                    // [PT_MMA][LDN], the entering state
  bf16* b_s = h_s + PT_MMA * LDN;                  // [2][TILE][LDN]
  bf16* x_s = b_s + 2 * TILE * LDN;                // [2][TILE][LDX]
  float* cum_s = reinterpret_cast<float*>(x_s + 2 * TILE * LDX);
  float* dt_s = cum_s + CLP;
  float* wsum = dt_s + CLP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = (p.S + p.cl - 1) / p.cl;
  const int n_it = (p.cl + TILE - 1) / TILE, n_pt = (p.P + PT_MMA - 1) / PT_MMA;
  // row tiles are the slowest grid axis, last first: every (batch, chunk,
  // head)'s heaviest tile (the most B, x tiles to its left) goes out first
  const int it = n_it - 1 - blockIdx.z / n_pt;
  const int pt = blockIdx.z % n_pt, h = blockIdx.x;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), i0 = it * TILE;
  if (i0 >= len) return;  // past a ragged last chunk
  const int p0 = pt * PT_MMA, pcols = min(PT_MMA, p.P - p0);
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.c_sb;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  bf16* yg = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh + p0;

  auto load = [&](int j0, int stage) {
    load_tile(b_s + stage * TILE * LDN, LDN, NPAD, bg, p.b_ss, t0, j0, len, p.N);
    load_tile(x_s + stage * TILE * LDX, LDX, PT_MMA, xg, p.x_ss, t0, j0, len, pcols);
  };
  load_tile(c_s, LDN, NPAD, cg, p.c_ss, t0, i0, len, p.N);
  load(0, 0);
  tc::cp_async_commit();

  chunk_cumsum(cum_s, dt_s, wsum, dtg, p.dt_ss, t0, min(len, i0 + TILE), i0 + TILE, p.A[h]);
  if (c > 0) {  // the state entering the chunk, as a bf16 operand
    const float* st = p.states + ((long long)blockIdx.y * p.H + h) * p.P * p.N;
    for (int e = tid; e < PT_MMA * NPAD; e += MMA_THREADS) {
      const int pr = e / NPAD, n = e % NPAD;
      const float v = pr < pcols && n < p.N ? st[(long long)(p0 + pr) * p.N + n] : 0.f;
      h_s[pr * LDN + n] = __float2bfloat16(v);
    }
  }

  const int KS = NPAD / 16;                 // k-steps over N
  const int PNT = round_up(pcols, 16) / 8;  // n-tiles over this P tile
  const int row0 = i0 + 16 * warp + g;      // this lane's chunk rows: row0, row0 + 8
  uint32_t cf[MAX_N / 16][4];
  float acc[PT_MMA / 8][4];
#pragma unroll
  for (int n = 0; n < PT_MMA / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int stage = 0;
  for (int jt = 0; jt <= it; ++jt, stage ^= 1) {
    if (jt < it) load((jt + 1) * TILE, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile (and, the first time, C and h_s) is in
    if (jt == 0) {
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks)
        if (ks < KS)
          tc::ldsm_x4(cf[ks], c_s + (16 * warp + tc::x_row(lane)) * LDN + 16 * ks + tc::x_col(lane));
      if (c > 0) {  // inter-chunk term: exp(cum_i) C_i . h_c
#pragma unroll
        for (int ks = 0; ks < MAX_N / 16; ++ks) {
          if (ks >= KS) break;
#pragma unroll
          for (int np = 0; np < PT_MMA / 16; ++np) {
            if (2 * np < PNT) {
              uint32_t r[4];
              tc::ldsm_x4(r, h_s + (16 * np + tc::y_row(lane)) * LDN + 16 * ks + tc::y_col(lane));
              tc::mma(acc[2 * np], cf[ks], r[0], r[1]);
              tc::mma(acc[2 * np + 1], cf[ks], r[2], r[3]);
            }
          }
        }
        const float e0 = row0 < len ? exp2f(cum_s[row0]) : 0.f;
        const float e8 = row0 + 8 < len ? exp2f(cum_s[row0 + 8]) : 0.f;
#pragma unroll
        for (int n = 0; n < PT_MMA / 8; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e8;
          acc[n][3] *= e8;
        }
      }
    }
    const bf16* bs = b_s + stage * TILE * LDN;
    const bf16* xs = x_s + stage * TILE * LDX;

    // S = C_i B_j^T over this 64-row tile of j
    float s[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MAX_N / 16; ++ks) {
      if (ks >= KS) break;
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t r[4];
        tc::ldsm_x4(r, bs + (16 * np + tc::y_row(lane)) * LDN + 16 * ks + tc::y_col(lane));
        tc::mma(s[2 * np], cf[ks], r[0], r[1]);
        tc::mma(s[2 * np + 1], cf[ks], r[2], r[3]);
      }
    }
    // M = S exp(cum_i - cum_j) dt_j where j <= i < len, else 0
    const int j0 = jt * TILE;
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = j <= i && i < len ? s[n][e] * exp2f(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
      }
    // y += M x_j
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t a[4];
      tc::pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < PT_MMA / 16; ++np) {
        if (2 * np < PNT) {
          uint32_t r[4];
          tc::ldsm_x4_trans(r, xs + (16 * kk + tc::x_row(lane)) * LDX + 16 * np + tc::x_col(lane));
          tc::mma(acc[2 * np], a, r[0], r[1]);
          tc::mma(acc[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + 8 * half;
    if (i >= len) continue;
#pragma unroll
    for (int n = 0; n < PT_MMA / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < pcols)
        *reinterpret_cast<uint32_t*>(yg + (long long)(t0 + i) * p.y_ss + col) =
            tc::pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// -- f32: FMA tiles, one CTA per (batch, head, P tile) over the chunks -------

// rows [t, t + rows) of a (S, N) matrix with row stride ss into a TILE x ns
// f32 tile; rows past `rows` are zero
__device__ __forceinline__ void load_rows(float* dst, const float* src, int t, int rows,
                                          int n_cols, int ns, long long ss) {
  for (int r = threadIdx.x / 32; r < TILE; r += F32_THREADS / 32) {
    for (int n = threadIdx.x % 32; n < n_cols; n += 32)
      dst[r * ns + n] = r < rows ? src[(t + r) * ss + n] : 0.f;
  }
}

template <int PT>
__global__ void __launch_bounds__(F32_THREADS) ssd_fwd_f32(Params p) {
  constexpr int PC = PT / 16;  // y columns / state rows per thread
  const int N = p.N;
  const int NS = N + 1;  // padded row stride: column walks hit distinct banks
  extern __shared__ float smem[];
  float* c_s = smem;                // TILE x NS
  float* b_s = c_s + TILE * NS;     // TILE x NS
  float* st_s = b_s + TILE * NS;    // PT x NS, the carried state
  float* x_s = st_s + PT * NS;      // TILE x PT, dt-weighted x
  float* p_s = x_s + TILE * PT;     // TILE x PS, masked decayed scores
  float* cum_s = p_s + TILE * PS;   // cl, prefix sum of dt * A in the chunk
  float* dt_s = cum_s + p.cl;       // cl

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_pt = (p.P + PT - 1) / PT;
  const int pt = blockIdx.x % n_pt;
  const int h = (blockIdx.x / n_pt) % p.H;
  const int b = blockIdx.x / (n_pt * p.H);
  const int p0 = pt * PT;
  const float a = p.A[h];

  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.c_sb;
  float* yg = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh + p0;
  const long long st_off = ((long long)(b * p.H + h) * p.P + p0) * N;

  for (int e = tid; e < PT * N; e += F32_THREADS) st_s[(e / N) * NS + e % N] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.cl) {
    const int len = min(p.cl, p.S - t0);  // real rows of this chunk
    __syncthreads();  // the previous chunk is done with cum_s, dt_s and st_s
    if (tid < 32) {   // warp 0: inclusive prefix sum of dt * A, 32 rows a step
      float carry = 0.f;
      for (int r0 = 0; r0 < len; r0 += 32) {
        const int r = r0 + tid;
        const float d = r < len ? dtg[(t0 + r) * p.dt_ss] : 0.f;
        float v = d * a;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(FULL, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (r < len) {
          cum_s[r] = v;
          dt_s[r] = d;
        }
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum_s[len - 1];

    for (int i0 = 0; i0 < len; i0 += TILE) {
      const int in = min(TILE, len - i0);
      load_rows(c_s, cg, t0 + i0, in, N, NS, p.c_ss);
      __syncthreads();

      // inter-chunk term from the state entering the chunk
      float acc[4][PC];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[k][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int k = 0; k < 4; ++k) cv[k] = c_s[(4 * ty + k) * NS + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = st_s[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[k][c] = fmaf(cv[k], sv[c], acc[k][c]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * ty + k;
        const float d = i < in ? expf(cum_s[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[k][c] *= d;
      }

      // intra-chunk term over the key tiles at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int jn = min(TILE, len - j0);
        __syncthreads();  // readers of b_s, x_s and p_s are done
        load_rows(b_s, bg, t0 + j0, jn, N, NS, p.b_ss);
        for (int e = tid; e < TILE * PT; e += F32_THREADS) {
          const int r = e / PT, c = e % PT;
          x_s[e] = (r < jn && p0 + c < p.P)
                       ? xg[(t0 + j0 + r) * p.x_ss + c] * dt_s[j0 + r]
                       : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[k][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) cv[k] = c_s[(4 * ty + k) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[k][j] = fmaf(cv[k], bv[j], s[k][j]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + 4 * ty + k;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = j0 + tx + 16 * j;
            float v = 0.f;
            if (jj <= i && i < len) v = s[k][j] * expf(cum_s[i] - cum_s[jj]);
            p_s[(4 * ty + k) * PS + tx + 16 * j] = v;
          }
        }
        __syncthreads();

        for (int j = 0; j < jn; ++j) {
          float pv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) pv[k] = p_s[(4 * ty + k) * PS + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const float xv = x_s[j * PT + tx + 16 * c];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k][c] = fmaf(pv[k], xv, acc[k][c]);
          }
        }
      }

#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * ty + k;
        if (i >= in) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          if (p0 + tx + 16 * c < p.P)
            yg[(t0 + i0 + i) * p.y_ss + tx + 16 * c] = acc[k][c];
        }
      }
      __syncthreads();  // c_s is reloaded by the next row tile
    }

    // state update: rows ty * PC + r, columns tx + 16 q
    const int nq = (N + 15) / 16;
    float sacc[PC][MAX_N / 16];
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        const int n = tx + 16 * q;
        sacc[r][q] = (q < nq && n < N) ? st_s[(ty * PC + r) * NS + n] * decay : 0.f;
      }
    for (int j0 = 0; j0 < len; j0 += TILE) {
      const int jn = min(TILE, len - j0);
      __syncthreads();  // readers of b_s and x_s are done
      load_rows(b_s, bg, t0 + j0, jn, N, NS, p.b_ss);
      for (int e = tid; e < TILE * PT; e += F32_THREADS) {
        const int r = e / PT, c = e % PT;
        x_s[e] = (r < jn && p0 + c < p.P)
                     ? xg[(t0 + j0 + r) * p.x_ss + c] * dt_s[j0 + r] *
                           expf(cum_last - cum_s[j0 + r])
                     : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        float xv[PC];
#pragma unroll
        for (int r = 0; r < PC; ++r) xv[r] = x_s[j * PT + ty * PC + r];
#pragma unroll
        for (int q = 0; q < MAX_N / 16; ++q) {
          if (q < nq) {
            const int n = tx + 16 * q;
            const float bv = n < N ? b_s[j * NS + n] : 0.f;
#pragma unroll
            for (int r = 0; r < PC; ++r) sacc[r][q] = fmaf(xv[r], bv, sacc[r][q]);
          }
        }
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        const int n = tx + 16 * q;
        if (q < nq && n < N) st_s[(ty * PC + r) * NS + n] = sacc[r][q];
      }
  }

  __syncthreads();
  for (int e = tid; e < PT * N; e += F32_THREADS) {
    const int r = e / N, n = e % N;
    if (p0 + r < p.P) p.fin[st_off + r * N + n] = st_s[r * NS + n];
  }
}

size_t f32_smem_bytes(int pt, int n, int cl) {
  return sizeof(float) * ((size_t)(2 * TILE + pt) * (n + 1) + TILE * pt + TILE * PS + 2 * cl);
}

// -- launch ---------------------------------------------------------------------

// the opt-in above 48 KiB belongs to the function on one device: set it once
// per (kernel, device), to the device's limit; a racing second setter is
// harmless
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int device, std::atomic<bool>* done) {
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int PT>
cudaError_t launch_f32(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  cudaError_t err = opt_in_smem(ssd_fwd_f32<PT>, device, smem_set);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)p.B * p.H * ((p.P + PT - 1) / PT);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_fwd_f32<PT><<<(unsigned)ctas, F32_THREADS, f32_smem_bytes(PT, p.N, p.cl), stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the widest P tile that still gives about 3/4 of the SMs a CTA, and no
  // wider than P rounded up to 16
  const long long bh = (long long)p.B * p.H;
  const int p16 = (p.P + 15) / 16 * 16;
  if (p16 >= 64 && bh * ((p.P + 63) / 64) * 4 >= 3LL * sms) return launch_f32<64>(p, device, stream);
  if (p16 >= 32 && bh * ((p.P + 31) / 32) * 4 >= 3LL * sms) return launch_f32<32>(p, device, stream);
  return launch_f32<16>(p, device, stream);
}

// the three bf16 launches on one stream, each checked
cudaError_t launch_bf16(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_state[MAX_DEVICES], set_scan[MAX_DEVICES];
  if (p.P % 8 || p.N % 8) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(ssd_chunk_state, device, set_state);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(ssd_chunk_scan, device, set_scan);
  if (err != cudaSuccess) return err;
  const int nc = (p.S + p.cl - 1) / p.cl;
  const int n_pt = (p.P + PT_MMA - 1) / PT_MMA, n_it = (p.cl + TILE - 1) / TILE;
  const long long pn = (long long)p.P * p.N;
  if ((long long)p.B * nc > 65535 || p.B > 65535 || n_it * n_pt > 65535) return cudaErrorInvalidValue;
  ssd_chunk_state<<<dim3(n_pt, p.H, p.B * nc), MMA_THREADS, chunk_state_smem(p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<<<dim3((unsigned)((pn + PASS_THREADS - 1) / PASS_THREADS), p.H, p.B), PASS_THREADS,
                   0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan<<<dim3(p.H, p.B * nc, n_it * n_pt), MMA_THREADS, chunk_scan_smem(p.N, p.cl),
                   stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are float32. Strides are in elements; the last dims of x, B, C and y
// must be contiguous. For bfloat16, the base pointers of x, B and C and
// their other strides must be 16-byte aligned and P and N multiples of 8 (the
// wrapper checks), and `scratch` holds B * nc * H * (P * N + 1) floats, nc =
// ceil(S / cl); float32 takes no scratch. `device` is the ordinal the
// tensors live on and `stream` one of its streams; the launches make it the
// thread's current device of the CUDA runtime this library is linked
// against (with -cudart shared, PyTorch's) and then restore the previous
// one. Returns the first failing launch's cudaError_t (0 = success).
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    void* y, void* fin, void* scratch, int dtype, int device,
    int B, int S, int H, int P, int N, int cl,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N || cl < 1 || cl > S)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const long long nc = (S + cl - 1) / cl;
  float* states = static_cast<float*>(scratch);
  float* chunk_sum = states ? states + (long long)B * nc * H * P * N : nullptr;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
           y, static_cast<float*>(fin), states, chunk_sum,
           B, S, H, P, N, cl,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(p, device, st);
  if (dtype == 1) return (int)launch_bf16(p, device, st);
  return (int)cudaErrorInvalidValue;
}
