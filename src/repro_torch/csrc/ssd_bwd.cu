// Mamba2 SSD chunked scan backward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// The reference has no kernel to replace here: its Pallas scan
// (`src/repro/kernels/ssd.py:_kernel`) has no VJP, and the reference trains
// through XLA's autodiff of the oracle `src/repro/models/ssm.py:ssd_reference`.
// This is the gradient of the port's scan (`csrc/ssd.cu`), from a zero
// initial state. Per (batch, head), over chunks of length cl, with a_t =
// dt_t A, cum the inclusive prefix sum of a inside the chunk (L its last
// real row), u_j = dt_j x_j, h the state entering the chunk and g the
// gradient of the state leaving it:
//
//   g_{c-1} = e^{cum_L} g_c + sum_i e^{cum_i} dy_i C_i^T      (reverse pass)
//   du_j    = sum_{i >= j} (C_i . B_j) e^{cum_i - cum_j} dy_i + e^{cum_L - cum_j} g B_j
//   dC_i   += sum_{j <= i} e^{cum_i - cum_j} (dy_i . u_j) B_j + e^{cum_i} h^T dy_i
//   dB_j   += sum_{i >= j} e^{cum_i - cum_j} (dy_i . u_j) C_i + e^{cum_L - cum_j} g^T u_j
//   dx = dt du, and the gradient of cum_t is C_t . dC_t (this head's part)
//   - u_t . du_t, plus <g, state leaving the chunk> at t = L; da is its
//   reverse prefix sum in the chunk, ddt = x . du + A da, dA = sum dt da.
//
// B and C are shared by the heads (n_groups = 1), so dB and dC are sums over
// the heads, and dA a sum over batch and sequence. Every sum is taken in a
// fixed order and no launch uses atomics: two launches on the same inputs
// agree bit for bit. A ragged last chunk is masked: rows >= S are not loaded
// and not stored.
//
// What bounds it on this card: its least work (over each chunk's causal
// pairs C B^T and the head-summed dB and dC products, N each, and per head
// dy x^T and du, P each; per row and head the state terms, P N each) at the
// bf16 tensor-core peak, against each input read once and each gradient
// written once. At mamba2-1.3b's training shapes (B=4, S=2048, H=64, P=64,
// N=128, chunk 256) the two are about even, some 0.06 ms on an H100 SXM.
//
// bf16, the trained path ("mma.sync-split"): every product on the tensor
// cores, mma.sync.m16n8k16 with bf16 operands and f32 sums, fed by ldmatrix
// from bf16 tiles that 16-byte cp.async copies fill (rows padded by 16
// bytes), the streamed tiles double-buffered. Precision: a product of bf16
// inputs (C B^T, dy x^T, B g^T's B, ...) is exact term by term. An f32
// operand (the decayed scores W1, the head-summed W2, the states h and g,
// the weighted rows of the chunk states) is split into a bf16 hi part and a
// bf16 lo part, and each product that takes it is issued twice into one f32
// sum: about 16 bits of the operand, where one bf16 rounding costs tens of
// bf16 ulps in the gradients. A factor that belongs to a row of the output
// goes on the accumulator instead (dt_j on dy x^T, the decays on the state
// terms), so u = dt x is never rounded. Since B and C are shared by the
// heads, the chunk-local parts of dB and dC depend on W2^ = sum_h W2_h only,
// with W2_h[i][j] = (dy_i . x_j) dt_j e^{cum_i - cum_j} and G = C B^T:
//
//   dC_i = sum_{j <= i} W2^[i][j] B_j + sum_h e^{cum_i} h^T dy_i
//   dB_j = sum_{i >= j} W2^[i][j] C_i + sum_h e^{cum_L - cum_j} dt_j g^T x_j
//
// (the decays and dt are each head's), which takes the N-wide products out
// of the head loop. The gradient of cum_t per head is rowsum_t(W2_h o G) -
// colsum_t(W2_h o G) + e^{cum_t} C_t . (h^T dy_t) - dt_t x_t . du_t's state
// part, and at t = L it adds <g, state leaving the chunk> written as
// e^{cum_L} <g, h> + sum_j dt_j x_j . du_j's state part: the terms that
// cancel in the reverse prefix sum are then the same f32 numbers, rather
// than two roundings of one value at the split products' precision (which
// puts dA above 1e-4 of the f32 formulas). Six launches, each checked:
//  1. ssd_bwd_chunk_state_mma, 8 warps a CTA per (batch, chunk, head):
//     warps 0-3 the chunk's own state sum_j e^{cum_L - cum_j} u_j B_j^T,
//     warps 4-7 its sum_i e^{cum_i} dy_i C_i^T, (P, N) each in f32 scratch,
//     the weighted rows split hi + lo; and the chunk's cum and dt rows for
//     the launches below.
//  2. ssd_bwd_state_pass<true>, a CTA per (batch, head): the passes of the
//     f32 form, writing h and g split into bf16 hi + lo, and <g, h>.
//  3. ssd_bwd_scores, a CTA per (batch, chunk, pair of 64-row tiles i >= j):
//     G = C_i B_j^T once, kept in registers and written out in f32; then the
//     heads in order: W2_h from dy_i x_j^T, summed into W2^ in registers,
//     and the row and column sums of W2_h o G; W2^ written as bf16 hi + lo.
//  4. ssd_bwd_dx_mma, a CTA per (batch, chunk, head, 64-row tile j), the
//     tiles with the most to their right first: du = e^{cum_L - cum_j} B_j
//     g^T (the state part, and x . du there), then du += W1^T dy_i over the
//     tiles i >= j, W1 = G e^{cum_i - cum_j} split hi + lo; writes dx and
//     x . du.
//  5. ssd_bwd_dbdc, a CTA per (batch, chunk, 64-row tile, 64-column block
//     of N, dB or dC): W2^ (or its transpose) times B_j (or C_i) over the
//     tiles, then the heads in order: dy h (or x g) from the split states,
//     each row scaled and summed; dB or dC written once in bf16, and for dC
//     each head's e^{cum_i} C_i . (h^T dy_i) over the block.
//  6. ssd_bwd_finish_mma, a CTA per head, a warp per chunk (of all
//     batches, in a fixed assignment): sums the partial row terms, the
//     reverse prefix sum by a warp scan, ddt, and dA by a fixed-order block
//     sum of the lanes' parts.
// The f32 scratch holds the states, the split states, G, W2^ and the row
// partials, about 0.3 GB at mamba2's training shape, where the f32 form's
// per-head dB and dC partials alone take 0.54 GB. At that shape the six
// launches take about 1.55 ms on an H100 SXM at 700 W (FMA tiles like the
// f32 form's took 19.9 ms), some 24 times the bound: what holds them back next is the traffic
// of the re-read tiles (x, dy and the split states once per 64-row tile,
// G once per head), about 2.5 GB a call by count, and the short pipelines
// that walk the heads one at a time with one tile in flight.
//
// f32, the parity path ("fma-f32"): FMA tiles from shared memory, the f32
// formulas above, in six launches:
//  1. ssd_bwd_chunk_state, a CTA per (batch, chunk, head): the chunk's own
//     state and dy C^T sum, and cum_L, into f32 scratch; 4 x 8 tiles a thread.
//  2. ssd_bwd_state_pass<false>, a CTA per (batch, head): the states in order
//     (the state entering each chunk over the chunk's own), then the
//     gradients in reverse (g_c over the chunk's dy C^T sum), and <g_c, state
//     leaving c> by a fixed-order block sum.
//  3. ssd_bwd_dx, a CTA per (batch, chunk, head, 64-row tile j): walks the
//     row tiles i >= j, forms W1 = (C B^T) e^{..} and W2 = (dy u^T) e^{..} in
//     shared memory (64 x 64, masked), accumulates du += W1^T dy and
//     dB += W2^T C in registers, then adds the state terms from g; writes dx,
//     x . du per row and this head's dB.
//  4. ssd_bwd_dc, a CTA per (batch, chunk, head, 64-row tile i): walks the
//     tiles j <= i, dC += W2 B, then the state term from h; writes this
//     head's dC and C . dC per row.
//  5. ssd_bwd_finish, a CTA per head: walks batch and chunks in order, the
//     reverse prefix sum of C . dC - u . du (+ <g, state leaving> at L) by
//     a block scan, ddt, and dA by a fixed-order block sum.
//  6. ssd_bwd_sum_heads, a thread per (batch, row, state column): dB and dC
//     summed over the heads in order.
// P is at most 64 (one tile of rows of g and h) and N at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "tensor_core.cuh"

namespace {

constexpr int TILE = 64;     // chunk rows of a tile
constexpr int THREADS = 256;  // 16 x 16: a thread owns 4 rows (4 ty + k) and columns tx + 16 m
constexpr int WARPS = THREADS / 32;
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int WS = TILE + 4;  // row stride of a 64 x 64 weight tile: a warp's two row groups sit 16 banks apart
constexpr int PASS_ELEMS = MAX_P * MAX_N / THREADS;  // state elements a thread carries in the pass
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
// the tensor-core form
constexpr int MMA_THREADS = 128;  // one warpgroup: warp w owns rows 16 w .. 16 w + 15 of a tile
constexpr int LDT = TILE + 8;     // bf16 row of a 64-column tile, padded by 16 bytes
constexpr int LDG = TILE + 4;     // f32 row of a staged G tile
constexpr int NBLK = 64;          // state columns of a dB / dC CTA
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dfinal;  // (B, H, P, N) f32 contiguous, or null for zero
  void* dx;             // (B, S, H, P) contiguous, x's dtype
  float* ddt;           // (B, S, H) contiguous
  float* dA;            // (H,)
  void* dB;             // (B, S, N) contiguous, B's dtype
  void* dC;             // (B, S, N) contiguous, C's dtype
  // (B, nc, H, P, N): each chunk's own state and its dy C^T sum; the f32
  // form writes over them the state entering the chunk and g
  float* states;
  float* gstate;
  float* chunk_sum;  // (B, nc, H): cum at the chunk's last row
  float* gh;         // (B, nc, H): <g, state leaving the chunk> (bf16 form: <g, state entering it>)
  float* xdu;        // (B, S, H): x . du
  // the f32 form's
  float* dBp;        // (B, S, H, N): each head's dB
  float* dCp;        // (B, S, H, N): each head's dC
  float* cdc;        // (B, S, H): C . dC, this head's part
  // the bf16 form's
  __nv_bfloat16* hsplit;  // (B, nc, H, 2, P, N): h, the state entering the chunk, hi then lo
  __nv_bfloat16* gsplit;  // (B, nc, H, 2, P, N): g, hi then lo
  float* cum;    // (B, nc, H, CLP): cum per chunk row, the last real row's past the end
  float* dts;    // (B, nc, H, CLP): dt per chunk row, 0 past the end
  float* G;      // (B, nc, CLP, CLP): C_i . B_j over the tile pairs j <= i
  __nv_bfloat16* w2;  // (B, nc, 2, CLP, CLP): W2^ = sum_h W2_h, hi then lo
  float* rsum;   // (B, nc, NT, H, CLP): row sums of W2_h o G over j-tile jt
  float* csum;   // (B, nc, NT, H, CLP): column sums of W2_h o G over i-tile it
  float* cst;    // (B, nc, NNB, H, CLP): e^{cum_i} C_i . (h^T dy_i) over N block nb
  float* xds;    // (B, S, H): x . du's state part
  int B, S, H, P, N, cl, nc;
  int CLP, NT, NNB;  // chunk rows padded to a tile, tiles a chunk, N blocks
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the sum over the 16 lanes tx of one row group (lanes 0-15 or 16-31); every
// lane of the warp calls it
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the block's sum of v, in a fixed order, valid in thread 0; all threads
// call it, and it ends with a barrier
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) total += red[w];
  __syncthreads();
  return total;
}

// inclusive prefix sums of val(k) over k in [0, n), THREADS values a round;
// out(k, sum) for each k. All threads call it; it ends with a barrier.
template <typename Val, typename Out>
__device__ void block_scan(int n, float* wsum, Val val, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int k0 = 0; k0 < n; k0 += THREADS) {
    const int k = k0 + threadIdx.x;
    float v = k < n ? val(k) : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    if (k < n) out(k, v + before);
    for (int w = 0; w < WARPS; ++w) carry += wsum[w];
    __syncthreads();  // wsum is rewritten by the next round
  }
}

// cum_s[r] = a sum_{k <= r} dt[t0 + k] and dt_s[r] = dt[t0 + r] for r < len;
// for len <= r < n_pad, dt_s[r] = 0 and cum_s[r] = cum_s[len - 1]. Every
// kernel computes a chunk's sums by this one function, so they agree.
__device__ void chunk_cum(float* cum_s, float* dt_s, float* wsum, const float* dtg, long long dt_ss,
                          int t0, int len, int n_pad, float a) {
  block_scan(
      len, wsum,
      [&](int r) {
        const float d = dtg[(long long)(t0 + r) * dt_ss];
        dt_s[r] = d;
        return d * a;
      },
      [&](int r, float v) { cum_s[r] = v; });
  const float last = cum_s[len - 1];
  for (int r = len + threadIdx.x; r < n_pad; r += THREADS) {
    cum_s[r] = last;
    dt_s[r] = 0.f;
  }
  __syncthreads();
}

// rows [r0, r0 + TILE) of an (S, ncols) matrix with row stride ss, real
// below `rows`, into a TILE x ld f32 tile; the rest zero
__device__ __forceinline__ void load_rows(float* dst, int ld_, const float* src, long long ss, int r0,
                                          int rows, int ncols) {
  for (int e = threadIdx.x; e < TILE * ncols; e += THREADS) {
    const int r = e / ncols, col = e % ncols;
    dst[r * ld_ + col] = r < rows ? src[(long long)(r0 + r) * ss + col] : 0.f;
  }
}

// -- the f32 form: FMA tiles -------------------------------------------------------

// -- 1. the chunk's own states ----------------------------------------------------

size_t chunk_state_smem(int P, int N, int cl) {
  return sizeof(float) * (2 * (size_t)round_up(cl, TILE) + WARPS + 2 * TILE * P + 2 * TILE * N);
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_state(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int CLP = round_up(p.cl, TILE), P = p.P, N = p.N;
  float* cum_s = smem;
  float* dt_s = cum_s + CLP;
  float* wsum = dt_s + CLP;
  float* u_s = wsum + WARPS;     // [TILE][P]: e^{cum_L - cum_j} u_j
  float* e_s = u_s + TILE * P;   // [TILE][P]: e^{cum_i} dy_i
  float* b_s = e_s + TILE * P;   // [TILE][N]
  float* c_s = b_s + TILE * N;   // [TILE][N]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0);
  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dyg = static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.c_sb;

  chunk_cum(cum_s, dt_s, wsum, p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, t0, len, CLP, p.A[h]);
  const float cum_last = cum_s[len - 1];

  const int nq = (N + 15) / 16;
  float acc_s[4][MAX_N / 16], acc_g[4][MAX_N / 16];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) acc_s[k][q] = acc_g[k][q] = 0.f;

  for (int j0 = 0; j0 < len; j0 += TILE) {
    const int jn = min(TILE, len - j0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < TILE * P; e += THREADS) {
      const int r = e / P, col = e % P;
      float uv = 0.f, ev = 0.f;
      if (r < jn) {
        const int j = j0 + r;
        const long long t = t0 + j;
        uv = xg[t * p.x_ss + col] * dt_s[j] * expf(cum_last - cum_s[j]);
        ev = dyg[t * p.dy_ss + col] * expf(cum_s[j]);
      }
      u_s[e] = uv;
      e_s[e] = ev;
    }
    load_rows(b_s, N, bg, p.b_ss, t0 + j0, jn, N);
    load_rows(c_s, N, cg, p.c_ss, t0 + j0, jn, N);
    __syncthreads();
    for (int r = 0; r < jn; ++r) {
      float uv[4], ev[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pr = 4 * ty + k;
        uv[k] = pr < P ? u_s[r * P + pr] : 0.f;
        ev[k] = pr < P ? e_s[r * P + pr] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        if (q < nq) {
          const int n = tx + 16 * q;
          const float bv = n < N ? b_s[r * N + n] : 0.f;
          const float cv = n < N ? c_s[r * N + n] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc_s[k][q] = fmaf(uv[k], bv, acc_s[k][q]);
            acc_g[k][q] = fmaf(ev[k], cv, acc_g[k][q]);
          }
        }
      }
    }
  }

  const long long base = ((long long)bc * p.H + h) * P * N;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int pr = 4 * ty + k;
    if (pr >= P) continue;
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) {
      const int n = tx + 16 * q;
      if (q < nq && n < N) {
        p.states[base + pr * N + n] = acc_s[k][q];
        p.gstate[base + pr * N + n] = acc_g[k][q];
      }
    }
  }
  if (tid == 0) p.chunk_sum[(long long)bc * p.H + h] = cum_last;
}

// -- 2. the state passes (both forms) ----------------------------------------------

// one state element v as a bf16 hi part at dst[e] and lo part at dst[PN + e]
__device__ __forceinline__ void store_split(__nv_bfloat16* dst, int PN, int e, float v) {
  const __nv_bfloat16 hi = __float2bfloat16(v);
  dst[e] = hi;
  dst[PN + e] = __float2bfloat16(v - __bfloat162float(hi));
}

// f32 form (SPLIT false): the entering states and g written in place over the
// chunk's own sums, gh = <g, state leaving the chunk>. bf16 form: h and g
// written split into bf16 hi + lo (the own sums are kept), gh = <g, state
// entering the chunk> from the split h as it is read back.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_pass(Params p) {
  __shared__ float red[WARPS];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int PN = p.P * p.N;
  // each chunk's elements are all loaded before any is stored, so the loads
  // of a chunk are in flight together
  float s[PASS_ELEMS], g[PASS_ELEMS], own[PASS_ELEMS], ent[PASS_ELEMS];
#pragma unroll
  for (int k = 0; k < PASS_ELEMS; ++k) s[k] = 0.f;

  // in order: the state entering chunk c over chunk c's own
  for (int c = 0; c < p.nc; ++c) {
    const long long bch = ((long long)b * p.nc + c) * p.H + h;
    const float decay = expf(p.chunk_sum[bch]);
    float* __restrict__ st = p.states + bch * PN;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      own[k] = e < PN ? st[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      if (e < PN) {
        if (SPLIT)
          store_split(p.hsplit + bch * 2 * PN, PN, e, s[k]);
        else
          st[e] = s[k];
      }
      s[k] = fmaf(s[k], decay, own[k]);
    }
  }
  // s is the final state; g its gradient
#pragma unroll
  for (int k = 0; k < PASS_ELEMS; ++k) {
    const int e = tid + THREADS * k;
    g[k] = (e < PN && p.dfinal) ? p.dfinal[((long long)b * p.H + h) * PN + e] : 0.f;
  }
  // in reverse: s holds the state leaving chunk c and g its gradient
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long bch = ((long long)b * p.nc + c) * p.H + h;
    const float decay = expf(p.chunk_sum[bch]);
    const float* __restrict__ st = p.states + bch * PN;
    const __nv_bfloat16* __restrict__ hs = SPLIT ? p.hsplit + bch * 2 * PN : nullptr;
    float* __restrict__ gs = p.gstate + bch * PN;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      own[k] = e < PN ? gs[e] : 0.f;
      if (SPLIT)
        ent[k] = e < PN ? __bfloat162float(hs[e]) + __bfloat162float(hs[PN + e]) : 0.f;
      else
        ent[k] = e < PN ? st[e] : 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) dot = fmaf(g[k], SPLIT ? ent[k] : s[k], dot);
    dot = block_sum(dot, red);
    if (tid == 0) p.gh[bch] = dot;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      if (e < PN) {
        if (SPLIT)
          store_split(p.gsplit + bch * 2 * PN, PN, e, g[k]);
        else
          gs[e] = g[k];
      }
      g[k] = fmaf(g[k], decay, own[k]);
      s[k] = ent[k];
    }
  }
}

// -- 3 and 4. the chunk-local gradients --------------------------------------------

// W1[i][j] = (C_i . B_j) e^{cum_i - cum_j} (with `cb`) and W2[i][j] = (dy_i .
// u_j) e^{cum_i - cum_j} for chunk rows j <= i < len, else 0; tile rows i from
// c_s and y_s (chunk row i0 + i), columns j from b_s and u_s (chunk row
// j0 + j). Thread (ty, tx) computes rows 4 ty + k and columns tx + 16 m.
template <bool cb>
__device__ __forceinline__ void weights(float* w1_s, float* w2_s, const float* c_s,
                                        const float* y_s, const float* b_s, const float* u_s,
                                        const float* cum_s, int NS, int PS, int N, int P, int i0,
                                        int j0, int len) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s1[4][4], s2[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) s1[k][m] = s2[k][m] = 0.f;
  if (cb) {
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cv[k] = c_s[(4 * ty + k) * NS + n];
#pragma unroll
      for (int m = 0; m < 4; ++m) bv[m] = b_s[(tx + 16 * m) * NS + n];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) s1[k][m] = fmaf(cv[k], bv[m], s1[k][m]);
    }
  }
  for (int pp = 0; pp < P; ++pp) {
    float yv[4], uv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) yv[k] = y_s[(4 * ty + k) * PS + pp];
#pragma unroll
    for (int m = 0; m < 4; ++m) uv[m] = u_s[(tx + 16 * m) * PS + pp];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) s2[k][m] = fmaf(yv[k], uv[m], s2[k][m]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + 4 * ty + k;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = j0 + tx + 16 * m;
      const float e = (j <= i && i < len) ? expf(cum_s[i] - cum_s[j]) : 0.f;
      if (cb) w1_s[(4 * ty + k) * WS + tx + 16 * m] = s1[k][m] * e;
      w2_s[(4 * ty + k) * WS + tx + 16 * m] = s2[k][m] * e;
    }
  }
}

size_t dx_smem(int P, int N, int cl) {
  return sizeof(float) * (2 * (size_t)round_up(cl, TILE) + WARPS + 2 * TILE * (N | 1) +
                          2 * TILE * (P | 1) + 2 * TILE * WS);
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_dx(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int CLP = round_up(p.cl, TILE), P = p.P, N = p.N;
  const int NS = N | 1, PS = P | 1;  // odd row strides: a column walk hits 16 distinct banks
  float* cum_s = smem;
  float* dt_s = cum_s + CLP;
  float* wsum = dt_s + CLP;
  float* b_s = wsum + WARPS;     // [TILE][NS]: B_j
  float* u_s = b_s + TILE * NS;  // [TILE][PS]: u_j
  float* c_s = u_s + TILE * PS;  // [TILE][NS]: C_i, then g as P rows of N
  float* y_s = c_s + TILE * NS;  // [TILE][PS]: dy_i
  float* w1_s = y_s + TILE * PS;  // [TILE][WS]
  float* w2_s = w1_s + TILE * WS;  // [TILE][WS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int jt = blockIdx.x, h = blockIdx.y, bc = blockIdx.z, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), j0 = jt * TILE;
  if (j0 >= len) return;  // past a ragged last chunk
  const int jn = min(TILE, len - j0);
  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dyg = static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.c_sb;

  chunk_cum(cum_s, dt_s, wsum, p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, t0, len, CLP, p.A[h]);
  const float cum_last = cum_s[len - 1];
  load_rows(b_s, NS, bg, p.b_ss, t0 + j0, jn, N);
  for (int e = tid; e < TILE * P; e += THREADS) {
    const int r = e / P, col = e % P;
    u_s[r * PS + col] = r < jn ? xg[(long long)(t0 + j0 + r) * p.x_ss + col] * dt_s[j0 + r] : 0.f;
  }

  const int nq = (N + 15) / 16, npc = (P + 15) / 16;
  float du[4][MAX_P / 16], db[4][MAX_N / 16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int m = 0; m < MAX_P / 16; ++m) du[k][m] = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) db[k][q] = 0.f;
  }

  const int n_it = (len + TILE - 1) / TILE;
  for (int it = jt; it < n_it; ++it) {
    const int i0 = it * TILE, in_ = min(TILE, len - i0);
    __syncthreads();  // the last tile's readers are done (and B_j, u_j are in)
    load_rows(c_s, NS, cg, p.c_ss, t0 + i0, in_, N);
    load_rows(y_s, PS, dyg, p.dy_ss, t0 + i0, in_, P);
    __syncthreads();
    weights<true>(w1_s, w2_s, c_s, y_s, b_s, u_s, cum_s, NS, PS, N, P, i0, j0, len);
    __syncthreads();
    // du += W1^T dy, dB += W2^T C over this tile's rows i
    for (int i = 0; i < in_; ++i) {
      const float4 a1 = *reinterpret_cast<const float4*>(w1_s + i * WS + 4 * ty);
      const float4 a2 = *reinterpret_cast<const float4*>(w2_s + i * WS + 4 * ty);
      const float w1[4] = {a1.x, a1.y, a1.z, a1.w}, w2[4] = {a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int m = 0; m < MAX_P / 16; ++m) {
        if (m < npc) {
          const int col = tx + 16 * m;
          const float yv = col < P ? y_s[i * PS + col] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) du[k][m] = fmaf(w1[k], yv, du[k][m]);
        }
      }
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        if (q < nq) {
          const int n = tx + 16 * q;
          const float cv = n < N ? c_s[i * NS + n] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) db[k][q] = fmaf(w2[k], cv, db[k][q]);
        }
      }
    }
  }

  // the state terms: e^{cum_L - cum_j} g B_j into du, e^{cum_L - cum_j} g^T u_j into dB
  __syncthreads();  // every reader of c_s is done
  const float* gg = p.gstate + ((long long)bc * p.H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) c_s[(e / N) * NS + e % N] = gg[e];
  __syncthreads();
  float sj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + 4 * ty + k;
    sj[k] = j < len ? expf(cum_last - cum_s[j]) : 0.f;
  }
  for (int n = 0; n < N; ++n) {
    float bv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) bv[k] = b_s[(4 * ty + k) * NS + n] * sj[k];
#pragma unroll
    for (int m = 0; m < MAX_P / 16; ++m) {
      if (m < npc) {
        const int col = tx + 16 * m;
        const float gv = col < P ? c_s[col * NS + n] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) du[k][m] = fmaf(bv[k], gv, du[k][m]);
      }
    }
  }
  for (int pp = 0; pp < P; ++pp) {
    float uv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) uv[k] = u_s[(4 * ty + k) * PS + pp] * sj[k];
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) {
      if (q < nq) {
        const int n = tx + 16 * q;
        const float gv = n < N ? c_s[pp * NS + n] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) db[k][q] = fmaf(uv[k], gv, db[k][q]);
      }
    }
  }

  // dx = dt du, x . du per row, this head's dB
  float* dxg = static_cast<float*>(p.dx);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * ty + k, j = j0 + r;
    const bool row = r < jn;
    const long long t = t0 + j;
    const long long bth = ((long long)b * p.S + t) * p.H + h;
    float xd = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_P / 16; ++m) {
      const int col = tx + 16 * m;
      if (row && m < npc && col < P) {
        xd = fmaf(xg[t * p.x_ss + col], du[k][m], xd);
        dxg[bth * P + col] = dt_s[j] * du[k][m];
      }
    }
    xd = row_group_sum(xd);
    if (row && tx == 0) p.xdu[bth] = xd;
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) {
      const int n = tx + 16 * q;
      if (row && q < nq && n < N) p.dBp[bth * N + n] = db[k][q];
    }
  }
}

size_t dc_smem(int P, int N, int cl) {
  return sizeof(float) * (2 * (size_t)round_up(cl, TILE) + WARPS + 2 * TILE * (N | 1) +
                          2 * TILE * (P | 1) + TILE * WS);
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_dc(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int CLP = round_up(p.cl, TILE), P = p.P, N = p.N;
  const int NS = N | 1, PS = P | 1;
  float* cum_s = smem;
  float* dt_s = cum_s + CLP;
  float* wsum = dt_s + CLP;
  float* c_s = wsum + WARPS;     // [TILE][NS]: C_i
  float* y_s = c_s + TILE * NS;  // [TILE][PS]: dy_i
  float* b_s = y_s + TILE * PS;  // [TILE][NS]: B_j, then h as P rows of N
  float* u_s = b_s + TILE * NS;  // [TILE][PS]: u_j
  float* w2_s = u_s + TILE * PS;  // [TILE][WS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int it = blockIdx.x, h = blockIdx.y, bc = blockIdx.z, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), i0 = it * TILE;
  if (i0 >= len) return;  // past a ragged last chunk
  const int in_ = min(TILE, len - i0);
  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dyg = static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.c_sb;

  chunk_cum(cum_s, dt_s, wsum, p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, t0, len, CLP, p.A[h]);
  load_rows(c_s, NS, cg, p.c_ss, t0 + i0, in_, N);
  load_rows(y_s, PS, dyg, p.dy_ss, t0 + i0, in_, P);

  const int nq = (N + 15) / 16;
  float dc[4][MAX_N / 16];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) dc[k][q] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TILE, jn = min(TILE, len - j0);
    __syncthreads();  // the last tile's readers are done (and C_i, dy_i are in)
    load_rows(b_s, NS, bg, p.b_ss, t0 + j0, jn, N);
    for (int e = tid; e < TILE * P; e += THREADS) {
      const int r = e / P, col = e % P;
      u_s[r * PS + col] =
          r < jn ? xg[(long long)(t0 + j0 + r) * p.x_ss + col] * dt_s[j0 + r] : 0.f;
    }
    __syncthreads();
    weights<false>(nullptr, w2_s, c_s, y_s, b_s, u_s, cum_s, NS, PS, N, P, i0, j0, len);
    __syncthreads();
    // dC += W2 B over this tile's rows j
    for (int j = 0; j < jn; ++j) {
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = w2_s[(4 * ty + k) * WS + j];
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        if (q < nq) {
          const int n = tx + 16 * q;
          const float bv = n < N ? b_s[j * NS + n] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) dc[k][q] = fmaf(w[k], bv, dc[k][q]);
        }
      }
    }
  }

  if (c > 0) {  // e^{cum_i} h^T dy_i, h the state entering the chunk (zero for the first)
    __syncthreads();  // every reader of b_s is done
    const float* hs = p.states + ((long long)bc * p.H + h) * P * N;
    for (int e = tid; e < P * N; e += THREADS) b_s[(e / N) * NS + e % N] = hs[e];
    __syncthreads();
    float si[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 4 * ty + k;
      si[k] = i < len ? expf(cum_s[i]) : 0.f;
    }
    for (int pp = 0; pp < P; ++pp) {
      float yv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) yv[k] = y_s[(4 * ty + k) * PS + pp] * si[k];
#pragma unroll
      for (int q = 0; q < MAX_N / 16; ++q) {
        if (q < nq) {
          const int n = tx + 16 * q;
          const float hv = n < N ? b_s[pp * NS + n] : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) dc[k][q] = fmaf(yv[k], hv, dc[k][q]);
        }
      }
    }
  }

  // this head's dC, and C . dC per row
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * ty + k;
    const bool row = r < in_;
    const long long bth = ((long long)b * p.S + t0 + i0 + r) * p.H + h;
    float cd = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_N / 16; ++q) {
      const int n = tx + 16 * q;
      if (row && q < nq && n < N) {
        p.dCp[bth * N + n] = dc[k][q];
        cd = fmaf(c_s[r * NS + n], dc[k][q], cd);
      }
    }
    cd = row_group_sum(cd);
    if (row && tx == 0) p.cdc[bth] = cd;
  }
}

// -- 5. ddt and dA ---------------------------------------------------------------

// the bf16 form's gradient of cum at chunk row r of head h, but for -dt x .
// du's state part and the last row's term: the row sums of W2 o G over the
// j tiles up to r's, minus the column sums over the i tiles from r's on,
// plus e^{cum_r} C_r . (h^T dy_r) over the N blocks, each in order
__device__ __forceinline__ float row_terms(const Params& p, int bc, int h, int r, int len) {
  const int tile = r / TILE, nt = (len + TILE - 1) / TILE;
  const long long hc = (long long)p.H * p.CLP;
  const long long base = (long long)bc * p.NT * hc + (long long)h * p.CLP + r;
  float v = 0.f;
  for (int jt = 0; jt <= tile; ++jt) v += p.rsum[base + jt * hc];
  for (int it = tile; it < nt; ++it) v -= p.csum[base + it * hc];
  const long long cb = (long long)bc * p.NNB * hc + (long long)h * p.CLP + r;
  for (int nb = 0; nb < p.NNB; ++nb) v += p.cst[cb + nb * hc];
  return v;
}

// f32 form: a CTA per head walks batch and chunks in order, a block scan a
// chunk
__global__ void __launch_bounds__(THREADS) ssd_bwd_finish(Params p) {
  __shared__ float wsum[WARPS], red[WARPS];
  const int h = blockIdx.x;
  const float a = p.A[h];
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b) {
    const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
    for (int c = 0; c < p.nc; ++c) {
      const int t0 = c * p.cl, len = min(p.cl, p.S - t0);
      const float last = p.gh[((long long)b * p.nc + c) * p.H + h];
      // da_t = sum_{r >= t} dcum_r: scan index k is chunk row len - 1 - k
      block_scan(
          len, wsum,
          [&](int k) {
            const long long t = t0 + len - 1 - k;
            const long long bth = ((long long)b * p.S + t) * p.H + h;
            const float v = p.cdc[bth] - dtg[t * p.dt_ss] * p.xdu[bth];
            return k == 0 ? v + last : v;
          },
          [&](int k, float da) {
            const long long t = t0 + len - 1 - k;
            const long long bth = ((long long)b * p.S + t) * p.H + h;
            p.ddt[bth] = fmaf(a, da, p.xdu[bth]);
            acc = fmaf(dtg[t * p.dt_ss], da, acc);
          });
    }
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) p.dA[h] = acc;
}

// bf16 form: a CTA per head, warp w taking chunks w, w + 8, ... of all
// batches, 32 rows a round; each lane keeps its part of dA, and the block
// sums them in a fixed order
__global__ void __launch_bounds__(THREADS) ssd_bwd_finish_mma(Params p) {
  __shared__ float red[WARPS];
  const int h = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a = p.A[h];
  float acc = 0.f;
  for (int bc = warp; bc < p.B * p.nc; bc += WARPS) {
    const int b = bc / p.nc, c = bc % p.nc, t0 = c * p.cl, len = min(p.cl, p.S - t0);
    const long long bch = (long long)bc * p.H + h;
    const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
    const float* xds = p.xds + (long long)b * p.S * p.H + h;
    // <g, state leaving> = e^{cum_L} <g, h> + sum_j dt_j x_j . du_j's state part
    float sx = 0.f;
    for (int r = lane; r < len; r += 32)
      sx = fmaf(dtg[(long long)(t0 + r) * p.dt_ss], xds[(long long)(t0 + r) * p.H], sx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sx += __shfl_xor_sync(FULL, sx, off);
    const float last = fmaf(expf(p.chunk_sum[bch]), p.gh[bch], sx);
    // da_t = sum_{r >= t} dcum_r: scan index k is chunk row len - 1 - k
    float carry = 0.f;
    for (int k0 = 0; k0 < len; k0 += 32) {
      const int k = k0 + lane, r = len - 1 - k;
      const long long t = t0 + r;
      float d = 0.f, v = 0.f;
      if (k < len) {
        d = dtg[t * p.dt_ss];
        v = row_terms(p, bc, h, r, len) - d * xds[t * p.H];
        if (k == 0) v += last;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += up;
      }
      const float da = v + carry;
      if (k < len) {
        const long long bth = ((long long)b * p.S + t) * p.H + h;
        p.ddt[bth] = fmaf(a, da, p.xdu[bth]);
        acc = fmaf(d, da, acc);
      }
      carry += __shfl_sync(FULL, v, 31);
    }
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) p.dA[h] = acc;
}

// -- 6. dB and dC over the heads ----------------------------------------------------

__global__ void __launch_bounds__(THREADS) ssd_bwd_sum_heads(Params p) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)p.B * p.S * p.N) return;
  const long long bt = e / p.N;
  const int n = (int)(e % p.N);
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < p.H; ++h) {
    const long long i = (bt * p.H + h) * p.N + n;
    sb += p.dBp[i];
    sc += p.dCp[i];
  }
  static_cast<float*>(p.dB)[e] = sb;
  static_cast<float*>(p.dC)[e] = sc;
}

// -- the bf16 form: tensor cores ---------------------------------------------------

// rows [0, nrows) of a row-major bf16 matrix at src (row stride ss elements,
// real rows below `rows` and columns below `ncols`) into a tile of `width`
// columns (a multiple of 8, at most 8 blockDim.x) and row stride ld; the
// rest zero. All threads of the block call it; the copies are asynchronous
// (cp.async, 16 bytes), each thread one column piece of every rstep-th row.
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst, int ld_, int nrows, int width,
                                          const __nv_bfloat16* src, long long ss, int rows,
                                          int ncols) {
  const int tid = threadIdx.x, pieces = width / 8, rstep = blockDim.x / pieces;
  if (tid >= rstep * pieces) return;
  const int col = (tid % pieces) * 8;
  for (int r = tid / pieces; r < nrows; r += rstep) {
    const bool in = r < rows && col < ncols;
    tc::cp_async16(dst + r * ld_ + col, in ? src + r * ss + col : src, in);
  }
}

// n floats (a multiple of 4, 16-byte aligned at both ends), asynchronously
__device__ __forceinline__ void load_f32(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
    tc::cp_async16(dst + 4 * e, src + 4 * e, true);
}

// a packed pair of bf16 values times w0 and w1 in f32, split into hi + lo
__device__ __forceinline__ void scale_split(uint32_t& hi, uint32_t& lo, uint32_t v, float w0,
                                            float w1) {
  const float2 f = tc::unpack_bf16(v);
  tc::split_bf16(hi, lo, f.x * w0, f.y * w1);
}

// the sum over the 4 lanes t of a row of an mma.sync C tile
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// -- 1. the chunk's own states ----------------------------------------------------------

size_t chunk_state_mma_smem(int N, int cl) {
  const size_t ldn = round_up(N, 16) + 8;
  return sizeof(__nv_bfloat16) * 2 * (2 * TILE * LDT + 2 * TILE * ldn) +
         sizeof(float) * (3 * (size_t)round_up(cl, TILE) + WARPS);
}

// warps 0-3: sum_j (e^{cum_L - cum_j} dt_j x_j) B_j^T, warps 4-7: sum_i
// (e^{cum_i} dy_i) C_i^T, each warp 16 rows p of the (P, N) result, the
// weighted rows (the A operand, K = chunk rows) split hi + lo
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_state_mma(Params p) {
  using bf16 = __nv_bfloat16;
  const int NPAD = round_up(p.N, 16), LDN = NPAD + 8, CLP = p.CLP;
  const int STAGE = 2 * TILE * LDT + 2 * TILE * LDN;  // x, dy, B and C rows of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [2][STAGE]
  float* cum_s = reinterpret_cast<float*>(tiles + 2 * STAGE);
  float* w_s = cum_s + CLP;  // dt, then e^{cum_L - cum_j} dt_j
  float* e_s = w_s + CLP;    // e^{cum_i}
  float* wsum = e_s + CLP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0);
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + t0 * p.x_ss;
  const bf16* dyg = static_cast<const bf16*>(p.dy) + b * p.dy_sb + h * p.dy_sh + t0 * p.dy_ss;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb + t0 * p.b_ss;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.c_sb + t0 * p.c_ss;

  auto load = [&](int j0, int stage) {
    bf16* s = tiles + stage * STAGE;
    const int rows = len - j0;
    load_bf16(s, LDT, TILE, TILE, xg + j0 * p.x_ss, p.x_ss, rows, p.P);
    load_bf16(s + TILE * LDT, LDT, TILE, TILE, dyg + j0 * p.dy_ss, p.dy_ss, rows, p.P);
    load_bf16(s + 2 * TILE * LDT, LDN, TILE, NPAD, bg + j0 * p.b_ss, p.b_ss, rows, p.N);
    load_bf16(s + 2 * TILE * LDT + TILE * LDN, LDN, TILE, NPAD, cg + j0 * p.c_ss, p.c_ss, rows,
              p.N);
  };
  load(0, 0);
  tc::cp_async_commit();  // lands while the prefix sum runs

  chunk_cum(cum_s, w_s, wsum, p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, t0, len, CLP, p.A[h]);
  const float cum_last = cum_s[len - 1];
  const long long bch = (long long)bc * p.H + h;
  for (int r = tid; r < CLP; r += THREADS) {  // the chunk's rows for the later launches
    const float d = w_s[r];
    p.cum[bch * CLP + r] = cum_s[r];
    p.dts[bch * CLP + r] = d;
    w_s[r] = r < len ? expf(cum_last - cum_s[r]) * d : 0.f;
    e_s[r] = r < len ? expf(cum_s[r]) : 0.f;
  }
  if (tid == 0) p.chunk_sum[bch] = cum_last;

  const bool gside = warp >= 4;
  const int wr = warp & 3;
  const bool active = 16 * wr < p.P;  // this warp's 16 rows of P
  const float* wt = gside ? e_s : w_s;
  const int NT8 = NPAD / 8;
  float acc[MAX_N / 8][4];
#pragma unroll
  for (int n = 0; n < MAX_N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (len + TILE - 1) / TILE;
  int stage = 0;
  for (int jt = 0; jt < ntiles; ++jt, stage ^= 1) {
    if (jt + 1 < ntiles) load((jt + 1) * TILE, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile has landed, and the weights are written
    const bf16* s = tiles + stage * STAGE;
    const bf16* as = s + (gside ? TILE * LDT : 0);
    const bf16* bs = s + 2 * TILE * LDT + (gside ? TILE * LDN : 0);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks) {
        const int j = jt * TILE + 16 * ks;  // chunk row of this k-step
        if (j >= len) break;
        // A = (w x)^T: P rows by chunk rows, each weighted along its chunk row
        uint32_t a[4], hi[4], lo[4];
        tc::ldsm_x4_trans(a, as + (16 * ks + tc::y_row(lane)) * LDT + 16 * wr + tc::y_col(lane));
        const float w0 = wt[j + 2 * t], w1 = wt[j + 2 * t + 1];
        const float w8 = wt[j + 2 * t + 8], w9 = wt[j + 2 * t + 9];
        scale_split(hi[0], lo[0], a[0], w0, w1);
        scale_split(hi[1], lo[1], a[1], w0, w1);
        scale_split(hi[2], lo[2], a[2], w8, w9);
        scale_split(hi[3], lo[3], a[3], w8, w9);
#pragma unroll
        for (int np = 0; np < MAX_N / 16; ++np) {
          if (2 * np < NT8) {
            uint32_t r[4];
            tc::ldsm_x4_trans(r, bs + (16 * ks + tc::x_row(lane)) * LDN + 16 * np + tc::x_col(lane));
            tc::mma(acc[2 * np], hi, r[0], r[1]);
            tc::mma(acc[2 * np], lo, r[0], r[1]);
            tc::mma(acc[2 * np + 1], hi, r[2], r[3]);
            tc::mma(acc[2 * np + 1], lo, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (!active) return;
  float* out = (gside ? p.gstate : p.states) + bch * p.P * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = 16 * wr + g + 8 * half;
    if (pr >= p.P) continue;
#pragma unroll
    for (int n = 0; n < MAX_N / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (n < NT8 && col < p.N)
        *reinterpret_cast<float2*>(out + pr * p.N + col) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// -- 3. the scores: C B^T once, W2 summed over the heads ------------------------------

size_t scores_smem(int N) {
  const size_t ldn = round_up(N, 16) + 8;
  return sizeof(__nv_bfloat16) * (2 * TILE * ldn + 2 * 2 * TILE * LDT) +
         sizeof(float) * (2 * 3 * TILE + 4 * TILE);
}

__global__ void __launch_bounds__(MMA_THREADS) ssd_bwd_scores(Params p) {
  using bf16 = __nv_bfloat16;
  const int NPAD = round_up(p.N, 16), LDN = NPAD + 8, CLP = p.CLP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LDN]: C_i
  bf16* b_s = c_s + TILE * LDN;                    // [TILE][LDN]: B_j
  bf16* hd_s = b_s + TILE * LDN;                   // [2][2][TILE][LDT]: a head's dy_i and x_j
  // [2][3][TILE]: a head's cum_i, cum_j and dt_j
  float* vec_s = reinterpret_cast<float*>(hd_s + 2 * 2 * TILE * LDT);
  float* red_s = vec_s + 2 * 3 * TILE;             // [4][TILE]: each warp's column sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int q = blockIdx.x, it = 0;  // the pair (it, jt), jt <= it
  while (q > it) {
    q -= it + 1;
    ++it;
  }
  const int jt = q;
  const int bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), i0 = it * TILE, j0 = jt * TILE;
  if (i0 >= len) return;  // past a ragged last chunk
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + (t0 + j0) * p.x_ss;
  const bf16* dyg = static_cast<const bf16*>(p.dy) + b * p.dy_sb + (t0 + i0) * p.dy_ss;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb + (t0 + j0) * p.b_ss;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.c_sb + (t0 + i0) * p.c_ss;

  load_bf16(c_s, LDN, TILE, NPAD, cg, p.c_ss, len - i0, p.N);
  load_bf16(b_s, LDN, TILE, NPAD, bg, p.b_ss, len - j0, p.N);
  tc::cp_async_commit();
  auto load_head = [&](int hh, int stage) {
    bf16* s = hd_s + stage * 2 * TILE * LDT;
    load_bf16(s, LDT, TILE, TILE, dyg + hh * p.dy_sh, p.dy_ss, len - i0, p.P);
    load_bf16(s + TILE * LDT, LDT, TILE, TILE, xg + hh * p.x_sh, p.x_ss, len - j0, p.P);
    float* v = vec_s + stage * 3 * TILE;
    const long long row0 = ((long long)bc * p.H + hh) * CLP;
    load_f32(v, p.cum + row0 + i0, TILE);
    load_f32(v + TILE, p.cum + row0 + j0, TILE);
    load_f32(v + 2 * TILE, p.dts + row0 + j0, TILE);
  };
  load_head(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();  // C_i and B_j are in

  // G = C_i B_j^T: warp w rows 16 w .. 16 w + 15, exact bf16 operands
  float gs[TILE / 8][4];
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) gs[n][0] = gs[n][1] = gs[n][2] = gs[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < MAX_N / 16; ++ks) {
    if (16 * ks >= NPAD) break;
    uint32_t a[4];
    tc::ldsm_x4(a, c_s + (16 * warp + tc::x_row(lane)) * LDN + 16 * ks + tc::x_col(lane));
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      uint32_t r[4];
      tc::ldsm_x4(r, b_s + (16 * np + tc::y_row(lane)) * LDN + 16 * ks + tc::y_col(lane));
      tc::mma(gs[2 * np], a, r[0], r[1]);
      tc::mma(gs[2 * np + 1], a, r[2], r[3]);
    }
  }
  const int il0 = 16 * warp + g;  // this lane's rows of the tile: il0, il0 + 8
  float* gg = p.G + ((long long)bc * CLP + i0) * CLP + j0;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n)
      *reinterpret_cast<float2*>(gg + (long long)(il0 + 8 * half) * CLP + 8 * n + 2 * t) =
          make_float2(gs[n][2 * half], gs[n][2 * half + 1]);

  float w2[TILE / 8][4];
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n) w2[n][0] = w2[n][1] = w2[n][2] = w2[n][3] = 0.f;
  const int KP = round_up(p.P, 16) / 16;
  for (int hh = 0; hh < p.H; ++hh) {
    const int stage = hh & 1;
    if (hh + 1 < p.H) load_head(hh + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this head's tiles are in
    const bf16* dys = hd_s + stage * 2 * TILE * LDT;
    const bf16* xs = dys + TILE * LDT;
    const float* v = vec_s + stage * 3 * TILE;
    // dy_i x_j^T, exact bf16 operands
    float s2[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) s2[n][0] = s2[n][1] = s2[n][2] = s2[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MAX_P / 16; ++ks) {
      if (ks >= KP) break;
      uint32_t a[4];
      tc::ldsm_x4(a, dys + (16 * warp + tc::x_row(lane)) * LDT + 16 * ks + tc::x_col(lane));
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t r[4];
        tc::ldsm_x4(r, xs + (16 * np + tc::y_row(lane)) * LDT + 16 * ks + tc::y_col(lane));
        tc::mma(s2[2 * np], a, r[0], r[1]);
        tc::mma(s2[2 * np + 1], a, r[2], r[3]);
      }
    }
    // W2 = (dy_i x_j^T) dt_j e^{cum_i - cum_j} for j <= i < len; its sum over
    // the heads, and the row and column sums of W2 o G
    float rs[2] = {0.f, 0.f}, cs[TILE / 8][2];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = il0 + 8 * (e >> 1), jl = 8 * n + 2 * t + (e & 1);
        const int i = i0 + il, j = j0 + jl;
        const float w = j <= i && i < len
                            ? s2[n][e] * v[2 * TILE + jl] * exp2f(LOG2E * (v[il] - v[TILE + jl]))
                            : 0.f;
        w2[n][e] += w;
        const float wg = w * gs[n][e];
        rs[e >> 1] += wg;
        cs[n][e & 1] += wg;
      }
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    const long long rrow = (((long long)bc * p.NT + jt) * p.H + hh) * CLP + i0;
    if (t == 0) {
      if (i0 + il0 < len) p.rsum[rrow + il0] = rs[0];
      if (i0 + il0 + 8 < len) p.rsum[rrow + il0 + 8] = rs[1];
    }
    // column sums: over the 8 lanes g of the warp, then over the warps in order
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = cs[n][e];
        s += __shfl_xor_sync(FULL, s, 4);
        s += __shfl_xor_sync(FULL, s, 8);
        s += __shfl_xor_sync(FULL, s, 16);
        if (g == 0) red_s[warp * TILE + 8 * n + 2 * t + e] = s;
      }
    __syncthreads();
    if (tid < TILE && j0 + tid < len)
      p.csum[(((long long)bc * p.NT + it) * p.H + hh) * CLP + j0 + tid] =
          red_s[tid] + red_s[TILE + tid] + red_s[2 * TILE + tid] + red_s[3 * TILE + tid];
    __syncthreads();  // the stage and red_s are rewritten by the next head
  }

  // W2^ as bf16 hi + lo
  bf16* wg = p.w2 + (long long)bc * 2 * CLP * CLP;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      uint32_t hi, lo;
      tc::split_bf16(hi, lo, w2[n][2 * half], w2[n][2 * half + 1]);
      const long long at = (long long)(i0 + il0 + 8 * half) * CLP + j0 + 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(wg + at) = hi;
      *reinterpret_cast<uint32_t*>(wg + (long long)CLP * CLP + at) = lo;
    }
}

// -- 4. dx ----------------------------------------------------------------------------

size_t dx_mma_smem(int N, int cl) {
  const size_t ldn = round_up(N, 16) + 8;
  return sizeof(__nv_bfloat16) * (3 * TILE * ldn + 2 * TILE * LDT) +
         sizeof(float) * (2 * TILE * LDG + (size_t)round_up(cl, TILE) + TILE);
}

__global__ void __launch_bounds__(MMA_THREADS) ssd_bwd_dx_mma(Params p) {
  using bf16 = __nv_bfloat16;
  const int NPAD = round_up(p.N, 16), LDN = NPAD + 8, CLP = p.CLP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);  // [TILE][LDN]: B_j
  bf16* ghi_s = b_s + TILE * LDN;                  // [P][LDN]: g, hi part
  bf16* glo_s = ghi_s + TILE * LDN;                // [P][LDN]: g, lo part
  bf16* dy_s = glo_s + TILE * LDN;                 // [2][TILE][LDT]: dy_i
  float* g_s = reinterpret_cast<float*>(dy_s + 2 * TILE * LDT);  // [2][TILE][LDG]: G[i][j]
  float* cum_s = g_s + 2 * TILE * LDG;                            // [CLP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bc = blockIdx.y, jt = blockIdx.z, b = bc / p.nc, c = bc % p.nc;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), j0 = jt * TILE;
  if (j0 >= len) return;  // past a ragged last chunk
  const int nit = (len + TILE - 1) / TILE;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + t0 * p.x_ss;
  const bf16* dyg = static_cast<const bf16*>(p.dy) + b * p.dy_sb + h * p.dy_sh + t0 * p.dy_ss;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb + (t0 + j0) * p.b_ss;
  const long long bch = (long long)bc * p.H + h, PN = (long long)p.P * p.N;

  load_bf16(b_s, LDN, TILE, NPAD, bg, p.b_ss, len - j0, p.N);
  load_bf16(ghi_s, LDN, TILE, NPAD, p.gsplit + bch * 2 * PN, p.N, p.P, p.N);
  load_bf16(glo_s, LDN, TILE, NPAD, p.gsplit + bch * 2 * PN + PN, p.N, p.P, p.N);
  load_f32(cum_s, p.cum + bch * CLP, CLP);
  auto load_tile = [&](int it, int stage) {  // dy_i and G[i][j] of row tile it
    const int i0 = it * TILE;
    load_bf16(dy_s + stage * TILE * LDT, LDT, TILE, TILE, dyg + i0 * p.dy_ss, p.dy_ss, len - i0,
              p.P);
    const float* src = p.G + ((long long)bc * CLP + i0) * CLP + j0;
    float* dst = g_s + stage * TILE * LDG;
    for (int e = tid; e < TILE * TILE / 4; e += MMA_THREADS) {
      const int r = e / (TILE / 4), col = 4 * (e % (TILE / 4));
      tc::cp_async16(dst + r * LDG + col, src + (long long)r * CLP + col, true);
    }
  };
  load_tile(jt, 0);
  tc::cp_async_commit();

  const int KN = NPAD / 16, NP8 = round_up(p.P, 16) / 8;
  const int jl0 = 16 * warp + g;  // this lane's rows of the tile: jl0, jl0 + 8
  float du[MAX_P / 8][4];
#pragma unroll
  for (int n = 0; n < MAX_P / 8; ++n) du[n][0] = du[n][1] = du[n][2] = du[n][3] = 0.f;

  for (int it = jt; it < nit; ++it) {
    const int stage = (it - jt) & 1, i0 = it * TILE;
    if (it + 1 < nit) load_tile(it + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile (and, the first time, B_j, g and cum) is in
    if (it == jt) {
      // the state part: du = e^{cum_L - cum_j} B_j g^T, g split hi + lo
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks) {
        if (ks >= KN) break;
        uint32_t a[4];
        tc::ldsm_x4(a, b_s + (16 * warp + tc::x_row(lane)) * LDN + 16 * ks + tc::x_col(lane));
#pragma unroll
        for (int np = 0; np < MAX_P / 16; ++np) {
          if (2 * np < NP8) {
            uint32_t r[4];
            tc::ldsm_x4(r, ghi_s + (16 * np + tc::y_row(lane)) * LDN + 16 * ks + tc::y_col(lane));
            tc::mma(du[2 * np], a, r[0], r[1]);
            tc::mma(du[2 * np + 1], a, r[2], r[3]);
            tc::ldsm_x4(r, glo_s + (16 * np + tc::y_row(lane)) * LDN + 16 * ks + tc::y_col(lane));
            tc::mma(du[2 * np], a, r[0], r[1]);
            tc::mma(du[2 * np + 1], a, r[2], r[3]);
          }
        }
      }
      // row scales, and x . du there: the state part of the gradient of cum
      const float cum_last = cum_s[len - 1];
      float xd[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j0 + jl0 + 8 * half;
        const float sc = j < len ? exp2f(LOG2E * (cum_last - cum_s[j])) : 0.f;
        xd[half] = 0.f;
#pragma unroll
        for (int n = 0; n < MAX_P / 8; ++n) {
          const int col = 8 * n + 2 * t;
          du[n][2 * half] *= sc;
          du[n][2 * half + 1] *= sc;
          if (n < NP8 && j < len && col < p.P) {
            const float2 xv =
                tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(xg + j * p.x_ss + col));
            xd[half] = fmaf(xv.x, du[n][2 * half], fmaf(xv.y, du[n][2 * half + 1], xd[half]));
          }
        }
      }
      xd[0] = quad_sum(xd[0]);
      xd[1] = quad_sum(xd[1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j0 + jl0 + 8 * half;
        if (t == 0 && j < len) p.xds[((long long)b * p.S + t0 + j) * p.H + h] = xd[half];
      }
    }
    // du += W1^T dy_i, W1 = G e^{cum_i - cum_j} for j <= i < len, split hi + lo
    const float* gt = g_s + stage * TILE * LDG;
    const bf16* dys = dy_s + stage * TILE * LDT;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      if (i0 + 16 * kk >= len) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      // the A operand (rows j, k = i): a[qq] = (g + 8 (qq & 1), 2t + 8 (qq >> 1))
      for (int qq = 0; qq < 4; ++qq) {
        const int jl = jl0 + 8 * (qq & 1), il = 16 * kk + 2 * t + 8 * (qq >> 1);
        const int j = j0 + jl, i = i0 + il;
        const float cj = cum_s[j];
        const float v0 =
            i >= j && i < len ? gt[il * LDG + jl] * exp2f(LOG2E * (cum_s[i] - cj)) : 0.f;
        const float v1 = i + 1 >= j && i + 1 < len
                             ? gt[(il + 1) * LDG + jl] * exp2f(LOG2E * (cum_s[i + 1] - cj))
                             : 0.f;
        tc::split_bf16(hi[qq], lo[qq], v0, v1);
      }
#pragma unroll
      for (int np = 0; np < MAX_P / 16; ++np) {
        if (2 * np < NP8) {
          uint32_t r[4];
          tc::ldsm_x4_trans(r, dys + (16 * kk + tc::x_row(lane)) * LDT + 16 * np + tc::x_col(lane));
          tc::mma(du[2 * np], hi, r[0], r[1]);
          tc::mma(du[2 * np], lo, r[0], r[1]);
          tc::mma(du[2 * np + 1], hi, r[2], r[3]);
          tc::mma(du[2 * np + 1], lo, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // dx = dt du, and x . du per row
  bf16* dxg = static_cast<bf16*>(p.dx);
  const float* dtg = p.dts + bch * CLP;
  float xd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + jl0 + 8 * half;
    const long long bth = ((long long)b * p.S + t0 + j) * p.H + h;
    const float d = j < len ? dtg[j] : 0.f;
    xd[half] = 0.f;
#pragma unroll
    for (int n = 0; n < MAX_P / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (n < NP8 && j < len && col < p.P) {
        const float2 xv =
            tc::unpack_bf16(*reinterpret_cast<const uint32_t*>(xg + j * p.x_ss + col));
        xd[half] = fmaf(xv.x, du[n][2 * half], fmaf(xv.y, du[n][2 * half + 1], xd[half]));
        *reinterpret_cast<uint32_t*>(dxg + bth * p.P + col) =
            tc::pack_bf16(d * du[n][2 * half], d * du[n][2 * half + 1]);
      }
    }
  }
  xd[0] = quad_sum(xd[0]);
  xd[1] = quad_sum(xd[1]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + jl0 + 8 * half;
    if (t == 0 && j < len) p.xdu[((long long)b * p.S + t0 + j) * p.H + h] = xd[half];
  }
}

// -- 5. dB and dC ---------------------------------------------------------------------

size_t dbdc_smem() {
  return sizeof(__nv_bfloat16) * (2 * 3 * TILE * LDT + TILE * LDT) +
         sizeof(float) * 2 * (2 * TILE + 4);
}

// blockIdx.z = 2 nb + role: role 0 dC for chunk rows i of tile blockIdx.x,
// role 1 dB for rows j; state columns [64 nb, 64 nb + 64). A pipeline of
// steps, each one stage of three bf16 tiles: first the tiles of W2^ (hi,
// lo) beside the B_j (dC) or C_i (dB) rows, then each head's dy_i (x_j) and
// its split h (g).
__global__ void __launch_bounds__(MMA_THREADS) ssd_bwd_dbdc(Params p) {
  using bf16 = __nv_bfloat16;
  const int CLP = p.CLP, NPAD = round_up(p.N, 16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [2][3][TILE][LDT]
  bf16* c_s = tiles + 2 * 3 * TILE * LDT;            // [TILE][LDT]: dC's own C_i
  float* vec_s = reinterpret_cast<float*>(c_s + TILE * LDT);  // [2][2 TILE + 4]: cum, dt, cum_L

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, bc = blockIdx.y, b = bc / p.nc, c = bc % p.nc;
  const bool dc = (blockIdx.z & 1) == 0;
  const int nb = blockIdx.z >> 1;
  const int t0 = c * p.cl, len = min(p.cl, p.S - t0), r0 = tile * TILE;
  if (r0 >= len) return;  // past a ragged last chunk
  const int nt = (len + TILE - 1) / TILE;
  const int n0 = nb * NBLK, NCT = min(NBLK, NPAD - n0) / 8;  // n-tiles of this block
  const int n_intra = dc ? tile + 1 : nt - tile;
  const int nsteps = n_intra + p.H;
  const long long PN = (long long)p.P * p.N;
  const bf16* w2g = p.w2 + (long long)bc * 2 * CLP * CLP;
  // the other side's rows for the intra steps: B_j (dC) or C_i (dB)
  const bf16* og = dc ? static_cast<const bf16*>(p.Bm) + b * p.b_sb + t0 * p.b_ss + n0
                      : static_cast<const bf16*>(p.Cm) + b * p.c_sb + t0 * p.c_ss + n0;
  const long long oss = dc ? p.b_ss : p.c_ss;
  // each head's rows: dy_i (dC) or x_j (dB)
  const bf16* ag = dc ? static_cast<const bf16*>(p.dy) + b * p.dy_sb + (t0 + r0) * p.dy_ss
                      : static_cast<const bf16*>(p.x) + b * p.x_sb + (t0 + r0) * p.x_ss;
  const long long ass = dc ? p.dy_ss : p.x_ss, ash = dc ? p.dy_sh : p.x_sh;
  const bf16* stg = (dc ? p.hsplit : p.gsplit) + n0;

  auto load_step = [&](int k, int stage) {
    bf16* T = tiles + stage * 3 * TILE * LDT;
    if (k < n_intra) {
      const int o = dc ? k : tile + k;  // the other tile
      const int it = dc ? tile : o, jt = dc ? o : tile;
      const bf16* wt = w2g + (long long)(it * TILE) * CLP + jt * TILE;
      load_bf16(T, LDT, TILE, TILE, wt, CLP, TILE, TILE);
      load_bf16(T + TILE * LDT, LDT, TILE, TILE, wt + (long long)CLP * CLP, CLP, TILE, TILE);
      load_bf16(T + 2 * TILE * LDT, LDT, TILE, NCT * 8, og + o * TILE * oss, oss, len - o * TILE,
                p.N - n0);
    } else {
      const int hh = k - n_intra;
      const long long bch = (long long)bc * p.H + hh;
      load_bf16(T, LDT, TILE, TILE, ag + hh * ash, ass, len - r0, p.P);
      load_bf16(T + TILE * LDT, LDT, TILE, NCT * 8, stg + bch * 2 * PN, p.N, p.P, p.N - n0);
      load_bf16(T + 2 * TILE * LDT, LDT, TILE, NCT * 8, stg + bch * 2 * PN + PN, p.N, p.P,
                p.N - n0);
      float* v = vec_s + stage * (2 * TILE + 4);
      load_f32(v, p.cum + bch * CLP + r0, TILE);
      load_f32(v + TILE, p.dts + bch * CLP + r0, TILE);
      load_f32(v + 2 * TILE, p.cum + bch * CLP + CLP - 4, 4);  // [3]: cum_L
    }
  };
  load_step(0, 0);
  if (dc)
    load_bf16(c_s, LDT, TILE, NCT * 8,
              static_cast<const bf16*>(p.Cm) + b * p.c_sb + (t0 + r0) * p.c_ss + n0, p.c_ss,
              len - r0, p.N - n0);
  tc::cp_async_commit();

  const int KP = round_up(p.P, 16) / 16;
  const int il0 = 16 * warp + g;  // this lane's rows of the tile: il0, il0 + 8
  float acc[NBLK / 8][4];
#pragma unroll
  for (int n = 0; n < NBLK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    const int stage = k & 1;
    if (k + 1 < nsteps) load_step(k + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // this step's tiles are in
    const bf16* T = tiles + stage * 3 * TILE * LDT;
    if (k < n_intra) {
      // acc += W2^ B_j (dC) or W2^T C_i (dB), W2^ as hi + lo
      const int o = dc ? k : tile + k;
      const int kmax = min(TILE, len - o * TILE);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (16 * kk >= kmax) break;
        uint32_t ah[4], al[4];
        if (dc) {
          tc::ldsm_x4(ah, T + (16 * warp + tc::x_row(lane)) * LDT + 16 * kk + tc::x_col(lane));
          tc::ldsm_x4(al, T + TILE * LDT + (16 * warp + tc::x_row(lane)) * LDT + 16 * kk +
                              tc::x_col(lane));
        } else {
          tc::ldsm_x4_trans(ah, T + (16 * kk + tc::y_row(lane)) * LDT + 16 * warp + tc::y_col(lane));
          tc::ldsm_x4_trans(al, T + TILE * LDT + (16 * kk + tc::y_row(lane)) * LDT + 16 * warp +
                                    tc::y_col(lane));
        }
#pragma unroll
        for (int np = 0; np < NBLK / 16; ++np) {
          if (2 * np < NCT) {
            uint32_t r[4];
            tc::ldsm_x4_trans(r, T + 2 * TILE * LDT + (16 * kk + tc::x_row(lane)) * LDT + 16 * np +
                                     tc::x_col(lane));
            tc::mma(acc[2 * np], ah, r[0], r[1]);
            tc::mma(acc[2 * np], al, r[0], r[1]);
            tc::mma(acc[2 * np + 1], ah, r[2], r[3]);
            tc::mma(acc[2 * np + 1], al, r[2], r[3]);
          }
        }
      }
    } else {
      // this head: dy_i h (dC) or x_j g (dB), the state split hi + lo, then
      // each row scaled by e^{cum_i} (dC) or e^{cum_L - cum_j} dt_j (dB)
      const int hh = k - n_intra;
      const float* v = vec_s + stage * (2 * TILE + 4);
      float tmp[NBLK / 8][4];
#pragma unroll
      for (int n = 0; n < NBLK / 8; ++n) tmp[n][0] = tmp[n][1] = tmp[n][2] = tmp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        if (kk >= KP) break;
        uint32_t a[4];
        tc::ldsm_x4(a, T + (16 * warp + tc::x_row(lane)) * LDT + 16 * kk + tc::x_col(lane));
#pragma unroll
        for (int np = 0; np < NBLK / 16; ++np) {
          if (2 * np < NCT) {
            uint32_t r[4];
            tc::ldsm_x4_trans(r, T + TILE * LDT + (16 * kk + tc::x_row(lane)) * LDT + 16 * np +
                                     tc::x_col(lane));
            tc::mma(tmp[2 * np], a, r[0], r[1]);
            tc::mma(tmp[2 * np + 1], a, r[2], r[3]);
            tc::ldsm_x4_trans(r, T + 2 * TILE * LDT + (16 * kk + tc::x_row(lane)) * LDT +
                                     16 * np + tc::x_col(lane));
            tc::mma(tmp[2 * np], a, r[0], r[1]);
            tc::mma(tmp[2 * np + 1], a, r[2], r[3]);
          }
        }
      }
      float sc[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int il = il0 + 8 * half;
        sc[half] = r0 + il >= len ? 0.f
                   : dc           ? exp2f(LOG2E * v[il])
                                  : exp2f(LOG2E * (v[2 * TILE + 3] - v[il])) * v[TILE + il];
      }
      if (dc) {  // this head's e^{cum_i} C_i . (h^T dy_i) over the block
        float d[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NBLK / 8; ++n) {
          if (n < NCT) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 cv = tc::unpack_bf16(
                  *reinterpret_cast<const uint32_t*>(c_s + (il0 + 8 * half) * LDT + 8 * n + 2 * t));
              d[half] = fmaf(cv.x, tmp[n][2 * half], fmaf(cv.y, tmp[n][2 * half + 1], d[half]));
            }
          }
        }
        d[0] = quad_sum(d[0]);
        d[1] = quad_sum(d[1]);
        const long long at = (((long long)bc * p.NNB + nb) * p.H + hh) * CLP + r0;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if (t == 0 && r0 + il0 + 8 * half < len) p.cst[at + il0 + 8 * half] = sc[half] * d[half];
      }
#pragma unroll
      for (int n = 0; n < NBLK / 8; ++n) {
        acc[n][0] = fmaf(sc[0], tmp[n][0], acc[n][0]);
        acc[n][1] = fmaf(sc[0], tmp[n][1], acc[n][1]);
        acc[n][2] = fmaf(sc[1], tmp[n][2], acc[n][2]);
        acc[n][3] = fmaf(sc[1], tmp[n][3], acc[n][3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* out = static_cast<bf16*>(dc ? p.dC : p.dB) + ((long long)b * p.S + t0 + r0) * p.N + n0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int il = il0 + 8 * half;
    if (r0 + il >= len) continue;
#pragma unroll
    for (int n = 0; n < NBLK / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (n < NCT && n0 + col < p.N)
        *reinterpret_cast<uint32_t*>(out + (long long)il * p.N + col) =
            tc::pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
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

// the f32 form's six launches on one stream, each checked
cudaError_t launch_f32(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_state[MAX_DEVICES], set_dx[MAX_DEVICES], set_dc[MAX_DEVICES];
  cudaError_t err = opt_in_smem(ssd_bwd_chunk_state, device, set_state);
  if (err != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dx, device, set_dx)) != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dc, device, set_dc)) != cudaSuccess) return err;
  const dim3 tiles(p.NT, p.H, p.B * p.nc);
  ssd_bwd_chunk_state<<<dim3(p.H, p.B * p.nc), THREADS, chunk_state_smem(p.P, p.N, p.cl),
                               stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_pass<false><<<dim3(p.H, p.B), THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx<<<tiles, THREADS, dx_smem(p.P, p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dc<<<tiles, THREADS, dc_smem(p.P, p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish<<<p.H, THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long elems = (long long)p.B * p.S * p.N;
  ssd_bwd_sum_heads<<<(unsigned)((elems + THREADS - 1) / THREADS), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// the bf16 form's six launches on one stream, each checked
cudaError_t launch_bf16(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_state[MAX_DEVICES], set_scores[MAX_DEVICES], set_dx[MAX_DEVICES],
      set_dbdc[MAX_DEVICES];
  if (p.P % 8 || p.N % 8) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(ssd_bwd_chunk_state_mma, device, set_state);
  if (err != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_scores, device, set_scores)) != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dx_mma, device, set_dx)) != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dbdc, device, set_dbdc)) != cudaSuccess) return err;
  const int bnc = p.B * p.nc, pairs = p.NT * (p.NT + 1) / 2;
  ssd_bwd_chunk_state_mma<<<dim3(p.H, bnc), THREADS, chunk_state_mma_smem(p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_pass<true><<<dim3(p.H, p.B), THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_scores<<<dim3(pairs, bnc), MMA_THREADS, scores_smem(p.N), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the j tiles with the most i tiles to their right first
  ssd_bwd_dx_mma<<<dim3(p.H, bnc, p.NT), MMA_THREADS, dx_mma_smem(p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dbdc<<<dim3(p.NT, bnc, 2 * p.NNB), MMA_THREADS, dbdc_smem(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish_mma<<<p.H, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// the shape fields of p from the call's dims
void set_dims(Params& p, int B, int S, int H, int P, int N, int cl) {
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.cl = cl;
  p.nc = (S + cl - 1) / cl;
  p.CLP = round_up(cl, TILE);
  p.NT = p.CLP / TILE;
  p.NNB = (round_up(N, 16) + NBLK - 1) / NBLK;
}

// the scratch regions of the form `dtype` in floats, each rounded up to 64
// floats so every region starts 256-byte aligned; with `base` null only the
// total is counted
long long carve(Params& p, float* base, int dtype) {
  long long off = 0;
  auto take = [&](long long n) {
    float* r = base ? base + off : nullptr;
    off += (n + 63) / 64 * 64;
    return r;
  };
  const long long bnc = (long long)p.B * p.nc, bnch = bnc * p.H, pn = (long long)p.P * p.N;
  const long long rows = (long long)p.B * p.S * p.H, clp = p.CLP;
  p.states = take(bnch * pn);
  p.gstate = take(bnch * pn);
  p.chunk_sum = take(bnch);
  p.gh = take(bnch);
  p.xdu = take(rows);
  if (dtype == 0) {
    p.dBp = take(rows * p.N);
    p.dCp = take(rows * p.N);
    p.cdc = take(rows);
  } else {
    p.hsplit = reinterpret_cast<__nv_bfloat16*>(take(bnch * pn));  // 2 P N bf16 a (b, c, h)
    p.gsplit = reinterpret_cast<__nv_bfloat16*>(take(bnch * pn));
    p.cum = take(bnch * clp);
    p.dts = take(bnch * clp);
    p.G = take(bnc * clp * clp);
    p.w2 = reinterpret_cast<__nv_bfloat16*>(take(bnc * clp * clp));  // 2 CLP^2 bf16 a (b, c)
    p.rsum = take(bnc * p.NT * p.H * clp);
    p.csum = take(bnc * p.NT * p.H * clp);
    p.cst = take(bnc * p.NNB * p.H * clp);
    p.xds = take(rows);
  }
  return off;
}

bool valid_dims(int dtype, int B, int S, int H, int P, int N, int cl) {
  return B >= 1 && S >= 1 && H >= 1 && P >= 1 && P <= MAX_P && N >= 1 && N <= MAX_N && cl >= 1 &&
         cl <= S && (dtype == 0 || dtype == 1);
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

// The f32 scratch ssd_bwd needs for these dims, in floats (-1 for dims it
// does not take): dtype 0 = float32, 1 = bfloat16.
extern "C" long long ssd_bwd_scratch_floats(int dtype, int B, int S, int H, int P, int N, int cl) {
  if (!valid_dims(dtype, B, S, H, P, N, cl)) return -1;
  Params p{};
  set_dims(p, B, S, H, P, N, cl);
  return carve(p, nullptr, dtype);
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC); dt, A,
// dfinal, ddt and dA are float32. Input strides are in elements, with the
// last dims of x, B, C and dy contiguous (for bfloat16, 16-byte aligned base
// pointers and strides, P and N multiples of 8); dfinal (B, H, P, N), dx (B,
// S, H, P), ddt (B, S, H), dB and dC (B, S, N) are contiguous, and dfinal
// may be null (a zero gradient of the final state). `scratch` holds
// ssd_bwd_scratch_floats(dtype, ...) floats, 256-byte aligned. P <= 64, N
// <= 128. `device` is the ordinal the tensors live on and `stream` one of
// its streams; the launches make it the thread's current device of the CUDA
// runtime this library is linked against (with -cudart shared, PyTorch's)
// and then restore the previous one. Returns the first failing launch's
// cudaError_t (0 = success).
extern "C" int ssd_bwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm, const void* dy,
    const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC, void* scratch,
    int dtype, int device, int B, int S, int H, int P, int N, int cl,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dy_sb, long long dy_ss, long long dy_sh, void* stream) {
  if (!valid_dims(dtype, B, S, H, P, N, cl) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  Params p{};
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.dy = dy;
  p.dfinal = static_cast<const float*>(dfinal);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = dB;
  p.dC = dC;
  set_dims(p, B, S, H, P, N, cl);
  carve(p, static_cast<float*>(scratch), dtype);
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.x_sh = x_sh;
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.dt_sh = dt_sh;
  p.b_sb = b_sb;
  p.b_ss = b_ss;
  p.c_sb = c_sb;
  p.c_ss = c_ss;
  p.dy_sb = dy_sb;
  p.dy_ss = dy_ss;
  p.dy_sh = dy_sh;
  if ((long long)p.B * p.nc > 65535 || p.B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_f32(p, device, st) : launch_bf16(p, device, st));
}
