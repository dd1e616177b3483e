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
// What bounds it on this card: the products, each a chunk's causal pairs
// times P or N per head, and the state terms, P N per row and head; at
// mamba2-1.3b's training shapes (B=4, S=2048, H=64, P=64, N=128, chunk 256)
// that is operations-bound at the bf16 tensor-core peak. This first design
// runs them as f32 FMA tiles from shared memory for both input dtypes (bf16
// inputs are widened on load, gradients rounded once on store), so it keeps
// the precision of the f32 formulas; its speed is work for a later design.
//
// Six launches, each checked:
//  1. ssd_bwd_chunk_state, a CTA per (batch, chunk, head): the chunk's own
//     state sum_j e^{cum_L - cum_j} u_j B_j^T and sum_i e^{cum_i} dy_i C_i^T,
//     (P, N) each, and cum_L, into f32 scratch; 4 x 8 tiles a thread.
//  2. ssd_bwd_state_pass, a CTA per (batch, head): the states in order (the
//     state entering each chunk over the chunk's own), then the gradients in
//     reverse (g_c over the chunk's dy C^T sum), and <g_c, state leaving c>
//     by a fixed-order block sum.
//  3. ssd_bwd_dx, a CTA per (batch, chunk, head, 64-row tile j): walks the
//     row tiles i >= j, forms W1 = (C B^T) e^{..} and W2 = (dy u^T) e^{..} in
//     shared memory (64 x 64, masked), accumulates du += W1^T dy and
//     dB += W2^T C in registers, then adds the state terms from g; writes dx,
//     x . du per row and this head's dB.
//  4. ssd_bwd_dc, a CTA per (batch, chunk, head, 64-row tile i): walks the
//     tiles j <= i, dC += W2 B, then the state term from h; writes this
//     head's dC and C . dC per row.
//  5. ssd_bwd_finish, a CTA per head: walks batch and chunks in order, the
//     reverse prefix sum of the cum gradient per chunk by a block scan, ddt,
//     and dA by a fixed-order block sum.
//  6. ssd_bwd_sum_heads, a thread per (batch, row, state column): dB and dC
//     summed over the heads in order, rounded once to the inputs' dtype.
// P is at most 64 (one tile of rows of g and h) and N at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

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
  float* states;  // (B, nc, H, P, N): each chunk's own state, then the state entering it
  float* gstate;  // (B, nc, H, P, N): each chunk's dy C^T sum, then g of the state leaving it
  float* chunk_sum;  // (B, nc, H): cum at the chunk's last row
  float* gh;         // (B, nc, H): <g, state leaving the chunk>
  float* dBp;        // (B, S, H, N): each head's dB
  float* dCp;        // (B, S, H, N): each head's dC
  float* xdu;        // (B, S, H): x . du
  float* cdc;        // (B, S, H): C . dC, this head's part
  int B, S, H, P, N, cl, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld_, const T* src, long long ss, int r0,
                                          int rows, int ncols) {
  for (int e = threadIdx.x; e < TILE * ncols; e += THREADS) {
    const int r = e / ncols, col = e % ncols;
    dst[r * ld_ + col] = r < rows ? ld(src + (long long)(r0 + r) * ss + col) : 0.f;
  }
}

// -- 1. the chunk's own states ----------------------------------------------------

size_t chunk_state_smem(int P, int N, int cl) {
  return sizeof(float) * (2 * (size_t)round_up(cl, TILE) + WARPS + 2 * TILE * P + 2 * TILE * N);
}

template <typename T>
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
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;

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
        uv = ld(xg + t * p.x_ss + col) * dt_s[j] * expf(cum_last - cum_s[j]);
        ev = ld(dyg + t * p.dy_ss + col) * expf(cum_s[j]);
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

// -- 2. the state passes ----------------------------------------------------------

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
      if (e < PN) st[e] = s[k];
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
    float* __restrict__ gs = p.gstate + bch * PN;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      own[k] = e < PN ? gs[e] : 0.f;
      ent[k] = e < PN ? st[e] : 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) dot = fmaf(g[k], s[k], dot);
    dot = block_sum(dot, red);
    if (tid == 0) p.gh[bch] = dot;
#pragma unroll
    for (int k = 0; k < PASS_ELEMS; ++k) {
      const int e = tid + THREADS * k;
      if (e < PN) gs[e] = g[k];
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

template <typename T>
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
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;

  chunk_cum(cum_s, dt_s, wsum, p.dt + b * p.dt_sb + h * p.dt_sh, p.dt_ss, t0, len, CLP, p.A[h]);
  const float cum_last = cum_s[len - 1];
  load_rows(b_s, NS, bg, p.b_ss, t0 + j0, jn, N);
  for (int e = tid; e < TILE * P; e += THREADS) {
    const int r = e / P, col = e % P;
    u_s[r * PS + col] = r < jn ? ld(xg + (long long)(t0 + j0 + r) * p.x_ss + col) * dt_s[j0 + r] : 0.f;
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
  T* dxg = static_cast<T*>(p.dx);
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
        xd = fmaf(ld(xg + t * p.x_ss + col), du[k][m], xd);
        dxg[bth * P + col] = from_f32<T>(dt_s[j] * du[k][m]);
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

template <typename T>
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
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;

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
          r < jn ? ld(xg + (long long)(t0 + j0 + r) * p.x_ss + col) * dt_s[j0 + r] : 0.f;
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

// -- 5. ddt and dA ------------------------------------------------------------------

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

// -- 6. dB and dC over the heads ----------------------------------------------------

template <typename T>
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
  static_cast<T*>(p.dB)[e] = from_f32<T>(sb);
  static_cast<T*>(p.dC)[e] = from_f32<T>(sc);
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

// the six launches on one stream, each checked
template <typename T>
cudaError_t launch_all(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_state[MAX_DEVICES], set_dx[MAX_DEVICES], set_dc[MAX_DEVICES];
  cudaError_t err = opt_in_smem(ssd_bwd_chunk_state<T>, device, set_state);
  if (err != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dx<T>, device, set_dx)) != cudaSuccess) return err;
  if ((err = opt_in_smem(ssd_bwd_dc<T>, device, set_dc)) != cudaSuccess) return err;
  const int n_it = (p.cl + TILE - 1) / TILE;
  if ((long long)p.B * p.nc > 65535 || p.B > 65535) return cudaErrorInvalidValue;
  const dim3 tiles(n_it, p.H, p.B * p.nc);
  ssd_bwd_chunk_state<T><<<dim3(p.H, p.B * p.nc), THREADS, chunk_state_smem(p.P, p.N, p.cl),
                           stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_pass<<<dim3(p.H, p.B), THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx<T><<<tiles, THREADS, dx_smem(p.P, p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dc<T><<<tiles, THREADS, dc_smem(p.P, p.N, p.cl), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish<<<p.H, THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long elems = (long long)p.B * p.S * p.N;
  ssd_bwd_sum_heads<T><<<(unsigned)((elems + THREADS - 1) / THREADS), THREADS, 0, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy and dx, dB, dC); dt, A,
// dfinal, ddt and dA are float32. Input strides are in elements, with the
// last dims of x, B, C and dy contiguous; dfinal (B, H, P, N), dx (B, S, H,
// P), ddt (B, S, H), dB and dC (B, S, N) are contiguous, and dfinal may be
// null (a zero gradient of the final state). `scratch` holds
// 2 B nc H (P N + 1) + 2 B S H (N + 1) floats, nc = ceil(S / cl). P <= 64,
// N <= 128. `device` is the ordinal the tensors live on and `stream` one of
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
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > MAX_P || N < 1 || N > MAX_N || cl < 1 || cl > S)
    return (int)cudaErrorInvalidValue;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const int nc = (S + cl - 1) / cl;
  const long long chunk_states = (long long)B * nc * H * P * N;
  const long long rows = (long long)B * S * H;
  float* f = static_cast<float*>(scratch);
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, dy,
           static_cast<const float*>(dfinal), dx, static_cast<float*>(ddt),
           static_cast<float*>(dA), dB, dC,
           /*states=*/f, /*gstate=*/f + chunk_states,
           /*chunk_sum=*/f + 2 * chunk_states,
           /*gh=*/f + 2 * chunk_states + (long long)B * nc * H,
           /*dBp=*/f + 2 * chunk_states + 2LL * B * nc * H,
           /*dCp=*/f + 2 * chunk_states + 2LL * B * nc * H + rows * N,
           /*xdu=*/f + 2 * chunk_states + 2LL * B * nc * H + 2 * rows * N,
           /*cdc=*/f + 2 * chunk_states + 2LL * B * nc * H + 2 * rows * N + rows,
           B, S, H, P, N, cl, nc,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss, dy_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_all<float>(p, device, st);
  if (dtype == 1) return (int)launch_all<__nv_bfloat16>(p, device, st);
  return (int)cudaErrorInvalidValue;
}
