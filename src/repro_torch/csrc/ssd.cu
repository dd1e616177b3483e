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
// peaks. This first version computes on the FP32 pipes with FMAs, not on the
// tensor cores, and recomputes C B^T in every CTA (it is shared by all heads
// and P tiles), so it sits far above that bound; sharing C B^T across heads
// and wgmma/TMA are later work.
//
// Design: one CTA of 256 threads per (batch, head, PT-column tile of P),
// looping over the chunks in order, so the carried state never leaves the
// CTA: each row p of the state (P, N) depends only on x[..., p], dt and the
// shared B, so P splits across CTAs without communication. PT is 64, 32 or
// 16, the widest that still puts about 3/4 of the SMs to work. The state tile
// (PT, N) stays in shared memory across chunks. Inside a chunk, 64-row tiles
// of C and B are staged in shared memory; each thread owns a 4 x 4 micro-tile
// of the 64 x 64 score tile and 4 rows x PT/16 columns of the y tile, and for
// the state update PT/16 rows x up to 8 columns of the state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int TILE = 64;  // rows of a C, B or x tile
constexpr int THREADS = 256;
constexpr int PS = TILE + 4;  // padded row stride of the score tile
constexpr int MAX_N = 128;    // state columns: tx + 16 q for q < 8
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
  int B, S, H, P, N, cl;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [t, t + rows) of a (S, N) matrix with row stride ss into a TILE x ns
// f32 tile; rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int t, int rows, int n_cols,
                                          int ns, long long ss) {
  for (int r = threadIdx.x / 32; r < TILE; r += THREADS / 32) {
    for (int n = threadIdx.x % 32; n < n_cols; n += 32)
      dst[r * ns + n] = r < rows ? to_f32(src[(t + r) * ss + n]) : 0.f;
  }
}

__host__ __device__ constexpr int smem_floats_fixed(int pt) {
  return TILE * pt + TILE * PS;  // x tile, score tile
}

template <typename T, int PT>
__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(Params p) {
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

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + p0;
  const long long st_off = ((long long)(b * p.H + h) * p.P + p0) * N;

  for (int e = tid; e < PT * N; e += THREADS) st_s[(e / N) * NS + e % N] = 0.f;

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
        for (int e = tid; e < TILE * PT; e += THREADS) {
          const int r = e / PT, c = e % PT;
          x_s[e] = (r < jn && p0 + c < p.P)
                       ? to_f32(xg[(t0 + j0 + r) * p.x_ss + c]) * dt_s[j0 + r]
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
            yg[(t0 + i0 + i) * p.y_ss + tx + 16 * c] = from_f32<T>(acc[k][c]);
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
      for (int e = tid; e < TILE * PT; e += THREADS) {
        const int r = e / PT, c = e % PT;
        x_s[e] = (r < jn && p0 + c < p.P)
                     ? to_f32(xg[(t0 + j0 + r) * p.x_ss + c]) * dt_s[j0 + r] *
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
  for (int e = tid; e < PT * N; e += THREADS) {
    const int r = e / N, n = e % N;
    if (p0 + r < p.P) p.fin[st_off + r * N + n] = st_s[r * NS + n];
  }
}

size_t smem_bytes(int pt, int n, int cl) {
  return sizeof(float) * ((size_t)(2 * TILE + pt) * (n + 1) + smem_floats_fixed(pt) + 2 * cl);
}

template <typename T, int PT>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  // the opt-in above 48 KiB belongs to the function on one device: set it
  // once per (instantiation, device), to the device's limit; a racing
  // second setter is harmless
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (!smem_set[device].load(std::memory_order_acquire)) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_fwd_kernel<T, PT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const long long ctas = (long long)p.B * p.H * ((p.P + PT - 1) / PT);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_fwd_kernel<T, PT><<<(unsigned)ctas, THREADS, smem_bytes(PT, p.N, p.cl), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pt(const Params& p, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the widest P tile that still gives about 3/4 of the SMs a CTA, and no
  // wider than P rounded up to 16
  const long long bh = (long long)p.B * p.H;
  const int p16 = (p.P + 15) / 16 * 16;
  if (p16 >= 64 && bh * ((p.P + 63) / 64) * 4 >= 3LL * sms) return launch<T, 64>(p, device, stream);
  if (p16 >= 32 && bh * ((p.P + 31) / 32) * 4 >= 3LL * sms) return launch<T, 32>(p, device, stream);
  return launch<T, 16>(p, device, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the final
// state are float32. Strides are in elements; the last dims of x, B, C and y
// must be contiguous. `device`
// is the ordinal the tensors live on; it must be the calling thread's current
// device in the CUDA runtime this library is linked against (built with
// -cudart shared, that is PyTorch's runtime, which the caller has set), else
// cudaErrorInvalidDevice comes back before anything is launched. Returns the
// launch's cudaError_t (0 = success).
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    void* y, void* fin, int dtype, int device,
    int B, int S, int H, int P, int N, int cl,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N || cl < 1 || cl > S)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= MAX_DEVICES || device != current)
    return (int)cudaErrorInvalidDevice;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
           y, static_cast<float*>(fin),
           B, S, H, P, N, cl,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_pt<float>(p, device, st);
  if (dtype == 1) return (int)dispatch_pt<__nv_bfloat16>(p, device, st);
  return (int)cudaErrorInvalidValue;
}
