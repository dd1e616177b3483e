// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the reference's Pallas TPU kernel
// `src/repro/kernels/flash_attention.py:_kernel` (launched by
// `flash_attention_bhsd`). It recomputes the same function:
// softmax(Q K^T * Dh^-1/2 + mask) V per (batch, q-head), GQA q-head h reading
// kv-head h / (H / KV), masks causal (top-left aligned, positions from 0),
// sliding window (k > q - window) and valid length (k < k_len), finite -1e30
// for masked scores, the denominator floored at 1e-30, output in the input
// dtype. Forward only.
//
// What bounds it on this card: at tinyllama prefill (H=32, KV=4, Dh=64) the
// work is 4 * Sq * Sk/2 * Dh FLOPs per head against q, k, v and o moved once,
// so short prompts are bounded by bytes and long ones by tensor-core FLOPs
// (at H100 peaks, 989 TFLOP/s bf16 and 3.35 TB/s, the crossover is near
// Sq = Sk = 660 for causal attention). This first version computes on
// the FP32 pipes with FMAs, not on the tensor cores, so it sits well above
// the FLOP bound at long prompts; wgmma/TMA is later work.
//
// Design: one CTA per (batch * q-head, 64-row q tile), 256 threads, each
// thread owning a 4 x 4 micro-tile of the 64 x 64 score tile and 4 rows x
// Dh/16 columns of the output. The CTA loops over 64-key K/V tiles staged in
// shared memory, so each K/V tile is read from device memory once per q tile
// and re-read 64 times from shared memory; the running max, denominator and
// accumulator stay in f32 registers. Tiles wholly above the causal diagonal,
// left of the window or past the valid length are skipped. Ragged Sq and Sk
// are masked, never asserted away. Inputs are addressed through strides, so
// (B, S, H, Dh) activations need no transpose copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
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
  float scale;
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

template <int DH>
constexpr int smem_floats() {
  // q and k tiles padded to DH + 1 (conflict-free column walks), v tile,
  // p tile padded to BK + 4 (the two row groups of a warp hit disjoint banks)
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 4);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int QS = DH + 1;
  constexpr int PS = BK + 4;
  constexpr int DC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = v_s + BK * DH;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16 j, output columns tx + 16 j
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, qi = q0 + r;
    q_s[r * QS + d] = qi < p.Sq ? to_f32(qg[qi * p.q_ss + d]) * p.scale : 0.f;
  }

  // key tiles this q tile can see
  const int k_valid = min(p.k_len, p.Sk);
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(k_valid, q_last + 1) : k_valid;
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1) / BK * BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q_s is in)
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, kj = k0 + r;
      const bool in = kj < p.Sk;
      k_s[r * QS + d] = in ? to_f32(kg[kj * p.k_ss + d]) : 0.f;
      v_s[r * DH + d] = in ? to_f32(vg[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
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
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < k_valid;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && kj > qi - p.window;
        if (!ok) s[i][j] = NEG_INF;
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
        const float vv = v_s[kk * DH + tx + 16 * c];
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
    for (int c = 0; c < DC; ++c) og[qi * p.o_ss + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  // the opt-in above 48 KiB belongs to the function on one device: set it
  // once per (instantiation, device); a racing second setter is harmless
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (!smem_set[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int dh, int device, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, device, stream);
    case 64: return launch<T, 64>(p, device, stream);
    case 128: return launch<T, 128>(p, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (Dh)
// dim must be contiguous. `device` is the ordinal the tensors live on; it
// must be the calling thread's current device in the CUDA runtime this
// library is linked against (built with -cudart shared, that is PyTorch's
// runtime, which the caller has set), else cudaErrorInvalidDevice comes
// back before anything is launched. Returns the launch's cudaError_t
// (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int device,
    int B, int H, int KV, int Sq, int Sk, int Dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int k_len, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= MAX_DEVICES || device != current)
    return (int)cudaErrorInvalidDevice;
  Params p{q, k, v, o, B, H, KV, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           causal, window, k_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dh<float>(p, Dh, device, st);
  if (dtype == 1) return (int)dispatch_dh<__nv_bfloat16>(p, Dh, device, st);
  return (int)cudaErrorInvalidValue;
}
