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
// with the forward's masks (causal top-left aligned from position 0,
// sliding window k > q - window, valid length k < k_len), GQA q-head h
// reading kv-head h / (H / KV), ragged Sq and Sk, inputs and outputs
// addressed through strides, so the model's (B, S, H, Dh) views need no
// copy. A row that sees no key gets zero gradient.
//
// Three launches, no float atomics, so the result is the same bit for bit
// from run to run:
//  - bwd_preprocess: D, one warp per row.
//  - bwd_dkdv: one CTA per (batch * kv-head, 64-key tile), heaviest causal
//    tiles (the first) dispatched first. It keeps its K and V tile in
//    shared memory and dK, dV in registers, walks the G q-heads of its
//    group and, for each, the 64-row q tiles the mask lets see its keys,
//    recomputing P and dS per tile, and writes dK and dV once.
//  - bwd_dq: one CTA per (batch * q-head, 64-row q tile), heaviest first,
//    walking the key tiles its rows see, and writes dQ once.
//
// What bounds it on this card: at tinyllama's training shapes (B=4, H=32,
// KV=4, Dh=64, S=2048, causal) the work is about 2.5x the forward's FLOPs
// against q, k, v, o, dO and lse read and dq, dk, dv written once, so it is
// bounded by operations (tensor-core peak) by a wide margin. This first
// design is simple and right rather than fast: every product runs on FMA
// tiles on the FP32 pipes (both dtypes; bf16 operands are widened to f32
// in shared memory), each thread owning a 4 x 4 micro-tile of the 64 x 64
// score tile and 4 rows x Dh/16 columns of its gradient tile. The products
// are bound by shared-memory reads as much as by the FMA pipes. Moving
// them onto the tensor cores (mma.sync / wgmma, as the forward's bf16
// form) is the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 4;  // score-tile row: the warp's two row groups hit disjoint banks
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
  float scale;
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
template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Params& p, int k_valid, int qi, int kj) {
  bool ok = kj < k_valid;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// -- D = rowsum(dO o O) ----------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) bwd_preprocess(Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (THREADS / 32) + warp;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  if (qi >= p.Sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h + qi * p.so.s;
  const T* dO = static_cast<const T*>(p.dO) + b * p.sdo.b + h * p.sdo.h + qi * p.sdo.s;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) acc = fmaf(ld(o + d), ld(dO + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(long long)bh * p.Sq + qi] = acc;
}

// -- shared pieces of the two gradient kernels -------------------------------------

template <int DH>
constexpr int smem_bytes() {
  // q, dO, k, v tiles padded to DH + 1 (conflict-free column walks), the P
  // and dS tiles, and a q tile's lse and D
  return (4 * BQ * (DH + 1) + 2 * BQ * PS + 2 * BQ) * 4;
}

// rows [r0, r0 + 64) of a (seq, Dh) slice into a padded f32 tile, zeros past n
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int r0, int n) {
  for (int i = threadIdx.x; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r0 + r < n ? ld(src + (long long)(r0 + r) * ss + d) : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, key tile) pair, then P and dS
// into shared memory. Thread (ty, tx) owns q rows 4 ty + i, keys tx + 16 j.
template <int DH>
__device__ __forceinline__ void scores(const Params& p, int k_valid, int q0, int k0,
                                       const float* q_s, const float* do_s, const float* k_s,
                                       const float* v_s, const float* lse_s, const float* dl_s,
                                       float* p_s, float* ds_s) {
  constexpr int QS = DH + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = q_s[(4 * ty + i) * QS + d];
      gv[i] = do_s[(4 * ty + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = k_s[(tx + 16 * j) * QS + d];
      vv[j] = v_s[(tx + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float pr = 0.f;
      if (qi < p.Sq && visible(p, k_valid, qi, k0 + c)) pr = __expf(s[i][j] * p.scale - lse_s[r]);
      p_s[r * PS + c] = pr;
      ds_s[r * PS + c] = pr * (dp[i][j] - dl_s[r]);
    }
  }
}

// -- dK, dV ---------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Params p) {
  constexpr int QS = DH + 1;
  constexpr int DC = DH / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* k_s = do_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = v_s + BK * QS;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.x, b = bkv / p.KV, kvh = bkv % p.KV;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most q rows under causality
  const int G = p.H / p.KV;
  const int k_valid = min(p.k_len, p.Sk);

  load_tile<T, DH>(k_s, static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h, p.sk.s, k0, p.Sk);
  load_tile<T, DH>(v_s, static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0, p.Sk);

  // the q rows that can see a key of this tile: causal q >= k0; window
  // q < k_last + window; none when the tile lies past the valid length
  int q_lo = p.causal ? k0 / BQ * BQ : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + BK - 1 + p.window);
  if (k0 >= k_valid) q_hi = 0;

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg, bh = b * p.H + h;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dog = static_cast<const T*>(p.dO) + b * p.sdo.b + h * p.sdo.h;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DH>(q_s, qg, p.sq.s, q0, p.Sq);
      load_tile<T, DH>(do_s, dog, p.sdo.s, q0, p.Sq);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q0 + r < p.Sq;
        lse_s[r] = in ? p.lse[(long long)bh * p.Sq + q0 + r] : 0.f;
        dl_s[r] = in ? p.delta[(long long)bh * p.Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      scores<DH>(p, k_valid, q0, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s);
      __syncthreads();
      // dV[key, d] += sum_q P[q, key] dO[q, d];  dK[key, d] += sum_q dS[q, key] Q[q, d]
      // thread (ty, tx) owns keys 4 ty + i and columns tx + 16 c
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * PS + 4 * ty + i];
          sv[i] = ds_s[r * PS + 4 * ty + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[c] = do_s[r * QS + tx + 16 * c];
          qv[c] = q_s[r * QS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
            dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      st(dkg + (long long)kj * p.sdk.s + tx + 16 * c, dk[i][c] * p.scale);
      st(dvg + (long long)kj * p.sdv.s + tx + 16 * c, dv[i][c]);
    }
  }
}

// -- dQ -------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) bwd_dq(Params p) {
  constexpr int QS = DH + 1;
  constexpr int DC = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * QS;
  float* k_s = do_s + BQ * QS;
  float* v_s = k_s + BK * QS;
  float* p_s = v_s + BK * QS;
  float* ds_s = p_s + BQ * PS;
  float* lse_s = ds_s + BQ * PS;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (heaviest causal) tiles first
  const int k_valid = min(p.k_len, p.Sk);

  load_tile<T, DH>(q_s, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.Sq);
  load_tile<T, DH>(do_s, static_cast<const T*>(p.dO) + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0,
                   p.Sq);
  for (int r = tid; r < BQ; r += THREADS) {
    const bool in = q0 + r < p.Sq;
    lse_s[r] = in ? p.lse[(long long)bh * p.Sq + q0 + r] : 0.f;
    dl_s[r] = in ? p.delta[(long long)bh * p.Sq + q0 + r] : 0.f;
  }
  // the keys these rows see, as the forward walks them
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_hi = p.causal ? min(k_valid, q_last + 1) : k_valid;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q, dO are in)
    load_tile<T, DH>(k_s, kg, p.sk.s, k0, p.Sk);
    load_tile<T, DH>(v_s, vg, p.sv.s, k0, p.Sk);
    __syncthreads();
    scores<DH>(p, k_valid, q0, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s);
    __syncthreads();
    // dQ[q, d] += sum_key dS[q, key] K[key, d]; thread owns rows 4 ty + i
#pragma unroll 4
    for (int c0 = 0; c0 < BK; ++c0) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(4 * ty + i) * PS + c0];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[c0 * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) st(dqg + (long long)qi * p.sdq.s + tx + 16 * c, dq[i][c] * p.scale);
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

template <typename T, int DH>
cudaError_t launch(const Params& p, int device, cudaStream_t stream) {
  static std::atomic<bool> set_dkdv[MAX_DEVICES], set_dq[MAX_DEVICES];
  const int q_tiles = (p.Sq + BQ - 1) / BQ, k_tiles = (p.Sk + BK - 1) / BK;
  if (q_tiles > 65535 || k_tiles > 65535) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<DH>();
  bwd_preprocess<T, DH><<<dim3((p.Sq + 7) / 8, p.B * p.H), THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = opt_in_smem(bwd_dkdv<T, DH>, smem, device, set_dkdv)) != cudaSuccess) return err;
  bwd_dkdv<T, DH><<<dim3(p.B * p.KV, k_tiles), THREADS, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in_smem(bwd_dq<T, DH>, smem, device, set_dq)) != cudaSuccess) return err;
  bwd_dq<T, DH><<<dim3(p.B * p.H, q_tiles), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int Dh, int device, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(p, device, stream);
    case 64: return launch<T, 64>(p, device, stream);
    case 128: return launch<T, 128>(p, device, stream);
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
// gradients. `strides` holds, in elements, (batch, head, seq) strides of q,
// k, v, o, dO, dq, dk, dv in that order (24 values); the last (Dh) dim of
// each must be contiguous. lse is the forward's (B, H, Sq) f32 output and
// delta a (B, H, Sq) f32 scratch. Launches the three kernels on `stream`
// of `device` (made the thread's current device for the call, then
// restored). Returns the first launch's error that is not cudaSuccess.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dO,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int device,
    int B, int H, int KV, int Sq, int Sk, int Dh, const long long* strides,
    int causal, int window, int k_len, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1 || (dtype != 0 && dtype != 1))
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
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_dh<__nv_bfloat16>(p, Dh, device, st)
                          : launch_dh<float>(p, Dh, device, st));
}
