// Warp-level tensor-core and asynchronous-copy helpers shared by the
// kernels: the bf16 forms' and, below, the f32 forms' split TF32 (sm_80+
// instructions, built here for sm_90a).
//
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators. Per lane, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major)  a[0] = (g, 2t..2t+1)    a[1] = (g+8, 2t..2t+1)
//                           a[2] = (g, 2t+8..2t+9)  a[3] = (g+8, 2t+8..2t+9)
//   B (16 x 8, k-major)     b[0] = (k 2t..2t+1, n g)  b[1] = (k 2t+8..2t+9, n g)
//   C (16 x 8, f32)         c[0..1] = (g, 2t..2t+1)   c[2..3] = (g+8, 2t..2t+1)
// so the C tiles of two neighbouring n-tiles, rounded to bf16 and packed in
// pairs, are the A operand of a following product over those 16 columns
// (pack_a below): a score tile never leaves registers.
//
// Shared-memory tiles are row-major with rows padded by 8 elements (16
// bytes): each ldmatrix phase then reads 8 rows whose 16-byte pieces fall in
// 8 distinct bank groups, and every row start stays 16-byte aligned for
// cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a false `pred` reads nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// 4 bytes global -> shared (a row statistic); a false `pred` zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Each lane's (row, column) offset into a 16 x 16 block of a row-major tile,
// for the two ldmatrix.x4 addressing patterns:
//  X: ldsm_x4 of an [m][k] block gives the A operand a[0..3];
//     ldsm_x4_trans of a [k][n] block gives B of n-tiles n..n+7 (r[0], r[1])
//     and n+8..n+15 (r[2], r[3]).
//  Y: ldsm_x4 of an [n][k] block gives B of n-tiles n..n+7 (r[0], r[1]) and
//     n+8..n+15 (r[2], r[3]);
//     ldsm_x4_trans of a [k][m] block gives the A operand a[0..3].
__device__ __forceinline__ int x_row(int lane) { return lane & 15; }
__device__ __forceinline__ int x_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int y_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int y_col(int lane) { return ((lane >> 3) & 1) << 3; }

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// the C tiles s0 (columns 0..7) and s1 (columns 8..15) as one A operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s0)[4],
                                       const float (&s1)[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

// The same A operand as a bf16 hi part and a bf16 lo part, hi = bf16(x)
// and lo = bf16(x - hi): two products, hi then lo, into one f32 sum carry
// about 16 bits of each f32 value where one bf16 carries 8.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&s0)[4], const float (&s1)[4]) {
  split_bf16(hi[0], lo[0], s0[0], s0[1]);
  split_bf16(hi[1], lo[1], s0[2], s0[3]);
  split_bf16(hi[2], lo[2], s1[0], s1[1]);
  split_bf16(hi[3], lo[3], s1[2], s1[3]);
}

// -- split TF32: the f32 forms' products (sm_80+) -----------------------------------
//
// mma.sync.m16n8k8 with tf32 operands and f32 accumulators. Per lane, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major)  a[0] = (g, t)  a[1] = (g+8, t)  a[2] = (g, t+4)  a[3] = (g+8, t+4)
//   B (8 x 8, k-major)     b[0] = (k t, n g)  b[1] = (k t+4, n g)
//   C (16 x 8, f32)        as m16n8k16's: c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// An f32 operand x is carried as hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (ties away, cvt.rna), about 22 of f32's 24 bits, and
// a product as hi hi + hi lo + lo hi into one f32 sum; lo lo, under 2^-22
// of the product, is dropped. A C tile feeds a following product over its 8
// columns as that product's A operand with the depth permuted, slot t being
// column 2t and slot t + 4 column 2t + 1 (a_from_c); the B operand of that
// product reads its depth rows in the same order (ld_b_kn).
//
// The f32 tiles in shared memory are row-major with rows of D + 4 floats (D
// a multiple of 32): the row stride is 4 banks mod 32, so each fragment
// load below reads 32 distinct banks, and rows stay 16-byte aligned for
// cp.async.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: half an ulp added to the magnitude, the 13 low bits cleared),
// in two integer instructions; cvt.rna itself read slower (the flash
// attention headers' trials)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(uint32_t& hi, uint32_t& lo, float x) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

struct FragA {  // an A operand as hi and lo parts
  uint32_t hi[4], lo[4];
};
struct FragB {  // a B operand as hi and lo parts
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += A B to about f32 precision: the two small products first, then hi hi
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// the A operand at rows r0.., depth k0.. of a row-major [m][k] tile
template <int LD>
__device__ __forceinline__ FragA ld_a(const float* tile, int r0, int k0, int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + k0 + (lane & 3);
  FragA a;
  split_tf32(a.hi[0], a.lo[0], p[0]);
  split_tf32(a.hi[1], a.lo[1], p[8 * LD]);
  split_tf32(a.hi[2], a.lo[2], p[4]);
  split_tf32(a.hi[3], a.lo[3], p[8 * LD + 4]);
  return a;
}
// the B operand at columns n0.., depth k0.. of an [n][k] tile (B's
// transpose row-major: K in Q K^T)
template <int LD>
__device__ __forceinline__ FragB ld_b_nk(const float* tile, int n0, int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  FragB b;
  split_tf32(b.hi[0], b.lo[0], p[0]);
  split_tf32(b.hi[1], b.lo[1], p[4]);
  return b;
}
// the B operand at depth k0.., columns n0.. of a [k][n] tile (V in P V),
// the depth permuted as a_from_c's
template <int LD>
__device__ __forceinline__ FragB ld_b_kn(const float* tile, int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  FragB b;
  split_tf32(b.hi[0], b.lo[0], p[0]);
  split_tf32(b.hi[1], b.lo[1], p[LD]);
  return b;
}
// a C tile (16 rows x 8 columns) as the A operand of a product over its columns
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  FragA a;
  split_tf32(a.hi[0], a.lo[0], c[0]);
  split_tf32(a.hi[1], a.lo[1], c[2]);
  split_tf32(a.hi[2], a.lo[2], c[1]);
  split_tf32(a.hi[3], a.lo[3], c[3]);
  return a;
}

// rows [r0, r0 + n) of an f32 (seq, D) slice into a tile of rows D + 4
// floats by 16-byte copies from NT threads, zeros from row `len` of the
// slice on
template <int D, int NT>
__device__ __forceinline__ void cp_rows_f32(float* dst, const float* src, long long ss, int r0,
                                            int n, int len) {
  constexpr int CH = D / 4;
  for (int c = threadIdx.x; c < n * CH; c += NT) {
    const int r = c / CH, pc = c % CH, i = r0 + r;
    cp_async16(dst + r * (D + 4) + 4 * pc, src + (long long)min(i, len - 1) * ss + 4 * pc,
               i < len);
  }
}

// -- wgmma (sm_90a) ---------------------------------------------------------------
//
// Warpgroup products over shared-memory tiles laid out in the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes, the
// 16-byte piece c of row r stored at piece c ^ (r % 8), tiles 1024-byte
// aligned. The m64n64k16 accumulator of a warpgroup gives warp w rows
// 16 w .. 16 w + 15 with each thread's d[j][0..3] laid out as mma.sync's C
// tile of columns 8 j .. 8 j + 7, so pack_a turns two of them into a
// register A operand.

__device__ __forceinline__ int swz128(int row, int piece) {
  return row * 128 + ((piece ^ (row & 7)) << 4);
}

// descriptor of a 128-byte-swizzled tile at `smem`: 8-row atoms 1024
// bytes apart (the stride byte offset), leading byte offset unused
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins registers that an asynchronous wgmma wrote at this point, after its
// wait: the compiler may not move their reads above it
template <int R>
__device__ __forceinline__ void fence_regs(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B, A (64 x 16) and B (16 x 64) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16) from registers (each warp its 16 rows, as
// mma.sync's A operand), B (16 x 64) from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B, A (64 x 16) from registers (each warp its 16 rows, as
// mma.sync's A operand), B (16 x 64) from shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// -- wide tiles: 64-column slabs ----------------------------------------------
//
// A tile wider than 64 bf16 columns (head dims 128, 192, 256) is stored as
// Dh / 64 slabs of 64 rows x 64 columns (8 KiB each), each in the 128-byte
// swizzle above and 1 KiB aligned. A product over such a tile's depth
// (K-major) is a chain of m64n64k16 that steps 32 bytes a k-step inside a
// slab and moves to the next slab after four (wg_abt_issue); a product
// whose MN-major operand is such a tile is one m64nNk16 a k-step over all
// of its slabs, the slabs one descriptor's leading byte offset apart
// (sw128_desc_slabs, wgmma_rs_tb_n). Both flash attention kernels use these.

constexpr int SLAB_BYTES = 64 * 128;  // one 64-row slab

// rows [r0, r0 + 64) of a (seq, DH) slice into a slab tile by 16-byte
// copies from NT threads, zeros from row `len` of the slice on
template <int DH, int NT>
__device__ __forceinline__ void cp_slabs(unsigned char* dst, const __nv_bfloat16* src,
                                         long long ss, int r0, int len) {
  constexpr int CH = DH / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += NT) {
    const int r = c / CH, pc = c % CH, i = r0 + r;
    cp_async16(dst + (pc >> 3) * SLAB_BYTES + swz128(r, pc & 7),
               src + (long long)min(i, len - 1) * ss + 8 * pc, i < len);
  }
}

// d += A B with N = 128, 192 or 256 columns: A (64 x 16) from registers as
// in wgmma_rs_tb, B (16 x N) from shared memory, MN-major, as 64-column
// slabs (sw128_desc_slabs); d[j] holds columns 8 j .. 8 j + 7 as
// wgmma_rs_tb's d does, so a [NS][8][4] array of slab accumulators is
// its d for N = 64 NS
template <int N>
__device__ __forceinline__ void wgmma_rs_tb_n(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                              uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_tb_n<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tb_n<192>(float (&d)[24][4], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_tb_n<256>(float (&d)[32][4], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// descriptor of an MN-major operand stored as 64-column slabs in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (the stride byte offset)
// and the slabs, N's 64-column blocks, SLAB_BYTES apart (the leading byte
// offset)
__device__ __forceinline__ uint64_t sw128_desc_slabs(const void* smem) {
  return (sw128_desc(smem) & ~(uint64_t(0x3FFF) << 16)) | (uint64_t(SLAB_BYTES >> 4) << 16);
}

// x (+)= Y Z^T over KS slabs of depth, Y and Z 64-row slab tiles, both
// K-major; issued, not waited for
template <int KS>
__device__ __forceinline__ void wg_abt_issue(float (&x)[8][4], const unsigned char* y,
                                             const unsigned char* z) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t dy = sw128_desc(y + s * SLAB_BYTES);
    const uint64_t dz = sw128_desc(z + s * SLAB_BYTES);
#pragma unroll
    for (int kd = 0; kd < 4; ++kd) wgmma_ss(x, dy + 2 * kd, dz + 2 * kd, s | kd);
  }
}

// -- TMA and mbarriers (sm_90) --------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the barriers' initialisation made visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA copies on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a box of a 4-d tensor map (a __grid_constant__ kernel parameter) into
// shared memory at coordinates c0..c3, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// a warpgroup's register budget: every thread of it executes this
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace tc
