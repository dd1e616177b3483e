// Warp-level tensor-core and asynchronous-copy helpers shared by the bf16
// kernels (sm_80+ instructions, built here for sm_90a).
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

}  // namespace tc
