// bf16 tensor-core building blocks for sm_90a, shared by the flash-attention
// forward (flash_attention.cu) and backward (flash_attention_bwd.cu):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix with and without
// transpose, and cp.async copies from device to shared memory.
//
// Fragment layouts are those of the PTX ISA for m16n8k16: lane = 4*g + t;
// A (16x16) holds rows g and g+8, columns 2t,2t+1 and 2t+8,2t+9; B (16x8)
// holds rows (k) 2t,2t+1 and 2t+8,2t+9 of column (n) g; C (16x8) holds rows
// g and g+8, columns 2t,2t+1.  So the accumulators of n-tiles 2j and 2j+1
// of one product, packed to bf16, are the A fragment of k-chunk j of the
// next product; the kernels chain S -> P -> P.V that way, in registers.
//
// Tiles in shared memory are row-major bf16 with rows padded by PAD
// elements (16 bytes): with a row stride of D+8 the eight 16-byte rows an
// ldmatrix reads fall in distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int PAD = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and lane 4g+t receives elements (g, 2t) and (g, 2t+1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: lane 4g+t receives elements (2t, g) and (2t+1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Fragment addresses of one lane, for a row-major tile `base` with row
// stride DP.  A fragment of the 16x16 block at (row r0, column c0):
__device__ __forceinline__ const __nv_bfloat16* a_frag_addr(
    const __nv_bfloat16* base, int DP, int r0, int c0) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, mr = lane & 7;
  return base + (r0 + (mi & 1) * 8 + mr) * DP + c0 + (mi >> 1) * 8;
}
// B fragments of n-tiles n0/8 and n0/8+1 when B[k][n] = tile[n][k] (rows
// n0.. of the tile, columns c0..c0+15 as k); ldmatrix_x4 of it gives
// {b0, b1} of the first n-tile in r[0..1] and of the second in r[2..3].
__device__ __forceinline__ const __nv_bfloat16* bt_frag_addr(
    const __nv_bfloat16* base, int DP, int n0, int c0) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, mr = lane & 7;
  return base + (n0 + (mi >> 1) * 8 + mr) * DP + c0 + (mi & 1) * 8;
}
// B fragments of n-tiles at columns n0 and n0+8 when B[k][n] = tile[k][n]
// (rows k0..k0+15 of the tile as k); ldmatrix_x4_trans of it gives the
// same register order.
__device__ __forceinline__ const __nv_bfloat16* b_frag_addr(
    const __nv_bfloat16* base, int DP, int k0, int n0) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, mr = lane & 7;
  return base + (k0 + (mi & 1) * 8 + mr) * DP + n0 + (mi >> 1) * 8;
}

// 16 bytes from device to shared memory, asynchronously; 16 zero bytes when
// !pred (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4 bytes, as above.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy rows [r0, r0 + ROWS) of a contiguous (B, N, heads, D) bf16 tensor at
// (b, head) into `dst` (row stride D + PAD) with cp.async, NT threads
// sharing the 16-byte chunks; rows at or past N are zero-filled.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int b, int r0, int N,
                                                int heads, int head) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (ROWS * CH % NT != 0 && idx >= ROWS * CH) break;
    const int r = idx / CH, c = idx % CH;
    const int n = r0 + r;
    const bool ok = n < N;
    const __nv_bfloat16* g =
        ok ? src + ((long)(b * N + n) * heads + head) * D + c * 8 : src;
    cp_async_16(dst + r * (D + PAD) + c * 8, g, ok);
  }
}

}  // namespace tc
