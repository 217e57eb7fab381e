// Time tiles in shared memory for the chunked scans (ssm_scan.cu,
// rglru_scan.cu and their backward kernels): cp.async copies of a chunk's
// rows, and the coalesced write-back of an output tile.
//
// A tile holds `rows` time steps of TW contiguous elements (channels, or
// states), row-major, with PADB bytes after every SEG rows (PAD = 32 unless
// a kernel picks another).  A lane that walks a segment of SEG consecutive
// steps reads rows g*SEG + s; without the pad, the lanes of segments g = 0,
// 1, ... would hit the same banks, and with it segment g starts PADB bytes
// further on: with PAD, the 4 segments of a warp, each 8 lanes on 8
// neighbouring f32 columns, read 32 distinct banks.  PADB is a multiple of
// 16 bytes, so each row stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace scan_tiles {

constexpr int PAD = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
template <typename E> __device__ __forceinline__ E zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Bytes of a tile of ROWS rows of TW elements of E, pads included.
template <typename E, int TW, int ROWS, int SEG, int PADB = PAD>
constexpr int tile_bytes() { return ROWS * TW * (int)sizeof(E) + (ROWS / SEG) * PADB; }

// Byte offset of row r.
template <typename E, int TW, int SEG, int PADB = PAD>
__device__ __forceinline__ int row_off(int r) {
  return r * TW * (int)sizeof(E) + (int)((unsigned)r / SEG) * PADB;
}

template <typename E, int TW, int SEG, int PADB = PAD>
__device__ __forceinline__ E* at(char* tile, int r, int col) {
  return reinterpret_cast<E*>(tile + row_off<E, TW, SEG, PADB>(r)) + col;
}

// Element `col` of row g*SEG + s, for s < SEG: rows of one segment are
// contiguous, so with s known at compile time the address is the segment's
// base plus an immediate.
template <typename E, int TW, int SEG, int PADB = PAD>
__device__ __forceinline__ E* at_seg(char* tile, int g, int s, int col) {
  constexpr int ROW = TW * (int)sizeof(E);
  return reinterpret_cast<E*>(tile + g * (SEG * ROW + PADB) + s * ROW) + col;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

// 4 bytes (cp.async.ca: .cg copies only 16).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, nt) and columns [0, ncols) of the matrix at `src` (row stride ld
// elements) into `tile`, by NT threads.  With `vec` (src and ld 16-byte
// aligned, checked by the caller) and a 16-byte multiple of bytes per row,
// as cp.async copies of 16 bytes that complete asynchronously; otherwise as
// plain loads and stores, element by element, that write zeros past ncols.
// Rows past nt and, on the cp.async route, columns past ncols are left as
// they were.
template <typename E, int TW, int SEG, int NT, int PADB = PAD>
__device__ __forceinline__ void load_tile(char* tile, const E* __restrict__ src,
                                          long ld, int nt, int ncols, bool vec) {
  static_assert(PADB % 16 == 0, "rows stay 16-byte aligned");
  constexpr int PIECES = TW * (int)sizeof(E) / 16;  // of a whole row
  if (vec && (ncols * (int)sizeof(E)) % 16 == 0) {
    const int pieces = ncols * (int)sizeof(E) / 16;
    for (int k = threadIdx.x; k < nt * PIECES; k += NT) {
      const int r = (unsigned)k / PIECES, p = (unsigned)k % PIECES;
      if (p < pieces)
        cp_async_16(tile + row_off<E, TW, SEG, PADB>(r) + 16 * p,
                    reinterpret_cast<const char*>(src + r * ld) + 16 * p);
    }
  } else {
    for (int k = threadIdx.x; k < nt * TW; k += NT) {
      const int r = (unsigned)k / TW, c = (unsigned)k % TW;
      *at<E, TW, SEG, PADB>(tile, r, c) = c < ncols ? src[r * ld + c] : zero<E>();
    }
  }
}

// Rows [0, nt) and columns [0, ncols) of `tile` to the matrix at `dst` (row
// stride ld elements), 16 bytes a thread where `vec` allows, by NT threads.
template <typename E, int TW, int SEG, int NT, int PADB = PAD>
__device__ __forceinline__ void store_tile(E* __restrict__ dst, const char* tile,
                                           long ld, int nt, int ncols, bool vec) {
  constexpr int PIECES = TW * (int)sizeof(E) / 16;
  if (vec && (ncols * (int)sizeof(E)) % 16 == 0) {
    const int pieces = ncols * (int)sizeof(E) / 16;
    for (int k = threadIdx.x; k < nt * PIECES; k += NT) {
      const int r = (unsigned)k / PIECES, p = (unsigned)k % PIECES;
      if (p < pieces)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst + r * ld) + 16 * p) =
            *reinterpret_cast<const uint4*>(tile + row_off<E, TW, SEG, PADB>(r) + 16 * p);
    }
  } else {
    for (int k = threadIdx.x; k < nt * TW; k += NT) {
      const int r = (unsigned)k / TW, c = (unsigned)k % TW;
      if (c < ncols)
        dst[r * ld + c] = *at<E, TW, SEG, PADB>(const_cast<char*>(tile), r, c);
    }
  }
}

// Zero `bytes` (a multiple of 16) of shared memory at `p`, by NT threads.
template <int NT>
__device__ __forceinline__ void zero_smem(char* p, int bytes) {
  for (int k = threadIdx.x; k < bytes / 16; k += NT)
    reinterpret_cast<uint4*>(p)[k] = make_uint4(0, 0, 0, 0);
}

// One special-function instruction each (MUFU): 2^x, 1/x and sqrt(x),
// with denormal inputs and results flushed to zero.  Relative error about
// 2^-22, far inside the 1e-4 the scans are held to.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether a pointer and a row of `row_bytes` keep 16-byte alignment.
inline bool aligned16(const void* p, long row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

}  // namespace scan_tiles
