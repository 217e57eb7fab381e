// The fixed-order second pass of the scans' backward kernels
// (ssm_scan_bwd.cu, rglru_scan_bwd.cu), which write f32 partial sums rather
// than adding into one place with atomics, so that two runs give the same
// bits.

#pragma once

#include <cuda_runtime.h>

namespace scan_sums {

constexpr int SLICES = 8;               // ranges of partials a column is cut into
constexpr int COLS = 32;                // columns a block sums

// out[j] = sum over k < K of part[k * M + j], in a fixed order: k is cut
// into SLICES contiguous ranges of ceil(K / SLICES) (the last ones shorter
// or empty), each range is summed in order k = first, first + 1, ..., and
// the ranges' sums are added in range order.  For K <= SLICES that is the
// order k = 0, 1, ...  A block of COLS x SLICES threads takes COLS columns:
// each warp one range of 32 neighbouring columns, so every load is
// coalesced, with SLICES times the loads in flight of one thread a column.
__global__ void __launch_bounds__(COLS * SLICES) sum_lead_kernel(
    const float* __restrict__ part, int K, long M, float* __restrict__ out) {
  __shared__ float sums[SLICES][COLS];
  const int col = threadIdx.x % COLS, sl = threadIdx.x / COLS;
  const int per = (K + SLICES - 1) / SLICES;
  const int k0 = min(K, sl * per), k1 = min(K, k0 + per);
  for (long j0 = (long)blockIdx.x * COLS; j0 < M; j0 += (long)gridDim.x * COLS) {
    const long j = j0 + col;
    float s = 0.f;
    if (j < M)
      for (int k = k0; k < k1; ++k) s += part[k * M + j];
    sums[sl][col] = s;
    __syncthreads();
    if (sl == 0 && j < M) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < SLICES; ++i) t += sums[i][col];
      out[j] = t;
    }
    __syncthreads();
  }
}

inline cudaError_t sum_lead(const float* part, int K, long M, float* out,
                            cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  const long blocks = (M + COLS - 1) / COLS;
  sum_lead_kernel<<<(int)(blocks < 8192 ? blocks : 8192), COLS * SLICES, 0, stream>>>(
      part, K, M, out);
  return cudaGetLastError();
}

}  // namespace scan_sums
