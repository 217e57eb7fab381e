// The fixed-order second pass of the scans' backward kernels
// (ssm_scan_bwd.cu, rglru_scan_bwd.cu), which write f32 partial sums rather
// than adding into one place with atomics, so that two runs give the same
// bits.

#pragma once

#include <cuda_runtime.h>

namespace scan_sums {

// out[j] = sum over k < K of part[k * M + j], in the order k = 0, 1, ...
__global__ void __launch_bounds__(256) sum_lead_kernel(
    const float* __restrict__ part, int K, long M, float* __restrict__ out) {
  for (long j = blockIdx.x * 256L + threadIdx.x; j < M; j += (long)gridDim.x * 256) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += part[k * M + j];
    out[j] = s;
  }
}

inline cudaError_t sum_lead(const float* part, int K, long M, float* out,
                            cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  const long blocks = (M + 255) / 256;
  sum_lead_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      part, K, M, out);
  return cudaGetLastError();
}

}  // namespace scan_sums
