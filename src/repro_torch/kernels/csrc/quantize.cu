// Symmetric per-row int8 quantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_quant_kernel` / `quantize_pallas`
// (src/repro/kernels/quantize.py).  Same function: for each row of x (R,C),
// amax = max |x|, scale = amax / 127 (1 when amax == 0),
// q = clip(round(x / scale), -127, 127) as int8; scale is written as f32
// (R,1).  x is f32 or bf16 and is read in f32 (the bf16 upcast is exact).
//
// The codes must equal the reference's bit for bit, so the arithmetic is
// the reference's: true IEEE division for amax / 127 and for x / scale
// (never a multiply by a reciprocal; the build has no --use_fast_math), and
// round half to even (rintf), as jnp.round.
//
// Design: one block of 256 threads per row.  The block reads its row once
// with a strided loop for the max of |x| (warp shuffles, then one value per
// warp through shared memory), then reads it again to write the codes; the
// second read of a row of at most a few KB comes from L1/L2.  The TPU kernel
// kept a whole row block in VMEM for both passes; here a row's two passes
// are one block's.
//
// Bound on an H100 SXM at the main-path leaf (R, C) = (36864, 1024) f32:
// reading x once (151 MB) and writing the codes (37.7 MB) and scales is
// 189 MB, about 56 us at 3.35 TB/s; the arithmetic (one compare, one
// division, one rint per element) is far below that.  So it is bound by
// bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int C) {
  __shared__ float warp_max[THREADS / 32];
  __shared__ float row_scale;
  const long base = (long)blockIdx.x * C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float amax = 0.f;
  for (int c = tid; c < C; c += THREADS) amax = fmaxf(amax, fabsf(load_f32(x, base + c)));
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, w));
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float s = m > 0.f ? m / 127.0f : 1.0f;     // IEEE division
    row_scale = s;
    scale[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = row_scale;
  for (int c = tid; c < C; c += THREADS) {
    const float r = rintf(load_f32(x, base + c) / s);  // half to even
    q[base + c] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int R, int C,
                   cudaStream_t stream) {
  quantize_kernel<T><<<R, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x).  x (R,C) and q (R,C) int8 are
// contiguous; scale is (R,) f32.  Returns the launch's cudaError_t (0 on
// success); the kernel runs asynchronously on `stream`.
extern "C" int repro_quantize_fwd(const void* x, void* q, void* scale,
                                  int dtype, int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, q, scale, R, C, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, q, scale, R, C, st);
  return (int)cudaErrorInvalidValue;
}
