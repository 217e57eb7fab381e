// Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssm_kernel` / `ssm_scan_pallas`
// (src/repro/kernels/ssm_scan.py).  It computes what the plain version
// `ssm_scan_ref` (src/repro_torch/kernels/ref.py) computes:
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      (per channel i)
//   y_t = C_t . h_t + D * x_t
//
// with x, dt (Bt,T,I), A (I,N), B, C (Bt,T,N), D (I,), an optional h0
// (Bt,I,N), y (Bt,T,I) in the dtype of x and h_T (Bt,I,N) in f32.  All math
// is f32.  Unlike the Pallas kernel, it takes h0, and it adds D*x in f32
// before y is rounded to the dtype of x, as the plain version does.
//
// Design.  One thread per (batch, channel) pair holds that channel's N <= 16
// states in registers and walks all T steps; blocks of 128 threads cover 128
// neighbouring channels of one batch row.  The alternative, one thread per
// (batch, channel, state) with a 16-lane shuffle reduction for y, has 16x the
// threads but needs 4 shuffles per state and step for the reduction; here y
// is a chain of 16 FMAs in one thread, and the 16 independent exponentials
// of a step give each thread its own instruction-level parallelism.  The
// walk goes in tiles of TT steps: each thread first loads its TT values of x
// and dt (coalesced across the block's channels, all in flight together),
// and the block stages B_t and C_t of the tile in shared memory, since every
// channel of a batch row reads the same ones.  A state slot n >= N is padded
// with A = B = C = 0: it stays 0 and adds nothing, so no loop is guarded.
//
// Bound on an H100 SXM at the falcon-mamba-7b prefill shape (Bt=4, T=1024,
// I=8192, N=16, x and y bf16, dt f32): Bt*T*I*N = 537M exponentials on the
// special-function units (16 per clock per SM) take about 0.13 ms, against
// about 0.08 ms to move the 271 MB of inputs and outputs at 3.35 TB/s, so the
// exponentials bind.  exp(dt*A) is computed as exp2f(dt * A*log2(e)), one
// multiply and one ex2 each.  The walk over T is sequential, so the card is
// filled only by Bt*I/128 = 256 blocks; a split-T parallel scan is the next
// step (ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // channels per block
constexpr int TT = 16;          // time steps per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    int Tn, int I, int N) {
  __shared__ float Bs[TT][NMAX];
  __shared__ float Cs[TT][NMAX];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool active = i < I;

  float a2[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    const bool live = active && n < N;
    a2[n] = live ? A[(long)i * N + n] * LOG2E : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[((long)b * I + i) * N + n] : 0.f;
  }
  const float d = active ? Dv[i] : 0.f;
  const long row0 = (long)b * Tn;     // first (b, t) row of this batch

  for (int t0 = 0; t0 < Tn; t0 += TT) {
    const int nt = min(TT, Tn - t0);
    __syncthreads();                  // the previous tile's B, C are read
    for (int k = threadIdx.x; k < TT * NMAX; k += THREADS) {
      const int s = k / NMAX, n = k % NMAX;
      const bool live = s < nt && n < N;
      const long off = (row0 + t0 + s) * N + n;
      Bs[s][n] = live ? Bm[off] : 0.f;
      Cs[s][n] = live ? Cm[off] : 0.f;
    }
    float xv[TT], dv[TT];
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      const bool live = active && s < nt;
      const long off = (row0 + t0 + s) * I + i;
      xv[s] = live ? to_f32(x[off]) : 0.f;
      dv[s] = live ? dt[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      if (s < nt) {                   // uniform across the block
        const float dtx = dv[s] * xv[s];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          const float dA = exp2f(dv[s] * a2[n]);
          h[n] = fmaf(dA, h[n], dtx * Bs[s][n]);
          acc = fmaf(h[n], Cs[s][n], acc);
        }
        if (active) from_f32(&y[(row0 + t0 + s) * I + i], acc + d * xv[s]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hT[((long)b * I + i) * N + n] = h[n];
  }
}

template <typename T, int NMAX>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv,
                   const float* h0, void* y, float* hT, int Bt, int Tn, int I,
                   int N, cudaStream_t stream) {
  dim3 grid((I + THREADS - 1) / THREADS, Bt);
  ssm_scan_kernel<T, NMAX><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, Dv, h0, static_cast<T*>(y), hT,
      Tn, I, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* Dv,
                       const float* h0, void* y, float* hT, int Bt, int Tn,
                       int I, int N, cudaStream_t st) {
  if (N <= 4) return launch<T, 4>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, Tn, I, N, st);
  if (N <= 8) return launch<T, 8>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, Tn, I, N, st);
  return launch<T, 16>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, Tn, I, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; every other tensor is
// float32).  All tensors are contiguous: x, dt, y (Bt,T,I); A (I,N); B, C
// (Bt,T,N); D (I,); h0 and hT (Bt,I,N).  h0 may be null (zero state).
// Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_ssm_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    int dtype, int Bt, int T, int I, int N, void* stream) {
  if (Bt <= 0 || T <= 0 || I <= 0 || N <= 0 || N > 16 || Bt > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == 0)
    return (int)dispatch_n<float>(x, dtf, Af, Bf, Cf, Df, h0f, y, hTf, Bt, T, I, N, st);
  if (dtype == 1)
    return (int)dispatch_n<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, h0f, y, hTf, Bt, T, I, N, st);
  return (int)cudaErrorInvalidValue;
}
