// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_pallas`
// (src/repro/kernels/rglru_scan.py).  It computes what the plain version
// `rglru_ref` (src/repro_torch/kernels/ref.py) computes, over exactly T
// steps:
//
//   a_t = exp(-c * softplus(log_lam) * sigmoid(a_gate_t))
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * sigmoid(i_gate_t) * x_t
//
// with x, a_gate, i_gate (B,T,L) in one dtype, log_lam (L,) f32, an optional
// h0 (B,L) f32, the h sequence (B,T,L) in the dtype of x and h_T (B,L) in
// f32.  All gate math is f32.  The Pallas wrapper pads T to a multiple of its
// time chunk without masking the padded steps, so its h_T is wrong when
// T % time_chunk != 0; this kernel has no padded steps.
//
// Design.  One thread per (batch, channel) pair walks all T steps; the only
// dependence from one step to the next is the FMA on h.  The walk goes in
// tiles of TT steps held in registers: the next tile's x, a_gate and i_gate
// are loaded (coalesced across channels) before the current tile is
// computed, so loads stay in flight under the arithmetic, and the gates of
// the TT steps of a tile are independent of h, which gives each thread
// instruction-level parallelism for the exponentials.
//
// Bound on an H100 SXM at the recurrentgemma-9b prefill shape (B=4, T=3000,
// L=4096, bf16): reading three inputs and writing one output once is 393 MB,
// about 0.12 ms at 3.35 TB/s; the 7 special-function evaluations per element
// (4 exp, 2 reciprocals, 1 sqrt) are 344M, about 0.08 ms on the
// special-function units (16 per clock per SM), so bytes bind.  Only B*L =
// 16384 threads walk the sequence, about 4 warps per SM, so the kernel is
// bound by latency before either; a split-T parallel scan is the next step
// (ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;     // channels per block
constexpr int TT = 16;          // time steps per register tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__device__ __forceinline__ void load_tile(T (&xs)[TT], T (&as)[TT], T (&is)[TT],
                                          const T* x, const T* ag, const T* ig,
                                          long off, long stride, int nt) {
#pragma unroll
  for (int s = 0; s < TT; ++s) {
    if (s < nt) {
      xs[s] = x[off + s * stride];
      as[s] = ag[off + s * stride];
      is[s] = ig[off + s * stride];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ ag,
    const T* __restrict__ ig, const float* __restrict__ log_lam,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    int Tn, int L, float c) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= L) return;               // no shared memory and no barriers

  const float v = log_lam[l];
  const float lam = v > 20.f ? v : log1pf(expf(v));   // softplus
  const float neg_c_lam = -c * lam;
  float h = h0 != nullptr ? h0[(long)b * L + l] : 0.f;
  const long base = (long)b * Tn * L + l;

  T cx[TT], ca[TT], ci[TT], nx[TT], na[TT], ni[TT];
  load_tile(cx, ca, ci, x, ag, ig, base, L, min(TT, Tn));
  for (int t0 = 0; t0 < Tn; t0 += TT) {
    const int nt = min(TT, Tn - t0);
    if (t0 + TT < Tn)
      load_tile(nx, na, ni, x, ag, ig, base + (long)(t0 + TT) * L, L,
                min(TT, Tn - t0 - TT));
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      if (s < nt) {
        const float log_a = neg_c_lam * sigmoid(to_f32(ca[s]));
        const float a = expf(log_a);
        const float mult = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
        const float inp = mult * (sigmoid(to_f32(ci[s])) * to_f32(cx[s]));
        h = fmaf(a, h, inp);
        from_f32(&y[base + (long)(t0 + s) * L], h);
      }
    }
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      cx[s] = nx[s];
      ca[s] = na[s];
      ci[s] = ni[s];
    }
  }
  hT[(long)b * L + l] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* ag, const void* ig,
                   const float* log_lam, const float* h0, void* y, float* hT,
                   int B, int Tn, int L, float c, cudaStream_t stream) {
  dim3 grid((L + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ag),
      static_cast<const T*>(ig), log_lam, h0, static_cast<T*>(y), hT, Tn, L, c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a_gate, i_gate and y share it;
// log_lam, h0 and hT are float32).  All tensors are contiguous: x, a_gate,
// i_gate, y (B,T,L); log_lam (L,); h0 and hT (B,L).  h0 may be null (zero
// state).  Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_rglru_scan_fwd(
    const void* x, const void* a_gate, const void* i_gate, const void* log_lam,
    const void* h0, void* y, void* hT, int dtype, int B, int T, int L,
    float c, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lam);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == 0)
    return (int)launch<float>(x, a_gate, i_gate, lam, h0f, y, hTf, B, T, L, c, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, a_gate, i_gate, lam, h0f, y, hTf, B, T, L, c, st);
  return (int)cudaErrorInvalidValue;
}
