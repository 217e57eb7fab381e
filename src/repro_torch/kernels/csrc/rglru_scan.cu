// RG-LRU gated linear recurrence for Hopper (sm_90a), parallel over time.
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
// T % time_chunk != 0; this kernel walks exactly T steps, and steps of its
// last chunk past T are identity (a = 1, input 0).
//
// What bounds it.  At the recurrentgemma-9b prefill shape (B=4, T=3000,
// L=4096, bf16) reading three inputs and writing one output once is 393 MB,
// about 0.12 ms at 3.35 TB/s on an H100 SXM; the 7 special-function
// evaluations per element (4 ex2, 2 reciprocals, 1 square root) are 344M,
// about 0.08 ms on the special-function units (16 per clock per SM).  Bytes
// bind, so the design keeps many bytes in flight and lets every thread
// compute gates.
//
// Design.  A block of 8 warps owns CH = 64 channels of one batch row and
// walks T in chunks of TC = 64 steps.  Each chunk's x, a_gate and i_gate
// tiles (TC x CH, 8 KB each in bf16) reach shared memory through a ring of
// STAGES = 2 buffers filled by cp.async, so the next chunk's 24 KB load
// while this one is computed; two blocks per SM keep about 50 KB in flight,
// against the ~25 KB per SM that covers DRAM latency at full rate, and the
// 256 blocks of the main shape are all resident at once, so no wave is left
// partly empty.  cp.async rather than TMA for the reasons given in
// ssm_scan.cu; unaligned rows take plain loads into the same tiles.  Inside
// a chunk, LANES = 4 lanes share one channel, each over a segment of SEG =
// 16 consecutive steps, CPW = 8 channels a warp (lane = segment * CPW +
// channel).  Each lane computes its 16 steps' gates (a_t, input_t) at once,
// independent of h, with one special-function instruction per ex2,
// reciprocal and square root, and composes them into one (prod a, h) pair;
// a shuffle scan over the 4 lanes, (a1,b1) o (a2,b2) = (a1*a2, a2*b1 + b2),
// with the channel's carry from the previous chunk folded into the first
// lane, gives each lane its starting state; it re-walks its segment with the
// gates still in registers and writes h into x's place in the tile.  The
// tile then leaves as 16-byte coalesced stores.  The last lane's state is
// the next chunk's carry, and after the last chunk it is h_T, written once
// in f32.  The 32-byte pad after every SEG rows (scan_tiles.cuh) puts the
// 4 segments of a warp on distinct banks.  On an H100 80GB HBM3 at 700 W
// the main shape takes about 0.143 ms (chip_smoke.py phase 6), 1.2x its
// byte bound, with 95 registers and no spills
// (python -m repro_torch.kernels._build).
//
// Training asks for one more output, `carries` (B, ceil(T/TC), L) f32: the
// state entering each chunk, which rglru_scan_bwd.cu rebuilds the chunk's
// states from.  The kernel is templated on whether it writes them, so a
// call without them (serving) runs the code it ran before.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "scan_tiles.cuh"

namespace {

using namespace scan_tiles;

// Tile constants, mirrored in rglru_scan.py (SEGMENT, LANES, CHANNELS,
// CHUNK, STAGES) for the CPU tests.
constexpr int SEG = 16;                 // steps a lane composes
constexpr int LANES = 4;                // lanes that scan one channel
constexpr int CPW = 32 / LANES;         // channels per warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CH = WARPS * CPW;         // channels per block
constexpr int TC = LANES * SEG;         // steps per chunk
constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Layout {
  static constexpr int X = tile_bytes<T, CH, TC, SEG>();
  static constexpr int STAGE = 3 * X;             // x, a_gate, i_gate
  static constexpr int SMEM = STAGES * STAGE;
};

// 1 / (1 + exp(-v)): two special-function instructions.
__device__ __forceinline__ float sigmoid(float v) {
  return rcp_approx(1.f + ex2_approx(-v * LOG2E));
}

// One chunk of one lane: segment g of channel c, `live` valid steps (all
// SEG unless MASKED), from the carry h_in of the first lane (g == 0).
// Writes h into x's place in the tile; returns the next carry (in lane
// g == 0).
template <typename T, bool MASKED>
__device__ __forceinline__ float scan_chunk(char* st, float neg_c_lam,
                                            float carry, int g, int c, int src,
                                            int live) {
  using Ly = Layout<T>;
  // Gates of the segment, and their composition into (prod a, h).
  float a[SEG], u[SEG];
  float P = 1.f, h = 0.f;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const float xv = to_f32(*at_seg<T, CH, SEG>(st, g, s, c));
    const float av = to_f32(*at_seg<T, CH, SEG>(st + Ly::X, g, s, c));
    const float iv = to_f32(*at_seg<T, CH, SEG>(st + 2 * Ly::X, g, s, c));
    const float log_a2 = neg_c_lam * sigmoid(av) * LOG2E;   // log2(a)
    const float mult = sqrt_approx(fmaxf(1.f - ex2_approx(2.f * log_a2), 1e-12f));
    const bool v = !MASKED || s < live;
    a[s] = v ? ex2_approx(log_a2) : 1.f;
    u[s] = v ? mult * (sigmoid(iv) * xv) : 0.f;
    h = fmaf(a[s], h, u[s]);
    P *= a[s];
  }
  // Scan the LANES segments of the channel, the carry folded into the first.
  if (g == 0) h = fmaf(P, carry, h);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) {
    const float hp = __shfl_up_sync(FULL, h, off * CPW);
    const float Pp = __shfl_up_sync(FULL, P, off * CPW);
    if (g >= off) {
      h = fmaf(P, hp, h);
      P *= Pp;
    }
  }
  // The first lane keeps the last lane's state as the next carry and
  // starts from the old one; lane g starts from lane g-1's.
  const float nxt = __shfl_sync(FULL, h, src);
  h = g == 0 ? carry : nxt;
  // Re-walk the segment; h goes into x's place in the tile.
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    h = fmaf(a[s], h, u[s]);
    if (!MASKED || s < live) from_f32(at_seg<T, CH, SEG>(st, g, s, c), h);
  }
  return nxt;
}

// flags: bit 0 rows of x, a_gate, i_gate and y 16-byte aligned.
// SAVE: write the state entering each chunk to `carries`.
template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS, 2) rglru_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ ag,
    const T* __restrict__ ig, const float* __restrict__ log_lam,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    float* __restrict__ carries, int Tn, int L, float cc, int flags) {
  using Ly = Layout<T>;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ncols = min(CH, L - c0);
  const int lane = threadIdx.x % 32;
  const int g = lane / CPW;                         // segment
  const int c = (threadIdx.x / 32) * CPW + lane % CPW;   // channel in block
  const int src = ((g + LANES - 1) % LANES) * CPW + lane % CPW;
  const int l = c0 + c;
  const bool active = l < L;

  float neg_c_lam = 0.f, carry = 0.f;               // carry: lane g == 0
  if (active) {
    const float v = log_lam[l];
    neg_c_lam = -cc * (v > 20.f ? v : log1pf(expf(v)));   // softplus
    carry = h0 != nullptr ? h0[(long)b * L + l] : 0.f;
  }

  zero_smem<THREADS>(smem, Ly::SMEM);
  __syncthreads();

  const bool vec = flags & 1;
  const int nchunks = (Tn + TC - 1) / TC;
  auto prefetch = [&](int k) {
    if (k < nchunks) {
      char* st = smem + (k % STAGES) * Ly::STAGE;
      const int nt = min(TC, Tn - k * TC);
      const long off = ((long)b * Tn + (long)k * TC) * L + c0;
      load_tile<T, CH, SEG, THREADS>(st, x + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS>(st + Ly::X, ag + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS>(st + 2 * Ly::X, ig + off, L, nt, ncols, vec);
    }
    cp_async_commit();                              // empty groups keep count
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) prefetch(k);
  for (int k = 0; k < nchunks; ++k) {
    prefetch(k + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();                                // chunk k has landed
    if (SAVE && active && g == 0)        // the state entering chunk k
      carries[((long)b * nchunks + k) * L + l] = carry;
    char* st = smem + (k % STAGES) * Ly::STAGE;
    const int nt = min(TC, Tn - k * TC);
    const float nxt =
        nt == TC ? scan_chunk<T, false>(st, neg_c_lam, carry, g, c, src, SEG)
                 : scan_chunk<T, true>(st, neg_c_lam, carry, g, c, src, nt - g * SEG);
    if (g == 0) carry = nxt;
    __syncthreads();
    store_tile<T, CH, SEG, THREADS>(y + ((long)b * Tn + (long)k * TC) * L + c0,
                                    st, L, nt, ncols, vec);
    __syncthreads();                                // the buffer is free
  }
  if (active && g == 0) hT[(long)b * L + l] = carry;
}

template <typename T>
cudaError_t launch(const void* x, const void* ag, const void* ig,
                   const float* log_lam, const float* h0, void* y, float* hT,
                   float* carries, int B, int Tn, int L, float c,
                   cudaStream_t stream) {
  constexpr int smem = Layout<T>::SMEM;
  auto kernel = carries != nullptr ? rglru_scan_kernel<T, true>
                                   : rglru_scan_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long row = (long)L * sizeof(T);
  const int flags = aligned16(x, row) && aligned16(ag, row) &&
                    aligned16(ig, row) && aligned16(y, row) ? 1 : 0;
  dim3 grid((L + CH - 1) / CH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ag),
      static_cast<const T*>(ig), log_lam, h0, static_cast<T*>(y), hT, carries,
      Tn, L, c, flags);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a_gate, i_gate and y share it;
// log_lam, h0, hT and carries are float32).  All tensors are contiguous: x,
// a_gate, i_gate, y (B,T,L); log_lam (L,); h0 and hT (B,L); carries
// (B,ceil(T/64),L).  h0 may be null (zero state); carries may be null (not
// written).  Returns the launch's cudaError_t (0 on success); the kernel
// runs asynchronously on `stream`.
extern "C" int repro_rglru_scan_fwd(
    const void* x, const void* a_gate, const void* i_gate, const void* log_lam,
    const void* h0, void* y, void* hT, void* carries, int dtype, int B, int T,
    int L, float c, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lam);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  float* cr = static_cast<float*>(carries);
  if (dtype == 0)
    return (int)launch<float>(x, a_gate, i_gate, lam, h0f, y, hTf, cr, B, T, L, c, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, a_gate, i_gate, lam, h0f, y, hTf, cr, B, T, L, c, st);
  return (int)cudaErrorInvalidValue;
}
