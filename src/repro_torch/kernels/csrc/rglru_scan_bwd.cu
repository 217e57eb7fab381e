// Backward of the RG-LRU recurrence for Hopper (sm_90a).
//
// The reference differentiates its chunked scan (repro.kernels.ops.rglru)
// with jax.grad; the Pallas kernel rglru_pallas has no backward.  This is
// the gradient of what rglru_scan.cu computes over exactly T steps,
//
//   log a_t = -c * softplus(log_lam) * sigmoid(a_gate_t)
//   m_t     = sqrt(max(1 - a_t^2, 1e-12))
//   h_t     = a_t * h_{t-1} + m_t * sigmoid(i_gate_t) * x_t,
//
// given dh (B,T,L), the gradient of the h sequence, and an optional dh_T
// (B,L).  With g_t the gradient of h_t, g_t = dh_t + a_{t+1} g_{t+1}
// (seeded by dh_T), and with s = sigmoid:
//
//   dx_t      = g_t m_t s(i_t)
//   di_gate_t = g_t m_t x_t s(i_t) (1 - s(i_t))
//   dlog a_t  = g_t (h_{t-1} a_t + m'_t s(i_t) x_t),  m'_t = -a_t^2 / m_t
//               (0 where the clamp holds, the reference's gradient there)
//   da_gate_t = dlog a_t * (-c softplus(log_lam)) s(a_t) (1 - s(a_t))
//   dlog_lam  = sum_{b,t} dlog a_t * (-c) s(a_gate_t) s(log_lam)
//   dh0       = a_0 g_0.
//
// Design: rglru_scan.cu's chunked structure, reversed.  A block of 8 warps
// owns CH = 64 channels of one batch row and walks T in chunks of TC = 64
// steps from the last chunk to the first; each chunk's x, a_gate, i_gate
// and dh tiles reach shared memory through the same ring of STAGES = 2
// cp.async buffers, filled in reverse order.  LANES = 4 lanes share a
// channel, each over a segment of SEG = 16 steps.  A lane
//   1. recomputes its segment's gates with the forward's ex2 / rcp / sqrt
//      instructions and rebuilds the segment's states from the f32 state
//      the forward saved at the chunk's start (`carries`), with the
//      forward's composition, shuffle scan and re-walk (the bf16 h output
//      is not read);
//   2. composes its segment backwards into (prod a, q), q_t = a_t g_t, and
//      takes a reverse shuffle scan across the 4 lanes, the later chunk's q
//      folded into the last lane; the first lane's result is the earlier
//      chunk's carry, and after the first chunk it is dh0;
//   3. walks its segment backwards, recomputing each step's gates, and
//      writes dx, da_gate and di_gate into the x, a_gate and i_gate tiles,
//      which leave as coalesced stores.
// dlog_lam is summed over time in registers, over the channel's 4 lanes by
// shuffles in a fixed order, and over the batch by a second pass in batch
// order.  There are no cross-channel sums and no atomics: two runs give the
// same bits.
//
// What bounds it.  At the recurrentgemma-9b training shape (B=2, T=3000,
// L=4096, bf16) reading x, a_gate, i_gate and dh and writing dx, da_gate
// and di_gate is 344 MB, about 0.10 ms at 3.35 TB/s; the 13 special-
// function evaluations per element (7 to rebuild h, 6 in the walk) are
// 320M, about 0.08 ms on the special-function units.  Bytes bind.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "scan_sums.cuh"
#include "scan_tiles.cuh"

namespace {

using namespace scan_sums;
using namespace scan_tiles;

// Tile constants, as in rglru_scan.cu and mirrored in rglru_scan.py
// (SEGMENT, LANES, CHANNELS, CHUNK, STAGES) for the CPU tests.
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
  static constexpr int STAGE = 4 * X;             // x, a_gate, i_gate, dh
  static constexpr int SMEM = STAGES * STAGE;
};

// 1 / (1 + exp(-v)), as rglru_scan.cu forms it.
__device__ __forceinline__ float sigmoid(float v) {
  return rcp_approx(1.f + ex2_approx(-v * LOG2E));
}

// One step's gates, as rglru_scan.cu computes them: sigmoid(a_gate), log2
// a, a^2, m and sigmoid(i_gate).
struct Gates {
  float sa, log_a2, e2, mult, si;
};

__device__ __forceinline__ Gates gates(float av, float iv, float neg_c_lam) {
  Gates q;
  q.sa = sigmoid(av);
  q.log_a2 = neg_c_lam * q.sa * LOG2E;
  q.e2 = ex2_approx(2.f * q.log_a2);
  q.mult = sqrt_approx(fmaxf(1.f - q.e2, 1e-12f));
  q.si = sigmoid(iv);
  return q;
}

// One chunk of one lane: segment g of channel c, `live` valid steps (all
// SEG unless MASKED), from the forward's state `carry` entering the chunk
// (lane g == 0) and the later chunk's q carry `qc` (lane g == LANES-1).
// Writes dx, da_gate, di_gate into the x, a_gate, i_gate places in the
// tile, adds the segment's sum of dlog a * s(a_gate) to `lam`, and returns
// the earlier chunk's q carry (to every lane).
template <typename T, bool MASKED>
__device__ __forceinline__ float bwd_chunk(char* st, float neg_c_lam,
                                           float carry, float qc, int g,
                                           int c, int ch, int live,
                                           float& lam) {
  using Ly = Layout<T>;
  char* xs = st;
  char* as = st + Ly::X;
  char* is = st + 2 * Ly::X;
  char* dhs = st + 3 * Ly::X;
  const int src = ((g + LANES - 1) % LANES) * CPW + ch;   // lane g-1
  // 1. gates and the forward's composition of the segment ...
  float a[SEG], h[SEG];
  float P = 1.f, hc = 0.f;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const float xv = to_f32(*at_seg<T, CH, SEG>(xs, g, s, c));
    const Gates q = gates(to_f32(*at_seg<T, CH, SEG>(as, g, s, c)),
                          to_f32(*at_seg<T, CH, SEG>(is, g, s, c)), neg_c_lam);
    const bool ok = !MASKED || s < live;
    a[s] = ok ? ex2_approx(q.log_a2) : 1.f;
    h[s] = ok ? q.mult * (q.si * xv) : 0.f;         // the input, for now
    hc = fmaf(a[s], hc, h[s]);
    P *= a[s];
  }
  const float Pseg = P;
  // ... the lanes' scan, the saved state folded into the first ...
  if (g == 0) hc = fmaf(P, carry, hc);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) {
    const float hp = __shfl_up_sync(FULL, hc, off * CPW);
    const float Pp = __shfl_up_sync(FULL, P, off * CPW);
    if (g >= off) {
      hc = fmaf(P, hp, hc);
      P *= Pp;
    }
  }
  const float nxt = __shfl_sync(FULL, hc, src);
  const float hstart = g == 0 ? carry : nxt;        // h before the segment
  // ... and the re-walk, keeping each h_t.
  hc = hstart;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    hc = fmaf(a[s], hc, h[s]);
    h[s] = hc;
  }
  // 2. compose the segment backwards: q_t = a_t (dh_t + q_{t+1}), then the
  // reverse scan over the lanes, the later chunk's q folded into the last.
  float Q = 0.f;
#pragma unroll
  for (int s = SEG - 1; s >= 0; --s) {
    const bool ok = !MASKED || s < live;
    const float dhv = ok ? to_f32(*at_seg<T, CH, SEG>(dhs, g, s, c)) : 0.f;
    Q = a[s] * (dhv + Q);
  }
  float Pr = Pseg;
  if (g == LANES - 1) Q = fmaf(Pr, qc, Q);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) {
    const float Qn = __shfl_down_sync(FULL, Q, off * CPW);
    const float Pn = __shfl_down_sync(FULL, Pr, off * CPW);
    if (g + off < LANES) {
      Q = fmaf(Pr, Qn, Q);
      Pr *= Pn;
    }
  }
  const float later = __shfl_down_sync(FULL, Q, CPW);
  const float first = __shfl_sync(FULL, Q, ch);     // lane g == 0's
  float q = g == LANES - 1 ? qc : later;
  // 3. walk the segment backwards.
#pragma unroll
  for (int s = SEG - 1; s >= 0; --s) {
    if (MASKED && s >= live) continue;              // identity: q passes
    T* px = at_seg<T, CH, SEG>(xs, g, s, c);
    T* pa = at_seg<T, CH, SEG>(as, g, s, c);
    T* pi = at_seg<T, CH, SEG>(is, g, s, c);
    const float xv = to_f32(*px);
    const Gates gv = gates(to_f32(*pa), to_f32(*pi), neg_c_lam);
    const float gt = to_f32(*at_seg<T, CH, SEG>(dhs, g, s, c)) + q;
    const float hprev = s > 0 ? h[s - 1] : hstart;
    const float gm = gt * gv.mult;
    const float dmult = 1.f - gv.e2 > 1e-12f ? -gv.e2 / gv.mult : 0.f;
    const float dla = gt * fmaf(hprev, a[s], dmult * gv.si * xv);
    lam = fmaf(dla, gv.sa, lam);
    from_f32(px, gm * gv.si);
    from_f32(pi, gm * xv * gv.si * (1.f - gv.si));
    from_f32(pa, dla * neg_c_lam * gv.sa * (1.f - gv.sa));
    q = a[s] * gt;
  }
  return first;
}

// flags: bit 0 rows of x, a_gate, i_gate, dh and the three gradients
// 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) rglru_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ ag,
    const T* __restrict__ ig, const float* __restrict__ log_lam,
    const float* __restrict__ carries, const T* __restrict__ dh,
    const float* __restrict__ dhT, T* __restrict__ dx, T* __restrict__ dag,
    T* __restrict__ dig, float* __restrict__ dh0, float* __restrict__ part,
    int Tn, int L, float cc, int flags) {
  using Ly = Layout<T>;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ncols = min(CH, L - c0);
  const int lane = threadIdx.x % 32;
  const int g = lane / CPW;                         // segment
  const int ch = lane % CPW;
  const int c = (threadIdx.x / 32) * CPW + ch;      // channel in block
  const int l = c0 + c;
  const bool active = l < L;

  float neg_c_lam = 0.f, dsoft = 0.f, qc = 0.f;     // qc: lane g == LANES-1
  if (active) {
    const float v = log_lam[l];
    neg_c_lam = -cc * (v > 20.f ? v : log1pf(expf(v)));   // softplus
    dsoft = 1.f / (1.f + expf(-v));                  // its derivative
    if (dhT != nullptr && g == LANES - 1) qc = dhT[(long)b * L + l];
  }

  zero_smem<THREADS>(smem, Ly::SMEM);
  __syncthreads();

  const bool vec = flags & 1;
  const int nchunks = (Tn + TC - 1) / TC;
  // Chunk nchunks-1-j goes into stage j % STAGES.
  auto prefetch = [&](int j) {
    if (j < nchunks) {
      const int k = nchunks - 1 - j;
      char* st = smem + (j % STAGES) * Ly::STAGE;
      const int nt = min(TC, Tn - k * TC);
      const long off = ((long)b * Tn + (long)k * TC) * L + c0;
      load_tile<T, CH, SEG, THREADS>(st, x + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS>(st + Ly::X, ag + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS>(st + 2 * Ly::X, ig + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS>(st + 3 * Ly::X, dh + off, L, nt, ncols, vec);
    }
    cp_async_commit();                              // empty groups keep count
  };

  float lam = 0.f;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < nchunks; ++j) {
    prefetch(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();                                // the chunk has landed
    const int k = nchunks - 1 - j;
    char* st = smem + (j % STAGES) * Ly::STAGE;
    const int nt = min(TC, Tn - k * TC);
    const float carry =
        active && g == 0 ? carries[((long)b * nchunks + k) * L + l] : 0.f;
    const float first =
        nt == TC
            ? bwd_chunk<T, false>(st, neg_c_lam, carry, qc, g, c, ch, SEG, lam)
            : bwd_chunk<T, true>(st, neg_c_lam, carry, qc, g, c, ch,
                                 nt - g * SEG, lam);
    if (g == LANES - 1) qc = first;
    __syncthreads();
    const long off = ((long)b * Tn + (long)k * TC) * L + c0;
    store_tile<T, CH, SEG, THREADS>(dx + off, st, L, nt, ncols, vec);
    store_tile<T, CH, SEG, THREADS>(dag + off, st + Ly::X, L, nt, ncols, vec);
    store_tile<T, CH, SEG, THREADS>(dig + off, st + 2 * Ly::X, L, nt, ncols, vec);
    __syncthreads();                                // the buffer is free
  }
  // dh0 is the first chunk's q carry; dlog_lam's partial over the batch.
  if (active && g == LANES - 1) dh0[(long)b * L + l] = qc;
  lam += __shfl_xor_sync(FULL, lam, CPW);
  lam += __shfl_xor_sync(FULL, lam, 2 * CPW);
  if (active && g == 0) part[(long)b * L + l] = lam * -cc * dsoft;
}

template <typename T>
cudaError_t launch(const void* x, const void* ag, const void* ig,
                   const float* log_lam, const float* carries, const void* dh,
                   const float* dhT, void* dx, void* dag, void* dig,
                   float* dh0, float* part, int B, int Tn, int L, float c,
                   cudaStream_t stream) {
  constexpr int smem = Layout<T>::SMEM;
  auto kernel = rglru_scan_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long row = (long)L * sizeof(T);
  const int flags = aligned16(x, row) && aligned16(ag, row) &&
                    aligned16(ig, row) && aligned16(dh, row) &&
                    aligned16(dx, row) && aligned16(dag, row) &&
                    aligned16(dig, row) ? 1 : 0;
  dim3 grid((L + CH - 1) / CH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ag),
      static_cast<const T*>(ig), log_lam, carries, static_cast<const T*>(dh),
      dhT, static_cast<T*>(dx), static_cast<T*>(dag), static_cast<T*>(dig),
      dh0, part, Tn, L, c, flags);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a_gate, i_gate, dh, dx, da_gate and
// di_gate share it; log_lam, carries, dhT, dh0, dlog_lam and the scratch
// are float32).  All tensors are contiguous: x, a_gate, i_gate, dh and
// their gradients (B,T,L); log_lam and dlog_lam (L,); dhT and dh0 (B,L);
// carries (B,ceil(T/64),L) as rglru_scan.cu writes them; scratch (B,L).
// dhT may be null (no gradient of h_T).  Returns the first failing launch's
// cudaError_t (0 on success); the kernels run asynchronously on `stream`.
extern "C" int repro_rglru_scan_bwd(
    const void* x, const void* a_gate, const void* i_gate, const void* log_lam,
    const void* carries, const void* dh, const void* dhT, void* dx,
    void* da_gate, void* di_gate, void* dlog_lam, void* dh0, void* scratch,
    int dtype, int B, int T, int L, float c, void* stream) {
  if (B <= 0 || T <= 0 || L <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lam = static_cast<const float*>(log_lam);
  const float* cr = static_cast<const float*>(carries);
  const float* dhTf = static_cast<const float*>(dhT);
  float* dh0f = static_cast<float*>(dh0);
  float* part = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, a_gate, i_gate, lam, cr, dh, dhTf, dx, da_gate,
                        di_gate, dh0f, part, B, T, L, c, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, a_gate, i_gate, lam, cr, dh, dhTf, dx,
                                da_gate, di_gate, dh0f, part, B, T, L, c, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)sum_lead(part, B, L, static_cast<float*>(dlog_lam), st);
}
