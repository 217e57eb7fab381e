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
// Design.  The work per element is light (no state dimension, no sums over
// channels), so what the kernel needs is enough warps to hide the latency
// of its loads and of the dependent steps of a lane.  At the
// recurrentgemma-9b training shape (B=2, L=4096) the earlier kernel ran 128
// blocks of 8 warps, one per SM on 128 of the 132 SMs, 8 warps each.  Here
// a block of 16 warps owns CH = 32 channels of one batch row, and LANES =
// 16 lanes share a channel, each over a segment of SEG = 4 steps of the
// forward's chunks of TC = 64 (a warp holds CPW = 2 channels): 256 blocks
// of 16 warps, two blocks per SM, at least 16 warps on every SM.  The block
// walks T from the last chunk to the first; each chunk's x, a_gate, i_gate
// and dh tiles and the forward's states entering it (`carries`) reach
// shared memory through a ring of STAGES = 3 cp.async buffers, filled in
// reverse order, so two chunks load while one is computed.  The tiles put
// 16 bytes after each segment (scan_tiles.cuh): a warp's 16 segments then
// read 8 banks twice over, but the copies go 16 bytes at a time, which on
// the card beat 8-byte pads with 8-byte copies and no conflicts (PERF.md).
// A lane
//   1. reads its 4 steps of the four tiles once, forms the gates with the
//      forward's ex2 / rcp / sqrt instructions and keeps them in registers,
//      and composes its segment forwards into (prod a, h) and, in the same
//      pass, the backward recurrence into Q = sum_t (a_1...a_t) dh_t, the q
//      the segment passes to the one before (q_t = a_t g_t);
//   2. scans the (prod a, h) pairs forwards across its 16 lanes with the
//      chunk's saved state folded into the first, and the (prod a, Q) pairs
//      backwards with the later chunk's q folded into the last; the first
//      lane's Q is the earlier chunk's carry, and after the first chunk dh0;
//   3. re-walks its states and walks its segment backwards, writing dx,
//      da_gate and di_gate into the x, a_gate and i_gate tiles, which leave
//      as coalesced stores.
// Steps past T read zero x and dh and take a = 1, which makes them the
// identity.  dlog_lam is summed over time in registers, over the channel's
// 16 lanes by a butterfly of shuffles, and over the batch by a second pass
// in batch order.  There are no cross-channel sums and no atomics: two runs
// give the same bits.
//
// What bounds it.  At the training shape reading x, a_gate, i_gate, dh and
// the carries and writing dx, da_gate and di_gate is 345.7 MB, about 0.10
// ms at 3.35 TB/s; the 8 special-function evaluations per element (7 for
// the gates, one reciprocal in m') are 197M, about 0.05 ms on the
// special-function units.  Bytes bind.  On an H100 80GB HBM3 at 700 W
// the kernel takes about 0.17 ms there, 1.65x that bound, and a copy of it
// that only loads and stores its tiles about 0.155 (tools/bench_scans.py,
// tools/ablate_kernels.py --kernel scan_bwd; PERF.md).  63 registers, no
// spills (python -m repro_torch.kernels._build): two blocks per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "scan_sums.cuh"
#include "scan_tiles.cuh"

namespace {

using namespace scan_sums;
using namespace scan_tiles;

// Tile constants, mirrored in rglru_scan.py (BWD_SEGMENT, BWD_LANES,
// BWD_CHANNELS, BWD_STAGES) for the CPU tests; TC is the forward's CHUNK.
constexpr int SEG = 4;                  // steps a lane composes
constexpr int LANES = 16;               // lanes that scan one channel
constexpr int CPW = 32 / LANES;         // channels per warp
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int CH = WARPS * CPW;         // channels per block
constexpr int TC = LANES * SEG;         // steps per chunk
constexpr int STAGES = 3;
constexpr int TPAD = 16;                // bytes after each segment's rows
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Layout {
  static constexpr int X = tile_bytes<T, CH, TC, SEG, TPAD>();
  static constexpr int CR = CH * 4;               // the states entering it
  static constexpr int STAGE = 4 * X + CR;        // x, a_gate, i_gate, dh
  static constexpr int SMEM = STAGES * STAGE;
};

// 1 / (1 + exp(-v)), as rglru_scan.cu forms it.
__device__ __forceinline__ float sigmoid(float v) {
  return rcp_approx(1.f + ex2_approx(-v * LOG2E));
}

template <typename T>
__device__ __forceinline__ T* el(char* tile, int g, int s, int c) {
  return at_seg<T, CH, SEG, TPAD>(tile, g, s, c);
}

// One chunk of one lane: segment g of channel c, with `live` of its steps
// before T; qc is the later chunk's q carry (lane g == LANES-1).  Writes
// dx, da_gate, di_gate into the x, a_gate, i_gate places in the tile, adds
// the segment's sum of dlog a * s(a_gate) to `lam`, and returns the
// earlier chunk's q carry (to every lane).
template <typename T>
__device__ __forceinline__ float bwd_chunk(char* st, float neg_c_lam, float qc,
                                           int g, int c, int ch, int live,
                                           float& lam) {
  using Ly = Layout<T>;
  char* xs = st;
  char* as = st + Ly::X;
  char* is = st + 2 * Ly::X;
  char* dhs = st + 3 * Ly::X;
  const float carry = g == 0 ? reinterpret_cast<const float*>(st + 4 * Ly::X)[c] : 0.f;
  // 1. the gates, kept, and the segment composed both ways.
  float xv[SEG], dh[SEG], a[SEG], h[SEG], sa[SEG], si[SEG], m[SEG], e2[SEG];
  float P = 1.f, hc = 0.f, Q = 0.f;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const bool ok = s < live;
    xv[s] = ok ? to_f32(*el<T>(xs, g, s, c)) : 0.f;
    dh[s] = ok ? to_f32(*el<T>(dhs, g, s, c)) : 0.f;
    sa[s] = sigmoid(to_f32(*el<T>(as, g, s, c)));
    si[s] = sigmoid(to_f32(*el<T>(is, g, s, c)));
    const float log_a2 = neg_c_lam * sa[s] * LOG2E;
    a[s] = ok ? ex2_approx(log_a2) : 1.f;
    e2[s] = ex2_approx(2.f * log_a2);
    m[s] = sqrt_approx(fmaxf(1.f - e2[s], 1e-12f));
    h[s] = m[s] * (si[s] * xv[s]);                  // the input, for now
    hc = fmaf(a[s], hc, h[s]);
    P *= a[s];
    Q = fmaf(P, dh[s], Q);
  }
  // 2. the lanes' scans: forwards with the saved state folded into the
  // first, backwards with the later chunk's q folded into the last.
  float Pf = P;
  if (g == 0) hc = fmaf(P, carry, hc);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) {
    const float hp = __shfl_up_sync(FULL, hc, off * CPW);
    if (2 * off < LANES) {
      const float Pp = __shfl_up_sync(FULL, Pf, off * CPW);
      if (g >= off) {
        hc = fmaf(Pf, hp, hc);
        Pf *= Pp;
      }
    } else if (g >= off) {
      hc = fmaf(Pf, hp, hc);
    }
  }
  const float prev = __shfl_up_sync(FULL, hc, CPW);
  const float hstart = g == 0 ? carry : prev;       // h before the segment
  float Pr = P;
  if (g == LANES - 1) Q = fmaf(P, qc, Q);
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) {
    const float Qn = __shfl_down_sync(FULL, Q, off * CPW);
    if (2 * off < LANES) {
      const float Pn = __shfl_down_sync(FULL, Pr, off * CPW);
      if (g + off < LANES) {
        Q = fmaf(Pr, Qn, Q);
        Pr *= Pn;
      }
    } else if (g + off < LANES) {
      Q = fmaf(Pr, Qn, Q);
    }
  }
  const float later = __shfl_down_sync(FULL, Q, CPW);
  const float first = __shfl_sync(FULL, Q, ch);     // lane g == 0's
  float q = g == LANES - 1 ? qc : later;
  // 3. the states re-walked, then the walk backwards.
  hc = hstart;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    hc = fmaf(a[s], hc, h[s]);
    h[s] = hc;
  }
#pragma unroll
  for (int s = SEG - 1; s >= 0; --s) {
    const float gt = dh[s] + q;
    const float hprev = s > 0 ? h[s - 1] : hstart;
    const float gm = gt * m[s];
    const float dmult = 1.f - e2[s] > 1e-12f ? -e2[s] * rcp_approx(m[s]) : 0.f;
    const float dla = gt * fmaf(hprev, a[s], dmult * si[s] * xv[s]);
    if (s < live) lam = fmaf(dla, sa[s], lam);
    from_f32(el<T>(xs, g, s, c), gm * si[s]);
    from_f32(el<T>(is, g, s, c), gm * xv[s] * si[s] * (1.f - si[s]));
    from_f32(el<T>(as, g, s, c), dla * neg_c_lam * sa[s] * (1.f - sa[s]));
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

  float neg_c_lam = 0.f, qc = 0.f;                  // qc: lane g == LANES-1
  if (active) {
    const float v = log_lam[l];
    neg_c_lam = -cc * (v > 20.f ? v : log1pf(expf(v)));   // softplus
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
      load_tile<T, CH, SEG, THREADS, TPAD>(st, x + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS, TPAD>(st + Ly::X, ag + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS, TPAD>(st + 2 * Ly::X, ig + off, L, nt, ncols, vec);
      load_tile<T, CH, SEG, THREADS, TPAD>(st + 3 * Ly::X, dh + off, L, nt, ncols, vec);
      if (threadIdx.x < ncols)
        cp_async_4(st + 4 * Ly::X + 4 * threadIdx.x,
                   carries + ((long)b * nchunks + k) * L + c0 + threadIdx.x);
    }
    cp_async_commit();                              // empty groups keep count
  };

  float lam = 0.f;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<STAGES - 2>();
    // The chunk has landed, and the stage the next prefetch fills was
    // stored by every thread an iteration ago.
    __syncthreads();
    prefetch(j + STAGES - 1);
    const int k = nchunks - 1 - j;
    char* st = smem + (j % STAGES) * Ly::STAGE;
    const int nt = min(TC, Tn - k * TC);
    const float first = bwd_chunk<T>(st, neg_c_lam, qc, g, c, ch, nt - g * SEG, lam);
    if (g == LANES - 1) qc = first;
    __syncthreads();
    const long off = ((long)b * Tn + (long)k * TC) * L + c0;
    store_tile<T, CH, SEG, THREADS, TPAD>(dx + off, st, L, nt, ncols, vec);
    store_tile<T, CH, SEG, THREADS, TPAD>(dag + off, st + Ly::X, L, nt, ncols, vec);
    store_tile<T, CH, SEG, THREADS, TPAD>(dig + off, st + 2 * Ly::X, L, nt, ncols, vec);
  }
  // dh0 is the first chunk's q carry; dlog_lam's partial over the batch,
  // the 16 segments' sums added pairwise by the butterfly.
  if (active && g == LANES - 1) dh0[(long)b * L + l] = qc;
#pragma unroll
  for (int off = CPW; off < 32; off *= 2) lam += __shfl_xor_sync(FULL, lam, off);
  if (active && g == 0) {
    const float v = log_lam[l];
    part[(long)b * L + l] = lam * -cc * (1.f / (1.f + expf(-v)));
  }
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
