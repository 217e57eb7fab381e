// Backward of the mamba1 selective scan for Hopper (sm_90a).
//
// The reference differentiates its chunked scan (repro.kernels.ops.ssm_scan)
// with jax.grad; the Pallas kernel ssm_scan_pallas has no backward.  This is
// the gradient of what ssm_scan.cu computes,
//
//   h_t = a_t * h_{t-1} + dt_t * B_t * x_t,   a_t = exp(dt_t * A)
//   y_t = C_t . h_t + D * x_t                  (per channel i, state n)
//
// given dy (Bt,T,I) and an optional dh_T (Bt,I,N).  With g_t the gradient
// of h_t, g_t = C_t dy_t + a_{t+1} g_{t+1} (g seeded by dh_T), the same
// linear recurrence run backwards with the a's shifted by one step, and
//
//   dC_t   = sum_i dy_t h_t                 dB_t = sum_i g_t dt_t x_t
//   ddt_t  = sum_n g_t (h_{t-1} a_t A + B_t x_t)
//   dx_t   = sum_n g_t dt_t B_t + D dy_t    dD   = sum_{b,t} dy_t x_t
//   dA     = sum_{b,t} g_t h_{t-1} a_t dt_t dh0  = a_0 g_0.
//
// Design: ssm_scan.cu's chunked structure, reversed.  A block of 8 warps
// owns CH = 64 channels of one batch row and walks T in chunks of TC = 64
// steps from the last chunk to the first; each chunk's x, dt and dy tiles
// and B, C rows reach shared memory through the same ring of STAGES = 2
// cp.async buffers, filled in reverse order.  LANES = 4 lanes share a
// channel, each over a segment of SEG = 16 steps.  For each state n a lane
//   1. rebuilds its segment's states from the state the forward saved at
//      the chunk's start (`carries`, written by ssm_scan.cu when asked):
//      the forward's own composition, shuffle scan and re-walk, with the
//      forward's ex2(dt*A*log2(e)), so it sees the forward's a_t and h_t.
//      The states stay in registers (a chunk's states at 64 channels x 16
//      states are 256 KB, more than shared memory holds);
//   2. composes its segment backwards into a pair (prod a, q), where q_t =
//      a_t g_t is what step t passes to t-1, and takes a reverse shuffle
//      scan of the pairs across the 4 lanes, the later chunk's q folded
//      into the last lane; the first lane's result is the earlier chunk's
//      carry, and after the first chunk it is dh0;
//   3. walks its segment backwards, forming g_t and every term above.
// ddt and dx are summed over n in registers and leave through the x and dt
// tiles as coalesced stores.  dB and dC are sums over channels: each warp
// sums its 8 channels with a reduce-scatter of shuffles (each lane ends
// with 2 of the 16 steps), the 8 warps' sums meet in shared memory in a
// fixed order, and each block writes f32 partials (nblk, Bt, T, N); a
// second pass adds the partials of the ceil(I/64) blocks in block order.
// dA and dD are summed over time in each block (dA in shared memory by one
// lane per (channel, state)), giving partials over the batch that the
// second pass adds in batch order.  There are no atomics: two runs give
// the same bits.
//
// What bounds it.  At the falcon-mamba-7b training shape (Bt=4, T=1024,
// I=8192, N=16) the Bt*T*I*N = 537M exponentials take about 0.13 ms on the
// special-function units, and the bytes (x, dt, dy, the carries and B, C
// read; dx, ddt written; about 0.5 GB) about 0.15 ms at 3.35 TB/s.  As in
// the forward, the instructions around each exponential (here about 25 per
// (t, n): the rebuild, the backward composition, the walk's terms and the
// shuffles of the dB and dC sums) bind first.  8 warps held to 128
// registers (no spills, python -m repro_torch.kernels._build) and 111,872 B
// of shared memory (bf16, N <= 16) leave two blocks per SM; unbounded, the
// kernel took 183 registers, one block per SM, and 1.72 ms at that shape
// (chip_smoke.py phase 6, H100 80GB HBM3, 700 W; PERF.md has the time with
// two).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_sums.cuh"
#include "scan_tiles.cuh"

namespace {

using namespace scan_sums;
using namespace scan_tiles;

// Tile constants, as in ssm_scan.cu and mirrored in ssm_scan.py (SEGMENT,
// LANES, CHANNELS, CHUNK, STAGES) for the CPU tests.
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
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int NMAX>
struct Layout {
  static constexpr int X = tile_bytes<T, CH, TC, SEG>();        // x, dy
  static constexpr int F = tile_bytes<float, CH, TC, SEG>();    // dt
  static constexpr int S = tile_bytes<float, NMAX, TC, SEG>();  // B, C
  static constexpr int STAGE = 2 * X + F + 2 * S;
  static constexpr int STATE = CH * NMAX * 4;  // A*log2(e), q carry, dA sums
  static constexpr int RED = 2 * 2 * WARPS * TC * 4;  // warps' dB, dC sums, x2
  static constexpr int OUT = 2 * TC * NMAX * 4;       // the block's dB, dC
  static constexpr int SMEM = STAGES * STAGE + 3 * STATE + RED + OUT;
};

// Sums v[s] over the CPW = 8 channels of this lane's segment in its warp, a
// reduce-scatter of 14 shuffles: on return v[0] and v[1] hold the sums of
// steps base and base + 1, base = 8*b0 + 4*b1 + 2*b2 for the bits b of the
// lane's channel.  The order of the additions is fixed.
__device__ __forceinline__ int reduce_scatter(float (&v)[SEG], int ch) {
  const bool b0 = ch & 1, b1 = ch & 2, b2 = ch & 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float keep = b0 ? v[j + 8] : v[j];
    const float send = b0 ? v[j] : v[j + 8];
    v[j] = keep + __shfl_xor_sync(FULL, send, 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float keep = b1 ? v[j + 4] : v[j];
    const float send = b1 ? v[j] : v[j + 4];
    v[j] = keep + __shfl_xor_sync(FULL, send, 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float keep = b2 ? v[j + 2] : v[j];
    const float send = b2 ? v[j] : v[j + 2];
    v[j] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  return 8 * b0 + 4 * b1 + 2 * b2;
}

// The block's sum of one of dB / dC over its 8 warps, for state n: threads
// 0..2*TC-1 each add one step's 8 warp sums, in warp order.
__device__ __forceinline__ void block_sum(const float* red, float* out, int n,
                                          int nmax) {
  if (threadIdx.x < 2 * TC) {
    const int which = threadIdx.x / TC, t = threadIdx.x % TC;
    const float* r = red + which * WARPS * TC + t;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += r[w * TC];
    out[(which * TC + t) * nmax + n] = s;
  }
}

// One chunk of one lane: segment g of channel c (in block) in warp w,
// `live` valid steps (all SEG unless MASKED).  cin: the forward's state
// entering this chunk for channel c (not read past I); qc, dAs
// (CH x NMAX): the q carry from the later chunk (read and written by the
// lane with g == LANES-1) and the running dA sums (lane g == 0).  Writes dx
// and ddt into x's and dt's places in the tile and the chunk's dB, dC block
// sums to `out`.
template <typename T, int NMAX, bool MASKED>
__device__ __forceinline__ void bwd_chunk(char* st, const float* a2,
                                          const float* cin, float* qc,
                                          float* dAs, float* red, float* out,
                                          int N, int g, int c, int w, int ch,
                                          int live, bool active, float d,
                                          float& dD) {
  using L = Layout<T, NMAX>;
  char* xs = st;
  char* dys = st + L::X;
  char* dts = st + 2 * L::X;
  char* Bs = dts + L::F;
  char* Cs = Bs + L::S;
  const int src = ((g + LANES - 1) % LANES) * CPW + ch;   // lane g-1
  float ddt[SEG], dxs[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) ddt[s] = dxs[s] = 0.f;

#pragma unroll 1
  for (int n = 0; n < N; ++n) {
    const float an = a2[c * NMAX + n];
    const float An = an * LN2;                      // A itself
    float dA[SEG], h[SEG], v[SEG];
    // 1. the forward's states: compose the segment ...
    float P = 1.f, hc = 0.f;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      const float dtv = *at_seg<float, CH, SEG>(dts, g, s, c);
      const float dtx = dtv * to_f32(*at_seg<T, CH, SEG>(xs, g, s, c));
      const float bn = *at_seg<float, NMAX, SEG>(Bs, g, s, n);
      const bool ok = !MASKED || s < live;
      dA[s] = ok ? ex2_approx(dtv * an) : 1.f;
      h[s] = ok ? dtx * bn : 0.f;                   // dt*B*x for now
      hc = fmaf(dA[s], hc, h[s]);
      P *= dA[s];
    }
    const float Pseg = P;
    // ... scan the lanes, the chunk's saved state folded into the first ...
    const float old = g == 0 && active ? cin[n] : 0.f;
    if (g == 0) hc = fmaf(P, old, hc);
#pragma unroll
    for (int off = 1; off < LANES; off *= 2) {
      const float hp = __shfl_up_sync(FULL, hc, off * CPW);
      if (2 * off < LANES) {
        const float Pp = __shfl_up_sync(FULL, P, off * CPW);
        if (g >= off) {
          hc = fmaf(P, hp, hc);
          P *= Pp;
        }
      } else if (g >= off) {
        hc = fmaf(P, hp, hc);
      }
    }
    const float prev = __shfl_sync(FULL, hc, src);
    const float hstart = g == 0 ? old : prev;       // h before the segment
    // ... and re-walk it, keeping each h_t.
    hc = hstart;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      hc = fmaf(dA[s], hc, h[s]);
      h[s] = hc;
    }

    // dC_t = sum_i dy_t h_t: this warp's 8 channels, then the block's.
#pragma unroll
    for (int s = 0; s < SEG; ++s)
      v[s] = active ? to_f32(*at_seg<T, CH, SEG>(dys, g, s, c)) * h[s] : 0.f;
    float* rb = red + (n & 1) * 2 * WARPS * TC;     // this state's buffer
    int base = reduce_scatter(v, ch);
    rb[WARPS * TC + w * TC + g * SEG + base] = v[0];    // the dC half
    rb[WARPS * TC + w * TC + g * SEG + base + 1] = v[1];

    // 2. compose the segment backwards: q_t = a_t (C_t dy_t + q_{t+1}).
    float Q = 0.f;
#pragma unroll
    for (int s = SEG - 1; s >= 0; --s) {
      const bool ok = !MASKED || s < live;
      const float cd = ok ? *at_seg<float, NMAX, SEG>(Cs, g, s, n) *
                                to_f32(*at_seg<T, CH, SEG>(dys, g, s, c))
                          : 0.f;
      Q = dA[s] * (cd + Q);
    }
    // Reverse scan over the lanes, the later chunk's q folded into the last.
    float Pr = Pseg;
    const float qin = g == LANES - 1 ? qc[c * NMAX + n] : 0.f;
    if (g == LANES - 1) Q = fmaf(Pr, qin, Q);
#pragma unroll
    for (int off = 1; off < LANES; off *= 2) {
      const float Qn = __shfl_down_sync(FULL, Q, off * CPW);
      const float Pn = __shfl_down_sync(FULL, Pr, off * CPW);
      if (g + off < LANES) {
        Q = fmaf(Pr, Qn, Q);
        Pr *= Pn;
      }
    }
    // Lane g starts from lane g+1's q, the last lane from the carry; the
    // first lane's q is the earlier chunk's carry.
    const float later = __shfl_down_sync(FULL, Q, CPW);
    const float first = __shfl_sync(FULL, Q, ch);       // lane g == 0's
    float q = g == LANES - 1 ? qin : later;
    if (g == LANES - 1) qc[c * NMAX + n] = first;

    // 3. walk the segment backwards.
    float dAn = 0.f;
#pragma unroll
    for (int s = SEG - 1; s >= 0; --s) {
      const bool ok = !MASKED || s < live;
      const float dtv = *at_seg<float, CH, SEG>(dts, g, s, c);
      const float xv = to_f32(*at_seg<T, CH, SEG>(xs, g, s, c));
      const float dyv = to_f32(*at_seg<T, CH, SEG>(dys, g, s, c));
      const float bn = *at_seg<float, NMAX, SEG>(Bs, g, s, n);
      const float cn = *at_seg<float, NMAX, SEG>(Cs, g, s, n);
      const float gt = ok ? fmaf(cn, dyv, q) : q;
      const float ah = dA[s] * (s > 0 ? h[s - 1] : hstart);   // a_t h_{t-1}
      ddt[s] = fmaf(gt, fmaf(ah, An, bn * xv), ddt[s]);
      dxs[s] = fmaf(gt, bn, dxs[s]);
      if (ok) dAn = fmaf(gt * ah, dtv, dAn);
      v[s] = active ? gt * dtv * xv : 0.f;
      q = dA[s] * gt;
    }
    base = reduce_scatter(v, ch);
    rb[w * TC + g * SEG + base] = v[0];                 // the dB half
    rb[w * TC + g * SEG + base + 1] = v[1];
    // dA over the channel's 4 lanes, then over the chunks in shared memory.
    dAn += __shfl_xor_sync(FULL, dAn, CPW);
    dAn += __shfl_xor_sync(FULL, dAn, 2 * CPW);
    if (g == 0) dAs[c * NMAX + n] += dAn;
    __syncthreads();                    // this state's warp sums are written
    block_sum(rb, out, n, NMAX);
  }
  // dx = dt * sum_n g B + D dy and ddt into x's and dt's places; dD.
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    if (!MASKED || s < live) {
      T* px = at_seg<T, CH, SEG>(xs, g, s, c);
      float* pdt = at_seg<float, CH, SEG>(dts, g, s, c);
      const float xv = to_f32(*px);
      const float dyv = to_f32(*at_seg<T, CH, SEG>(dys, g, s, c));
      dD = fmaf(dyv, xv, dD);
      from_f32(px, fmaf(*pdt, dxs[s], d * dyv));
      *pdt = ddt[s];
    }
  }
}

// flags: bit 0 rows of x, dy and dx 16-byte aligned, bit 1 dt's and ddt's,
// bit 2 B's and C's.
template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS, 2) ssm_scan_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ carries, const T* __restrict__ dy,
    const float* __restrict__ dhT, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dh0,
    float* __restrict__ partBC, float* __restrict__ partA,
    float* __restrict__ partD, int Bt, int Tn, int I, int N, int flags) {
  using L = Layout<T, NMAX>;
  extern __shared__ __align__(16) char smem[];
  float* a2 = reinterpret_cast<float*>(smem + STAGES * L::STAGE);
  float* qc = a2 + CH * NMAX;
  float* dAs = qc + CH * NMAX;
  float* red = dAs + CH * NMAX;
  float* out = red + 2 * 2 * WARPS * TC;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int c0 = blk * CH;
  const int ncols = min(CH, I - c0);
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int g = lane / CPW;                         // segment
  const int ch = lane % CPW;
  const int c = w * CPW + ch;                       // channel in block
  const bool active = c0 + c < I;
  const float d = active ? Dv[c0 + c] : 0.f;

  zero_smem<THREADS>(smem, STAGES * L::STAGE);
  for (int k = threadIdx.x; k < CH * NMAX; k += THREADS) {
    const int col = c0 + k / NMAX, n = k % NMAX;
    const bool live = col < I && n < N;
    a2[k] = live ? A[(long)col * N + n] * LOG2E : 0.f;
    qc[k] = live && dhT != nullptr ? dhT[((long)b * I + col) * N + n] : 0.f;
    dAs[k] = 0.f;
  }
  __syncthreads();

  const bool vx = flags & 1, vdt = flags & 2, vbc = flags & 4;
  const int nchunks = (Tn + TC - 1) / TC;
  // Chunk nchunks-1-j goes into stage j % STAGES.
  auto prefetch = [&](int j) {
    if (j < nchunks) {
      const int k = nchunks - 1 - j;
      char* st = smem + (j % STAGES) * L::STAGE;
      const int nt = min(TC, Tn - k * TC);
      const long row0 = (long)b * Tn + (long)k * TC;
      load_tile<T, CH, SEG, THREADS>(st, x + row0 * I + c0, I, nt, ncols, vx);
      load_tile<T, CH, SEG, THREADS>(st + L::X, dy + row0 * I + c0, I, nt,
                                     ncols, vx);
      load_tile<float, CH, SEG, THREADS>(st + 2 * L::X, dt + row0 * I + c0, I,
                                         nt, ncols, vdt);
      load_tile<float, NMAX, SEG, THREADS>(st + 2 * L::X + L::F, Bm + row0 * N,
                                           N, nt, N, vbc);
      load_tile<float, NMAX, SEG, THREADS>(st + 2 * L::X + L::F + L::S,
                                           Cm + row0 * N, N, nt, N, vbc);
    }
    cp_async_commit();                              // empty groups keep count
  };

  float dD = 0.f;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < nchunks; ++j) {
    prefetch(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();                                // the chunk has landed
    const int k = nchunks - 1 - j;
    char* st = smem + (j % STAGES) * L::STAGE;
    const int nt = min(TC, Tn - k * TC);
    const float* cin = carries + (((long)b * nchunks + k) * I + c0 + c) * N;
    if (nt == TC)
      bwd_chunk<T, NMAX, false>(st, a2, cin, qc, dAs, red, out, N, g, c, w, ch,
                                SEG, active, d, dD);
    else
      bwd_chunk<T, NMAX, true>(st, a2, cin, qc, dAs, red, out, N, g, c, w, ch,
                               nt - g * SEG, active, d, dD);
    __syncthreads();
    const long row0 = (long)b * Tn + (long)k * TC;
    store_tile<T, CH, SEG, THREADS>(dx + row0 * I + c0, st, I, nt, ncols, vx);
    store_tile<float, CH, SEG, THREADS>(ddt + row0 * I + c0, st + 2 * L::X, I,
                                        nt, ncols, vdt);
    // The chunk's dB and dC block sums: partials (2, nblk, Bt, T, N).
    for (int e = threadIdx.x; e < 2 * nt * N; e += THREADS) {
      const int which = e / (nt * N), r = (e / N) % nt, n = e % N;
      partBC[(((long)which * nblk + blk) * Bt * Tn + row0 + r) * N + n] =
          out[(which * TC + r) * NMAX + n];
    }
    __syncthreads();                                // the buffer is free
  }
  // dh0 is the first chunk's q carry; the dA and dD partials over the batch.
  for (int e = threadIdx.x; e < CH * NMAX; e += THREADS) {
    const int col = c0 + e / NMAX, n = e % NMAX;
    if (col < I && n < N) {
      dh0[((long)b * I + col) * N + n] = qc[e];
      partA[((long)b * I + col) * N + n] = dAs[e];
    }
  }
  dD += __shfl_xor_sync(FULL, dD, CPW);
  dD += __shfl_xor_sync(FULL, dD, 2 * CPW);
  if (g == 0 && active) partD[(long)b * I + c0 + c] = dD;
}

template <typename T, int NMAX>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv,
                   const float* carries, const void* dy, const float* dhT,
                   void* dx, float* ddt, float* dh0, float* partBC,
                   float* partA, float* partD, int Bt, int Tn, int I, int N,
                   cudaStream_t stream) {
  constexpr int smem = Layout<T, NMAX>::SMEM;
  auto kernel = ssm_scan_bwd_kernel<T, NMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long xrow = (long)I * sizeof(T);
  const int flags =
      (aligned16(x, xrow) && aligned16(dy, xrow) && aligned16(dx, xrow) ? 1 : 0)
      | (aligned16(dt, (long)I * 4) && aligned16(ddt, 0) ? 2 : 0)
      | (aligned16(Bm, (long)N * 4) && aligned16(Cm, 0) ? 4 : 0);
  dim3 grid((I + CH - 1) / CH, Bt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, Dv, carries,
      static_cast<const T*>(dy), dhT, static_cast<T*>(dx), ddt, dh0, partBC,
      partA, partD, Bt, Tn, I, N, flags);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* Dv,
                       const float* cr, const void* dy, const float* dhT,
                       void* dx, float* ddt, float* dh0, float* pBC,
                       float* pA, float* pD, int Bt, int Tn, int I, int N,
                       cudaStream_t st) {
  if (N <= 4)
    return launch<T, 4>(x, dt, A, Bm, Cm, Dv, cr, dy, dhT, dx, ddt, dh0, pBC,
                        pA, pD, Bt, Tn, I, N, st);
  if (N <= 8)
    return launch<T, 8>(x, dt, A, Bm, Cm, Dv, cr, dy, dhT, dx, ddt, dh0, pBC,
                        pA, pD, Bt, Tn, I, N, st);
  return launch<T, 16>(x, dt, A, Bm, Cm, Dv, cr, dy, dhT, dx, ddt, dh0, pBC,
                       pA, pD, Bt, Tn, I, N, st);
}

}  // namespace

// Floats of scratch the backward needs: the dB and dC partials of each
// 64-channel block, (2, ceil(I/64), Bt, T, N), then the dA partials (Bt, I,
// N) and the dD partials (Bt, I).
extern "C" long repro_ssm_scan_bwd_scratch(int Bt, int T, int I, int N) {
  const long nblk = (I + CH - 1) / CH;
  return 2 * nblk * Bt * (long)T * N + (long)Bt * I * N + (long)Bt * I;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx share it; every other
// tensor is float32).  All tensors are contiguous: x, dt, dy, dx, ddt
// (Bt,T,I); A, dA (I,N); B, C, dB, dC (Bt,T,N); D, dD (I,); dhT, dh0
// (Bt,I,N); carries (Bt,ceil(T/64),I,N) as ssm_scan.cu writes them; scratch
// as repro_ssm_scan_bwd_scratch counts it.  dhT may be null (no gradient
// of h_T).  Returns the first failing launch's cudaError_t (0 on success);
// the kernels run asynchronously on `stream`.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* carries, const void* dy,
    const void* dhT, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dh0, void* scratch, int dtype, int Bt, int T, int I,
    int N, void* stream) {
  if (Bt <= 0 || T <= 0 || I <= 0 || N <= 0 || N > 16 || Bt > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (I + CH - 1) / CH;
  const long bc = (long)Bt * T * N;
  float* pBC = static_cast<float*>(scratch);
  float* pA = pBC + 2 * nblk * bc;
  float* pD = pA + (long)Bt * I * N;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  const float* cr = static_cast<const float*>(carries);
  const float* dhTf = static_cast<const float*>(dhT);
  float* ddtf = static_cast<float*>(ddt);
  float* dh0f = static_cast<float*>(dh0);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_n<float>(x, dtf, Af, Bf, Cf, Df, cr, dy, dhTf, dx, ddtf,
                            dh0f, pBC, pA, pD, Bt, T, I, N, st);
  else if (dtype == 1)
    err = dispatch_n<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, cr, dy, dhTf, dx,
                                    ddtf, dh0f, pBC, pA, pD, Bt, T, I, N, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  if ((err = sum_lead(pBC, nblk, bc, static_cast<float*>(dB), st)) != cudaSuccess)
    return (int)err;
  if ((err = sum_lead(pBC + nblk * bc, nblk, bc, static_cast<float*>(dC), st)) !=
      cudaSuccess)
    return (int)err;
  if ((err = sum_lead(pA, Bt, (long)I * N, static_cast<float*>(dA), st)) !=
      cudaSuccess)
    return (int)err;
  return (int)sum_lead(pD, Bt, I, static_cast<float*>(dD), st);
}
