// Mamba1 selective scan for Hopper (sm_90a), parallel over time.
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
// What bounds it.  At the falcon-mamba-7b prefill shape (Bt=4, T=1024,
// I=8192, N=16, x and y bf16, dt f32) the Bt*T*I*N = 537M exponentials on
// the special-function units (16 per clock per SM) take about 0.13 ms on an
// H100 SXM, against about 0.08 ms to move the 271 MB of inputs and outputs
// at 3.35 TB/s: the exponentials bind.  exp(dt*A) is ex2(dt * A*log2(e)),
// one multiply and one MUFU.EX2, and each (t, n) gets exactly one; the
// parallel scan below composes products and adds none.
//
// Design.  A block of 8 warps owns CH = 64 channels of one batch row and
// walks T in chunks of TC = 64 steps.  Each chunk's x and dt tiles (TC x CH)
// and its B and C rows (TC x N) reach shared memory through a ring of
// STAGES = 2 buffers filled by cp.async, so the next chunk loads while this
// one is computed.  cp.async and not TMA: the tiles are rows of 128-256
// bytes strided by I, a 16-byte copy per thread needs no tensor map
// (cuTensorMapEncode), and the same code copies any 16-byte-aligned row;
// unaligned rows (small or odd I, N not a multiple of 4) take plain loads
// into the same tiles, still on the card.  Inside a chunk, LANES = 4 lanes
// share one channel, each over a segment of SEG = 16 consecutive steps, and
// a warp holds CPW = 8 channels (lane = segment * CPW + channel): one
// shared-memory read of B_t,n or C_t,n serves the 8 channels.  For each
// state n a lane
//   1. forms its 16 steps' dA and dt*B*x, keeps them in registers, and
//      composes them into one (prod dA, h) pair;
//   2. takes an inclusive shuffle scan of the pairs across its 4 lanes,
//      (a1,b1) o (a2,b2) = (a1*a2, a2*b1 + b2), with the channel's carry
//      from the previous chunk folded into the first lane;
//   3. re-walks its segment from the state before it and accumulates
//      y_t += C_t,n * h_t,n.
// The last lane's state is the next chunk's carry (kept in shared memory by
// the first lane), and after the last chunk it is h_T.  Steps past T are
// identity (dA = 1, dt*B*x = 0), never zero inputs; full chunks skip the
// mask.  y goes back through the x tile in shared memory and leaves as
// 16-byte coalesced stores.  Tiles put 32 bytes after every SEG rows
// (scan_tiles.cuh), so the 4 segments of a warp read distinct banks.
//
// Training asks for one more output, `carries` (Bt, ceil(T/TC), I, N) f32:
// the state entering each chunk, which ssm_scan_bwd.cu rebuilds the chunk's
// states from.  The kernel is templated on whether it writes them, so a
// call without them (serving) runs the code it ran before, with no added
// branch, store or barrier.
//
// Why these tiles.  4 lanes of 16 steps keep a segment's dA and dt*B*x in
// registers and the shuffle scan at two levels; 8 warps of 121 registers
// (no spills, python -m repro_torch.kernels._build) and 74,752 B of shared
// memory leave two blocks (16 warps) per SM.  On an H100 80GB HBM3 at
// 700 W the main shape takes about 0.31 ms (chip_smoke.py phase 6), 2.4x
// its bound.  What holds it there is the work around each exponential: per
// (t, n) the loops in scan_chunk issue, beside the one MUFU.EX2, four f32
// multiplies or FMAs to compose the segment, two FMAs to re-walk it and two
// shared-memory reads (B and C): nine instructions, where the SFUs' 16
// results per clock leave 8 of an SM's 128 lane issue slots per
// exponential.  Issue and the shared-memory pipe bind before the SFUs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_tiles.cuh"

namespace {

using namespace scan_tiles;

// Tile constants, mirrored in ssm_scan.py (SEGMENT, LANES, CHANNELS, CHUNK,
// STAGES) for the CPU tests.
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

template <typename T, int NMAX>
struct Layout {
  static constexpr int X = tile_bytes<T, CH, TC, SEG>();
  static constexpr int F = tile_bytes<float, CH, TC, SEG>();
  static constexpr int S = tile_bytes<float, NMAX, TC, SEG>();
  static constexpr int STAGE = X + F + 2 * S;   // x, dt, B, C
  static constexpr int STATE = CH * NMAX * 4;   // A*log2(e), or the carries
  static constexpr int SMEM = STAGES * STAGE + 2 * STATE;
};

// One chunk of one lane: segment g of channel c, `live` valid steps (all
// SEG unless MASKED).  a2 (CH x NMAX) holds A*log2(e); carry (CH x NMAX)
// the channel's state, read and written by the lane with g == 0 only.
// Writes y into x's place in the tile.
template <typename T, int NMAX, bool MASKED>
__device__ __forceinline__ void scan_chunk(char* st, const float* a2,
                                           float* carry, int N, int g, int c,
                                           int src, int live, float d) {
  using L = Layout<T, NMAX>;
  char* xs = st;
  char* dts = st + L::X;
  char* Bs = st + L::X + L::F;
  char* Cs = Bs + L::S;
  float dtv[SEG], dtx[SEG], yv[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    dtv[s] = *at_seg<float, CH, SEG>(dts, g, s, c);
    dtx[s] = dtv[s] * to_f32(*at_seg<T, CH, SEG>(xs, g, s, c));
    yv[s] = 0.f;
  }
#pragma unroll 1
  for (int n = 0; n < N; ++n) {
    const float an = a2[c * NMAX + n];
    float dA[SEG], u[SEG];
    float P = 1.f, h = 0.f;
    // 1. compose the segment
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      const float bn = *at_seg<float, NMAX, SEG>(Bs, g, s, n);
      const bool v = !MASKED || s < live;
      dA[s] = v ? ex2_approx(dtv[s] * an) : 1.f;
      u[s] = v ? dtx[s] * bn : 0.f;
      h = fmaf(dA[s], h, u[s]);
      P *= dA[s];
    }
    // 2. scan the LANES segments, the carry folded into the first
    const float old = g == 0 ? carry[c * NMAX + n] : 0.f;
    if (g == 0) h = fmaf(P, old, h);
#pragma unroll
    for (int off = 1; off < LANES; off *= 2) {
      const float hp = __shfl_up_sync(FULL, h, off * CPW);
      if (2 * off < LANES) {                        // the last level needs no P
        const float Pp = __shfl_up_sync(FULL, P, off * CPW);
        if (g >= off) {
          h = fmaf(P, hp, h);
          P *= Pp;
        }
      } else if (g >= off) {
        h = fmaf(P, hp, h);
      }
    }
    // The first lane keeps the last lane's state as the next carry and
    // starts from the old one; lane g starts from lane g-1's.
    const float nxt = __shfl_sync(FULL, h, src);
    h = g == 0 ? old : nxt;
    if (g == 0) carry[c * NMAX + n] = nxt;
    // 3. re-walk the segment with dA and dt*B*x still in registers
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      h = fmaf(dA[s], h, u[s]);
      yv[s] = fmaf(h, *at_seg<float, NMAX, SEG>(Cs, g, s, n), yv[s]);
    }
  }
  // y = C.h + D*x, rounded once, into x's place in the tile.
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    if (!MASKED || s < live) {
      T* p = at_seg<T, CH, SEG>(xs, g, s, c);
      from_f32(p, yv[s] + d * to_f32(*p));
    }
  }
}

// flags: bit 0 x and y rows 16-byte aligned, bit 1 dt's, bit 2 B's and C's.
// SAVE: write the state entering each chunk to `carries`.
template <typename T, int NMAX, bool SAVE>
__global__ void __launch_bounds__(THREADS, 2) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    float* __restrict__ carries, int Tn, int I, int N, int flags) {
  using L = Layout<T, NMAX>;
  extern __shared__ __align__(16) char smem[];
  float* a2 = reinterpret_cast<float*>(smem + STAGES * L::STAGE);
  float* carry = a2 + CH * NMAX;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ncols = min(CH, I - c0);
  const int lane = threadIdx.x % 32;
  const int g = lane / CPW;                         // segment
  const int c = (threadIdx.x / 32) * CPW + lane % CPW;   // channel in block
  const int src = ((g + LANES - 1) % LANES) * CPW + lane % CPW;
  const float d = c0 + c < I ? Dv[c0 + c] : 0.f;

  zero_smem<THREADS>(smem, STAGES * L::STAGE);
  for (int k = threadIdx.x; k < CH * NMAX; k += THREADS) {
    const int ch = c0 + k / NMAX, n = k % NMAX;
    const bool live = ch < I && n < N;
    a2[k] = live ? A[(long)ch * N + n] * LOG2E : 0.f;
    carry[k] = live && h0 != nullptr ? h0[((long)b * I + ch) * N + n] : 0.f;
  }
  __syncthreads();

  const bool vx = flags & 1, vdt = flags & 2, vbc = flags & 4;
  const int nchunks = (Tn + TC - 1) / TC;
  auto prefetch = [&](int k) {
    if (k < nchunks) {
      char* st = smem + (k % STAGES) * L::STAGE;
      const int nt = min(TC, Tn - k * TC);
      const long row0 = (long)b * Tn + (long)k * TC;
      load_tile<T, CH, SEG, THREADS>(st, x + row0 * I + c0, I, nt, ncols, vx);
      load_tile<float, CH, SEG, THREADS>(st + L::X, dt + row0 * I + c0, I, nt,
                                         ncols, vdt);
      load_tile<float, NMAX, SEG, THREADS>(st + L::X + L::F, Bm + row0 * N, N,
                                           nt, N, vbc);
      load_tile<float, NMAX, SEG, THREADS>(st + L::X + L::F + L::S,
                                           Cm + row0 * N, N, nt, N, vbc);
    }
    cp_async_commit();                              // empty groups keep count
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) prefetch(k);
  for (int k = 0; k < nchunks; ++k) {
    prefetch(k + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();                                // chunk k has landed
    if (SAVE) {                          // the state entering chunk k
      float* out = carries + ((long)b * nchunks + k) * I * N;
      for (int j = threadIdx.x; j < CH * NMAX; j += THREADS) {
        const int ch = c0 + j / NMAX, n = j % NMAX;
        if (ch < I && n < N) out[(long)ch * N + n] = carry[j];
      }
      __syncthreads();                   // read before the scan rewrites it
    }
    char* st = smem + (k % STAGES) * L::STAGE;
    const int nt = min(TC, Tn - k * TC);
    if (nt == TC)
      scan_chunk<T, NMAX, false>(st, a2, carry, N, g, c, src, SEG, d);
    else
      scan_chunk<T, NMAX, true>(st, a2, carry, N, g, c, src, nt - g * SEG, d);
    __syncthreads();
    store_tile<T, CH, SEG, THREADS>(y + ((long)b * Tn + (long)k * TC) * I + c0,
                                    st, I, nt, ncols, vx);
    __syncthreads();                                // the buffer is free
  }
  // Each carry was last written by its own channel's first lane.
  for (int k = threadIdx.x; k < CH * NMAX; k += THREADS) {
    const int ch = c0 + k / NMAX, n = k % NMAX;
    if (ch < I && n < N) hT[((long)b * I + ch) * N + n] = carry[k];
  }
}

template <typename T, int NMAX, bool SAVE>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv,
                   const float* h0, void* y, float* hT, float* carries, int Bt,
                   int Tn, int I, int N, cudaStream_t stream) {
  constexpr int smem = Layout<T, NMAX>::SMEM;
  auto kernel = ssm_scan_kernel<T, NMAX, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long xrow = (long)I * sizeof(T);
  const int flags = (aligned16(x, xrow) && aligned16(y, xrow) ? 1 : 0)
                  | (aligned16(dt, (long)I * 4) ? 2 : 0)
                  | (aligned16(Bm, (long)N * 4) && aligned16(Cm, 0) ? 4 : 0);
  dim3 grid((I + CH - 1) / CH, Bt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, Dv, h0, static_cast<T*>(y), hT,
      carries, Tn, I, N, flags);
  return cudaGetLastError();
}

template <typename T, bool SAVE>
cudaError_t dispatch_n(const void* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* Dv,
                       const float* h0, void* y, float* hT, float* cr, int Bt,
                       int Tn, int I, int N, cudaStream_t st) {
  if (N <= 4)
    return launch<T, 4, SAVE>(x, dt, A, Bm, Cm, Dv, h0, y, hT, cr, Bt, Tn, I, N, st);
  if (N <= 8)
    return launch<T, 8, SAVE>(x, dt, A, Bm, Cm, Dv, h0, y, hT, cr, Bt, Tn, I, N, st);
  return launch<T, 16, SAVE>(x, dt, A, Bm, Cm, Dv, h0, y, hT, cr, Bt, Tn, I, N, st);
}

template <typename T>
cudaError_t dispatch_save(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, const float* Dv,
                          const float* h0, void* y, float* hT, float* cr,
                          int Bt, int Tn, int I, int N, cudaStream_t st) {
  if (cr != nullptr)
    return dispatch_n<T, true>(x, dt, A, Bm, Cm, Dv, h0, y, hT, cr, Bt, Tn, I, N, st);
  return dispatch_n<T, false>(x, dt, A, Bm, Cm, Dv, h0, y, hT, cr, Bt, Tn, I, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; every other tensor is
// float32).  All tensors are contiguous: x, dt, y (Bt,T,I); A (I,N); B, C
// (Bt,T,N); D (I,); h0 and hT (Bt,I,N); carries (Bt,ceil(T/64),I,N).  h0
// may be null (zero state); carries may be null (not written).  Returns the
// launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int repro_ssm_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    void* carries, int dtype, int Bt, int T, int I, int N, void* stream) {
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
  float* cr = static_cast<float*>(carries);
  if (dtype == 0)
    return (int)dispatch_save<float>(x, dtf, Af, Bf, Cf, Df, h0f, y, hTf, cr, Bt, T, I, N, st);
  if (dtype == 1)
    return (int)dispatch_save<__nv_bfloat16>(x, dtf, Af, Bf, Cf, Df, h0f, y, hTf, cr, Bt, T, I, N, st);
  return (int)cudaErrorInvalidValue;
}
