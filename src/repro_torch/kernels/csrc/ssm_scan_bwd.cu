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
//   ddt_t  = sum_n g_t h_{t-1} a_t A + x_t sum_n g_t B_t
//   dx_t   = dt_t sum_n g_t B_t + D dy_t    dD   = sum_{b,t} dy_t x_t
//   dA     = sum_{b,t} g_t h_{t-1} a_t dt_t dh0  = a_0 g_0.
//
// Design.  A block of 16 warps owns CH = 64 channels of one batch row and
// walks T in the forward's chunks of TC = 64 steps, from the last chunk to
// the first; each chunk's x, dt and dy tiles, its B and C rows and the
// forward's states entering it (`carries`, written by ssm_scan.cu when
// asked) reach shared memory through a ring of STAGES = 2 cp.async
// buffers, filled in reverse order.  LANES = 8 lanes share a channel, each
// over a segment of SEG = 8 steps, and a warp holds CPW = 4 channels (lane
// = segment * CPW + channel).  A lane reads its 8 steps of dt, dt*x and dy
// from shared memory once a chunk and keeps them, and its sums over the
// states of g*B and g*a*h*A, in registers.  It then takes the states in
// pairs (GROUP = 2; an odd N's last pair has a state of zeros): one 16-byte
// load of a step's row gives B and C of both states, laid out as (B_n,
// B_n+1, C_n, C_n+1) by the copy into shared memory, each segment's rows
// 16 bytes further on so that the 8 segments' loads fall on distinct banks.
// For a pair a lane
//   1. forms its steps' a_t and dt*B*x, composes them forwards into (prod
//      a, h), and in the same pass composes the backward recurrence as
//      Q = sum_t (a_1...a_t) C_t dy_t, the q its segment passes to the one
//      before (q_t = a_t g_t);
//   2. scans the (prod a, h) pairs forwards across its 8 lanes with the
//      chunk's saved state folded into the first, and the (prod a, Q)
//      pairs backwards with the later chunk's q folded into the last: 13
//      shuffles a state, and the first lane's Q is the earlier chunk's q
//      (dh0 after the first chunk);
//   3. re-walks its segment's states and walks it backwards, forming g_t
//      and every term above.
// dB and dC are sums over channels: a reduce-scatter of shuffles over the
// warp's 4 channels (24 shuffles a pair for 32 values, 0.75 a value), two
// 16-byte stores a lane into shared memory, one barrier a pair, and 256
// threads add the 16 warps' sums in warp order into the chunk's block sums,
// which leave as f32 partials (2, ceil(I/64), Bt, T, N); a second pass adds
// them in a fixed order (scan_sums.cuh).  dA is summed per lane over time
// in shared memory and over the 8 segments in order at the end; dD over
// time in registers and over the 8 segments by shuffles.  Steps past T read
// zero dt, dt*x and dy, which makes them the identity (a = ex2(0) = 1, no
// input, no C*dy) with no mask inside the state loop.  There are no atomics:
// two runs give the same bits.
//
// What bounds it.  At the falcon-mamba-7b training shape (Bt=4, T=1024,
// I=8192, N=16) the Bt*T*I*N = 537M exponentials take about 0.13 ms on the
// special-function units, and the bytes (x, dt, dy, the carries and B, C
// read; dx, ddt written; about 0.5 GB) about 0.15 ms at 3.35 TB/s.  The
// earlier kernel (16-step segments, one state a pass) was held by the
// shared-memory and shuffle pipe: it re-read dt, x and dy for each state
// (11.7 shared-memory loads a (step, state)) and summed dB and dC with 1.75
// shuffles a value.  This one issues per (step, state) 1.75 shared-memory
// loads, 3.1 shuffles and 23 f32 instructions, 33 in all against 52-61
// (SASS, tools/ablate_kernels.py --kernel scan_bwd).  What holds it on the
// card (PERF.md has the times, on an H100 80GB HBM3 at 700 W): the dB/dC
// channel sums and the lane scans, whose shuffles come in bursts that the
// barrier of each pair lines up, and the bytes with the dB/dC partials,
// which alone take a quarter of its time.  One block of 16 warps per SM in 128 registers
// (python -m repro_torch.kernels._build): against two blocks of 8 warps
// and 32 channels it halves the partials and measured faster.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "scan_sums.cuh"
#include "scan_tiles.cuh"

namespace {

using namespace scan_sums;
using namespace scan_tiles;

// Tile constants, mirrored in ssm_scan.py (BWD_SEGMENT, BWD_LANES,
// BWD_CHANNELS, BWD_STAGES, BWD_GROUP) for the CPU tests; TC is the
// forward's CHUNK.
constexpr int SEG = 8;                  // steps a lane composes
constexpr int LANES = 8;                // lanes that scan one channel
constexpr int CPW = 32 / LANES;         // channels per warp
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int CH = WARPS * CPW;         // channels per block
constexpr int TC = LANES * SEG;         // steps per chunk
constexpr int STAGES = 2;
constexpr int GROUP = 2;                // states a pass of the state loop
constexpr int BCPAD = 16;               // bytes after each segment's B, C rows
constexpr int RED_HALF = WARPS * 2 * TC * GROUP;  // floats of one red buffer
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int NMAX>
struct Layout {
  static constexpr int X = tile_bytes<T, CH, TC, SEG>();        // x, dy
  static constexpr int F = tile_bytes<float, CH, TC, SEG>();    // dt
  static constexpr int BCROW = NMAX * 8;                        // B and C
  static constexpr int BC = TC * BCROW + (TC / SEG) * BCPAD;
  static constexpr int CR = CH * NMAX * 4;          // the states entering it
  static constexpr int STAGE = 2 * X + F + BC + CR;
  static constexpr int STATE = CH * NMAX * 4;       // A*log2(e), the q carry
  static constexpr int DA = CH * NMAX * LANES * 4;  // dA sums per segment
  static constexpr int RED = 2 * RED_HALF * 4;      // warps' dB, dC sums, x2
  static constexpr int OSTR = NMAX + 1;             // floats a row of OUT
  static constexpr int OUT = (2 * TC * OSTR * 4 + 15) / 16 * 16;  // block's dB, dC
  static constexpr int DV = CH * 4;                 // D by channel
  static constexpr int SMEM = STAGES * STAGE + 2 * STATE + DA + RED + OUT + DV;
};

// Step s of segment g in the B, C tile: (B_n, B_n+1, C_n, C_n+1) of pair p.
// A row is NMAX * 8 bytes and each segment starts BCPAD bytes further on,
// so the 8 segments' 16-byte reads fall on distinct banks.
template <int NMAX>
__device__ __forceinline__ const float4* bc_at(const char* tile, int g, int s,
                                               int p) {
  constexpr int ROW = NMAX * 8;
  return reinterpret_cast<const float4*>(tile + g * (SEG * ROW + BCPAD) + s * ROW) + p;
}

// Rows [0, nt) of B and C (row stride N) into the interleaved tile, 4 bytes
// a copy; states past N and rows past nt are left as they were (zeros).
template <int NMAX>
__device__ __forceinline__ void load_bc(char* tile, const float* __restrict__ B,
                                        const float* __restrict__ C, int N, int nt) {
  constexpr int ROW = NMAX * 8;
#pragma unroll 1
  for (int k = threadIdx.x; k < TC * NMAX; k += THREADS) {
    const int r = k / NMAX, n = k % NMAX;
    if (r < nt && n < N) {
      float* dst = reinterpret_cast<float*>(tile + (r / SEG) * (SEG * ROW + BCPAD) +
                                            (r % SEG) * ROW) + (n / 2) * 4 + (n & 1);
      cp_async_4(dst, B + r * N + n);
      cp_async_4(dst + 2, C + r * N + n);
    }
  }
}

// The forward's states entering the chunk for the block's ncols channels
// (contiguous, N per channel) into cr (NMAX per channel), 4 bytes a copy.
template <int NMAX>
__device__ __forceinline__ void load_carries(float* cr, const float* __restrict__ src,
                                             int N, int ncols) {
#pragma unroll 1
  for (int k = threadIdx.x; k < CH * NMAX; k += THREADS) {
    const int c = k / NMAX, n = k % NMAX;
    if (c < ncols && n < N) cp_async_4(cr + k, src + c * N + n);
  }
}

// The forward scan of the lanes' (P, hc) pairs, hin folded into lane 0, and
// the reverse scan of their (P, Q) pairs, qin folded into the last lane:
// the state entering this lane's segment, the q entering its backward walk
// (from the lane after it; qin for the last lane), and lane 0's composed Q
// (the earlier chunk's q carry).
__device__ __forceinline__ void lane_scans(float P, float hc, float Q, float hin,
                                           float qin, int g, int ch,
                                           float& hstart, float& q, float& first) {
  float Pf = P;
  if (g == 0) hc = fmaf(P, hin, hc);
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
  hstart = g == 0 ? hin : prev;
  float Pr = P;
  if (g == LANES - 1) Q = fmaf(P, qin, Q);
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
  q = g == LANES - 1 ? qin : later;
  first = __shfl_sync(FULL, Q, ch);                 // lane g == 0's
}

// This lane's dB values vb and dC values vc (GROUP states x SEG steps)
// summed over the warp's CPW = 4 channels by a reduce-scatter of shuffles:
// xor 1 halves the steps, xor 2 halves them again, so each lane ends with 2
// steps of both states, each the sum ((c0 + c1) + (c2 + c3)) over the
// warp's channels c0..c3.  They go to the warp's rows of `red`, laid out
// (warp, dB/dC, step, state), as two 16-byte stores.
__device__ __forceinline__ void channel_sums(float (&vb)[GROUP][SEG],
                                             float (&vc)[GROUP][SEG], int ch,
                                             float* red, int w, int g) {
  const bool b0 = ch & 1, b1 = ch & 2;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
#pragma unroll
    for (int s = 0; s < SEG / 2; ++s) {
      float keep = b0 ? vb[j][s + SEG / 2] : vb[j][s];
      float send = b0 ? vb[j][s] : vb[j][s + SEG / 2];
      vb[j][s] = keep + __shfl_xor_sync(FULL, send, 1);
      keep = b0 ? vc[j][s + SEG / 2] : vc[j][s];
      send = b0 ? vc[j][s] : vc[j][s + SEG / 2];
      vc[j][s] = keep + __shfl_xor_sync(FULL, send, 1);
    }
#pragma unroll
    for (int s = 0; s < SEG / 4; ++s) {
      float keep = b1 ? vb[j][s + SEG / 4] : vb[j][s];
      float send = b1 ? vb[j][s] : vb[j][s + SEG / 4];
      vb[j][s] = keep + __shfl_xor_sync(FULL, send, 2);
      keep = b1 ? vc[j][s + SEG / 4] : vc[j][s];
      send = b1 ? vc[j][s] : vc[j][s + SEG / 4];
      vc[j][s] = keep + __shfl_xor_sync(FULL, send, 2);
    }
  }
  const int base = (b0 ? SEG / 2 : 0) + (b1 ? SEG / 4 : 0);
  float* r = red + (w * 2 * TC + g * SEG + base) * GROUP;
  *reinterpret_cast<float4*>(r) = make_float4(vb[0][0], vb[1][0], vb[0][1], vb[1][1]);
  *reinterpret_cast<float4*>(r + TC * GROUP) =
      make_float4(vc[0][0], vc[1][0], vc[0][1], vc[1][1]);
}

// The block's dB and dC of states n0, n0+1 over its warps, in warp order:
// each of the first 2*TC*GROUP threads adds one (dB/dC, step, state)'s warp
// sums into `out`, whose rows (dB/dC, step) are OSTR = NMAX + 1 floats
// apart so that the 32 threads of a warp store to distinct banks.
__device__ __forceinline__ void block_sum(const float* red, float* out, int n0,
                                          int ostr) {
  constexpr int OUTS = 2 * TC * GROUP;
  static_assert(OUTS <= THREADS, "one thread an output");
  if (threadIdx.x < OUTS) {
    const float* r = red + threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += r[w * OUTS];
    out[(threadIdx.x / GROUP) * ostr + n0 + threadIdx.x % GROUP] = s;
  }
}

// One chunk of one lane: segment g of channel c (in block) in warp w, with
// `live` of its steps before T.  a2s, qc (CH x NMAX): A*log2(e) and the q
// carry from the later chunk (read and written by the lane with g ==
// LANES-1); dAs: the running dA sums, (pair, channel, segment) of float2;
// ds: D by channel (read after the state loop, so that it holds no register
// across it).  Writes dx and ddt into x's and dt's places in the tile and
// the chunk's dB, dC block sums to `out`.
template <typename T, int NMAX>
__device__ __forceinline__ void bwd_chunk(char* st, const float* a2s, float* qc,
                                          float* dAs, float* red, float* out,
                                          const float* ds, int N, int g, int c,
                                          int w, int ch, int live, float& dD) {
  using L = Layout<T, NMAX>;
  char* xs = st;
  char* dys = st + L::X;
  char* dts = st + 2 * L::X;
  const char* bcs = dts + L::F;
  const float* cr = reinterpret_cast<const float*>(bcs + L::BC);
  // The lane's operands for the whole state loop, zero past T.
  float dt[SEG], dtx[SEG], dy[SEG], gb[SEG], gaha[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const bool ok = s < live;
    const float dtv = *at_seg<float, CH, SEG>(dts, g, s, c);
    const float xv = to_f32(*at_seg<T, CH, SEG>(xs, g, s, c));
    dt[s] = ok ? dtv : 0.f;
    dtx[s] = ok ? dtv * xv : 0.f;
    dy[s] = ok ? to_f32(*at_seg<T, CH, SEG>(dys, g, s, c)) : 0.f;
    gb[s] = gaha[s] = 0.f;
  }

  const int npairs = (N + GROUP - 1) / GROUP;
#pragma unroll 1
  for (int grp = 0; grp < npairs; ++grp) {
    const int n0 = grp * GROUP;
    const float2 a2p = *reinterpret_cast<const float2*>(a2s + c * NMAX + n0);
    const float2 hin2 = g == 0 ? *reinterpret_cast<const float2*>(cr + c * NMAX + n0)
                               : make_float2(0.f, 0.f);
    const float2 qin2 = g == LANES - 1
                            ? *reinterpret_cast<const float2*>(qc + c * NMAX + n0)
                            : make_float2(0.f, 0.f);
    const float a2[GROUP] = {a2p.x, a2p.y};
    const float hin[GROUP] = {hin2.x, hin2.y}, qin[GROUP] = {qin2.x, qin2.y};
    float dA[GROUP][SEG], h[GROUP][SEG], P[GROUP], hc[GROUP], Q[GROUP];
    // 1. the segment composed forwards, (prod a, h) and Q.
#pragma unroll
    for (int j = 0; j < GROUP; ++j) P[j] = 1.f, hc[j] = Q[j] = 0.f;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      const float4 bc = *bc_at<NMAX>(bcs, g, s, grp);
      const float bv[GROUP] = {bc.x, bc.y}, cv[GROUP] = {bc.z, bc.w};
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        dA[j][s] = ex2_approx(dt[s] * a2[j]);
        h[j][s] = dtx[s] * bv[j];                   // dt*B*x for now
        hc[j] = fmaf(dA[j][s], hc[j], h[j][s]);
        P[j] *= dA[j][s];
        Q[j] = fmaf(P[j], cv[j] * dy[s], Q[j]);
      }
    }
    // 2. across the lanes.
    float hstart[GROUP], q[GROUP], first[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      lane_scans(P[j], hc[j], Q[j], hin[j], qin[j], g, ch, hstart[j], q[j], first[j]);
    if (g == LANES - 1)
      *reinterpret_cast<float2*>(qc + c * NMAX + n0) = make_float2(first[0], first[1]);
    // 3. the states re-walked, then the walk backwards: g_t, the terms of
    // ddt, dx and dA, and in the registers of a_t and h_t, once a step no
    // longer needs them, its dB and dC values.
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      float hh = hstart[j];
#pragma unroll
      for (int s = 0; s < SEG; ++s) {
        hh = fmaf(dA[j][s], hh, h[j][s]);
        h[j][s] = hh;
      }
    }
    float dAn[GROUP] = {0.f, 0.f};
#pragma unroll
    for (int s = SEG - 1; s >= 0; --s) {
      const float4 bc = *bc_at<NMAX>(bcs, g, s, grp);
      const float bv[GROUP] = {bc.x, bc.y}, cv[GROUP] = {bc.z, bc.w};
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float gt = fmaf(cv[j], dy[s], q[j]);
        const float hprev = s > 0 ? h[j][s - 1] : hstart[j];
        const float gah = gt * (dA[j][s] * hprev);
        gaha[s] = fmaf(gah, a2[j], gaha[s]);   // times ln 2 below: A
        gb[s] = fmaf(gt, bv[j], gb[s]);
        dAn[j] = fmaf(gah, dt[s], dAn[j]);
        q[j] = dA[j][s] * gt;
        dA[j][s] = gt * dtx[s];                     // dB's value
        h[j][s] = dy[s] * h[j][s];                  // dC's value
      }
    }
    float2* da = reinterpret_cast<float2*>(dAs) + (grp * CH + c) * LANES + g;
    float2 acc = *da;
    acc.x += dAn[0];
    acc.y += dAn[1];
    *da = acc;
    // 4. dB, dC over the channels: the warp's, then the block's.
    channel_sums(dA, h, ch, red + (grp & 1) * RED_HALF, w, g);
    __syncthreads();                    // this pair's warp sums are written
    block_sum(red + (grp & 1) * RED_HALF, out, n0, L::OSTR);
  }
  // dx = dt * sum_n g B + D dy and ddt = sum_n g a h A + x sum_n g B into
  // x's and dt's places (gaha summed g a h A*log2(e)); dD.
  const float d = ds[c];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    if (s < live) {
      T* px = at_seg<T, CH, SEG>(xs, g, s, c);
      const float xv = to_f32(*px);
      dD = fmaf(dy[s], xv, dD);
      from_f32(px, fmaf(dt[s], gb[s], d * dy[s]));
      *at_seg<float, CH, SEG>(dts, g, s, c) = fmaf(xv, gb[s], gaha[s] * LN2);
    }
  }
}

// flags: bit 0 rows of x, dy and dx 16-byte aligned, bit 1 dt's and ddt's.
template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS, 1) ssm_scan_bwd_kernel(
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
  float* a2s = reinterpret_cast<float*>(smem + STAGES * L::STAGE);
  float* qc = a2s + CH * NMAX;
  float* dAs = qc + CH * NMAX;
  float* red = dAs + CH * NMAX * LANES;
  float* out = red + 2 * RED_HALF;
  float* ds = out + L::OUT / 4;
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

  zero_smem<THREADS>(smem, STAGES * L::STAGE);
  for (int k = threadIdx.x; k < CH * NMAX; k += THREADS) {
    const int col = c0 + k / NMAX, n = k % NMAX;
    const bool live = col < I && n < N;
    a2s[k] = live ? A[(long)col * N + n] * LOG2E : 0.f;
    qc[k] = live && dhT != nullptr ? dhT[((long)b * I + col) * N + n] : 0.f;
  }
  for (int k = threadIdx.x; k < CH * NMAX * LANES; k += THREADS) dAs[k] = 0.f;
  if (threadIdx.x < CH)
    ds[threadIdx.x] = c0 + threadIdx.x < I ? Dv[c0 + threadIdx.x] : 0.f;
  __syncthreads();

  // The chunks are taken from the last to the first; chunk k goes into
  // stage k % STAGES.  The loop keeps nothing but k across the state loop:
  // with a second counter, the chunk count and D held in registers too, the
  // kernel spilled them there and ran about a tenth slower.
  auto prefetch = [&](int k) {
    if (k >= 0) {
      char* st = smem + (k % STAGES) * L::STAGE;
      const int nt = min(TC, Tn - k * TC);
      const long row0 = (long)b * Tn + (long)k * TC;
      load_tile<T, CH, SEG, THREADS>(st, x + row0 * I + c0, I, nt, ncols, flags & 1);
      load_tile<T, CH, SEG, THREADS>(st + L::X, dy + row0 * I + c0, I, nt,
                                     ncols, flags & 1);
      load_tile<float, CH, SEG, THREADS>(st + 2 * L::X, dt + row0 * I + c0, I,
                                         nt, ncols, flags & 2);
      char* bcs = st + 2 * L::X + L::F;
      load_bc<NMAX>(bcs, Bm + row0 * N, Cm + row0 * N, N, nt);
      load_carries<NMAX>(reinterpret_cast<float*>(bcs + L::BC),
                         carries + (((long)b * ((Tn + TC - 1) / TC) + k) * I + c0) * N,
                         N, ncols);
    }
    cp_async_commit();                              // empty groups keep count
  };

  const int last = (Tn - 1) / TC;
  float dD = 0.f;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(last - j);
  for (int k = last; k >= 0; --k) {
    prefetch(k - (STAGES - 1));
    cp_async_wait<STAGES - 1>();
    __syncthreads();                                // the chunk has landed
    char* st = smem + (k % STAGES) * L::STAGE;
    const int nt = min(TC, Tn - k * TC);
    bwd_chunk<T, NMAX>(st, a2s, qc, dAs, red, out, ds, N, g, c, w, ch,
                       nt - g * SEG, dD);
    __syncthreads();
    // The stores' bounds come from opaque copies of nt and flags, formed
    // here: left to itself the compiler forms them before the state loop
    // and spills them across it.
    int ntc, fl;
    asm volatile("mov.b32 %0, %1;" : "=r"(ntc) : "r"(nt));
    asm volatile("mov.b32 %0, %1;" : "=r"(fl) : "r"(flags));
    const long row0 = (long)b * Tn + (long)k * TC;
    store_tile<T, CH, SEG, THREADS>(dx + row0 * I + c0, st, I, ntc, ncols, fl & 1);
    store_tile<float, CH, SEG, THREADS>(ddt + row0 * I + c0, st + 2 * L::X, I,
                                        ntc, ncols, fl & 2);
    // The chunk's dB and dC block sums: partials (2, nblk, Bt, T, N).
#pragma unroll 1
    for (int e = threadIdx.x; e < 2 * TC * NMAX; e += THREADS) {
      const int which = e / (TC * NMAX), r = (e / NMAX) % TC, n = e % NMAX;
      if (r < ntc && n < N)
        partBC[(((long)which * nblk + blk) * Bt * Tn + row0 + r) * N + n] =
            out[(which * TC + r) * L::OSTR + n];
    }
    __syncthreads();                                // the buffer is free
  }
  // dh0 is the first chunk's q carry; the dA partials over the batch (the 8
  // segments' sums added in order) and the dD partials (the segments'
  // sums added pairwise by the butterfly).
  for (int e = threadIdx.x; e < CH * NMAX; e += THREADS) {
    const int cc = e / NMAX, n = e % NMAX, col = c0 + cc;
    if (col < I && n < N) {
      dh0[((long)b * I + col) * N + n] = qc[e];
      const float* da = dAs + (((n / GROUP) * CH + cc) * LANES) * GROUP + n % GROUP;
      float s = 0.f;
#pragma unroll
      for (int seg = 0; seg < LANES; ++seg) s += da[seg * GROUP];
      partA[((long)b * I + col) * N + n] = s;
    }
  }
#pragma unroll
  for (int off = CPW; off < 32; off *= 2) dD += __shfl_xor_sync(FULL, dD, off);
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
      | (aligned16(dt, (long)I * 4) && aligned16(ddt, 0) ? 2 : 0);
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
