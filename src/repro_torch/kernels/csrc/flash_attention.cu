// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py).  Same function: softmax attention
// of q (B,T,H,D) against k, v (B,S,K,D), H % K == 0, query row t at global
// position S-T+t, optional causal mask and sliding window, f32 m / l / acc,
// output in the dtype of q.  A row that sees no key at all returns 0.
// Optionally (a non-null `lse`, f32 (B,H,T)) it also writes each row's
// log-sum-exp of the scaled scores, m + log(l), for the backward in
// flash_attention_bwd.cu; a row that sees no key writes -inf.  Serving
// passes a null pointer and writes nothing more.
//
// Bound on an H100 SXM: 4*D flops per visible (query, key) pair on the
// tensor cores.  At qwen3-32b's prefill (B=4, T=S=1024, H=64, K=8, D=128,
// causal, bf16) that is 68.8 GFLOP, 70 us at 989 TFLOP/s, against 151 MB
// of q, k, v and o, 45 us at 3.35 TB/s; at whisper's encoder (T=S=1500,
// 12 heads, D=64, non-causal) 27.6 GFLOP against 37 MB.  So the work is
// bound by operations, and the bf16 paths run both products on the tensor
// cores.  The TPU kernel's sequential "arbitrary" grid axis, whose online
// softmax state lived in VMEM scratch across grid steps, becomes a loop over
// KV tiles inside each block; tiles wholly past the causal diagonal or
// before the window are never loaded.  GQA reads K/V head h / (H/K)
// directly; K/V are never repeated in memory.  Until a row has seen a
// visible key its running max is -inf, and the kernels keep p = 0 and the
// correction at 1 instead of computing exp(-inf - -inf).
//
// Three paths, chosen from the inputs by repro_flash_attention_fwd_path
// (exported, so callers can ask which one a call takes):
// * 2: bf16 with D in {64, 128, 256} and 16-byte aligned pointers (every
//   forward of every arch on the card: qwen3, qwen2, llama3, starcoder2,
//   granite-moe, phi3.5-moe and whisper at 64 and 128, recurrentgemma's
//   local layers and paligemma at 256): wgmma fed by TMA, warp-specialised
//   (namespace wg; helpers in wgmma_tma.cuh).  A block of 384 threads owns
//   128 query rows of one (batch, head): one producer warpgroup, which
//   drops to 24 registers a thread with setmaxnreg and whose one thread
//   issues every copy, and two consumer warpgroups of 64 rows, which rise
//   to 240.  The host encodes a tensor map per call for q, k and v, each
//   seen as 4-d (D, heads, rows, B), so a box of 64 head-dim columns by a
//   tile's rows of one (batch, head) zero-fills rows past a ragged T or S
//   and never reads the next batch; 128-byte swizzled, which is the layout
//   wgmma reads without bank conflicts.  Q is loaded once; K and V tiles of
//   BN keys pass through a ring of STAGES slots with a full barrier per
//   slot for K and for V (armed with the tile's bytes) and an empty barrier
//   that both consumers release.  Tiles (Tiles<D> below): 128 keys and 3
//   stages at D=64, 128 keys and 2 stages at D=128, 64 keys and 2 stages at
//   D=256, where the output accumulator alone takes 128 f32 registers a
//   thread, so the scores (32) and P (16) must stay small: Q (64 KB) and
//   two stages of K and V (128 KB) take 193 KB of shared memory.  A
//   consumer computes S = Q K^T as m64nBNk16 wgmmas with both operands from
//   shared memory (K-major), runs the online softmax on the accumulator
//   (quad shuffles for the row max and sum; masks only in tiles that the
//   diagonal, the window or S cut), packs P to bf16 in place as the
//   register A operand and accumulates O += P V as m64nDk16 wgmmas (two
//   m64n128k16 at D=256, one per half of the accumulator) with V read
//   MN-major (transposed) from shared memory.  The softmax is what binds at
//   D <= 128 (ablations in PERF.md): per score it takes one max, one FFMA
//   that scales and subtracts the max, one flush-to-zero EX2 and one add,
//   with no select for rows that have seen no key (their max term is 0
//   instead); with exp2f, a separate scale and a select per score the
//   kernel took 1.5x as long at qwen3's shape on an H100.  Blocks start
//   heaviest first.  Each product waits for its own completion before the
//   next step: the overlap of one warpgroup's softmax with the other's
//   products is left to the hardware's scheduling of the two consumers, and
//   FlashAttention-3's intra-warpgroup overlap and ping-pong, persistent
//   blocks and clusters are not used (see ROADMAP.md).  128 keys a tile at
//   D=64 too: 192 and 256 measured 19-24% slower there on an H100; 64 at
//   D=256: 80 (FlashAttention-3's choice, m64n80k16) measured 2-13% slower.
//   Registers: 168 at launch (ptxas -v), no spills, at all three.
// * 1: bf16 with D in {16, 32} and 16-byte aligned pointers (no arch on the
//   card uses them; the tests do): mma.sync m16n8k16 (bf16 in, f32
//   accumulate; helpers in mma_bf16.cuh), 128 threads a block, each warp
//   owning 16 query rows of a 64-row tile.  The scores of a 32-key tile
//   come back in the accumulator layout, the softmax runs on them in
//   registers and they are repacked as bf16 A fragments for P.V without
//   touching shared memory; Q and K fragments come from ldmatrix, V
//   fragments from ldmatrix.trans, and the KV tiles are double-buffered
//   with cp.async.
// * 0: everything else (f32, other head dims up to 256, unaligned
//   pointers): f32 FMAs on the CUDA cores, bound by their 67 TFLOP/s at
//   best.  Each query row of a 32-row tile is owned by 4 lanes of one warp
//   that split its 32 scores and its D outputs, so the row's max, sum and
//   correction never leave registers.  Q and K rows are padded to D+1
//   floats so the dot products read shared memory without bank conflicts.
// Training asks for the log-sum-exp and for o_lo, the bf16 residual of the
// f32 output (see the entry point), which the backward needs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 32;          // keys per KV tile
constexpr int THREADS = 128;    // 4 lanes per query row
constexpr int LANES_PER_ROW = THREADS / BQ;
constexpr int SCORES_PER_LANE = BK / LANES_PER_ROW;

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}
// x as a tensor of T holds it.
__device__ __forceinline__ float rounded(const float*, float x) { return x; }
__device__ __forceinline__ float rounded(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// DPT: output columns per lane (>= ceil(D / 4)), a compile-time bound so the
// accumulator stays in registers.
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, T* __restrict__ o_lo, int T_, int S,
              int H, int K, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 1;                      // padded row stride of Q and K
  float* Qs = smem;                          // BQ x DS
  float* Ks = Qs + BQ * DS;                  // BK x DS
  float* Vs = Ks + BK * DS;                  // BK x D
  float* Ps = Vs + BK * D;                   // BQ x (BK+1)

  const int tid = threadIdx.x;
  const int row = tid / LANES_PER_ROW;       // query row within the tile
  const int sub = tid % LANES_PER_ROW;       // lane within the row's group
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * BQ;
  const int offs = S - T_;                   // query t sits at key position offs+t

  // Stage the query tile (rows past T are zero and never written out).
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int t = q0 + r;
    Qs[r * DS + d] = t < T_ ? load_f32(q, ((long)(b * T_ + t) * H + h) * D + d) : 0.f;
  }

  // Keys any row of this tile can see.
  const int q_last = min(q0 + BQ, T_) - 1;
  const int pos_lo = offs + q0, pos_hi = offs + q_last;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  int kv_end = causal ? min(S, pos_hi + 1) : S;
  kv_begin = (kv_begin / BK) * BK;

  const int qpos = offs + q0 + row;
  float m = -INFINITY, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();                         // previous tile fully consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const long g = ((long)(b * S + s) * K + kh) * D + d;
        kx = load_f32(k, g);
        vx = load_f32(v, g);
      }
      Ks[r * DS + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    // Scores of this lane: row `row`, keys sub + 4*j.
    float s_[SCORES_PER_LANE];
#pragma unroll
    for (int j = 0; j < SCORES_PER_LANE; ++j) s_[j] = 0.f;
    const float* qr = Qs + row * DS;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < SCORES_PER_LANE; ++j)
        s_[j] = fmaf(qd, Ks[(sub + LANES_PER_ROW * j) * DS + d], s_[j]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < SCORES_PER_LANE; ++j) {
      const int kpos = k0 + sub + LANES_PER_ROW * j;
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s_[j] = ok ? s_[j] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s_[j]);
    }
#pragma unroll
    for (int w = 1; w < LANES_PER_ROW; w <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, w));

    const float m_new = fmaxf(m, tile_max);
    // Until the row has seen a visible key, m_new is -inf: keep p = 0 and
    // corr = 1 (acc and l are still 0) instead of exp(-inf - -inf).
    const bool seen = m_new != -INFINITY;
    const float corr = seen ? expf(m - m_new) : 1.f;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SCORES_PER_LANE; ++j) {
      const float p = seen ? expf(s_[j] - m_new) : 0.f;   // exp(-inf) = 0
      psum += p;
      Ps[row * (BK + 1) + sub + LANES_PER_ROW * j] = p;
    }
#pragma unroll
    for (int w = 1; w < LANES_PER_ROW; w <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, w);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();                            // the row's P is written by its warp

    const float* pr = Ps + row * (BK + 1);
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float* vr = Vs + j * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = sub + LANES_PER_ROW * c;
        if (d < D) acc[c] = fmaf(p, vr[d], acc[c]);
      }
    }
  }

  const int t = q0 + row;
  if (t < T_) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long base = ((long)(b * T_ + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + LANES_PER_ROW * c;
      if (d < D) {
        const float x = acc[c] * inv;
        store_f32(o, base + d, x);
        if (o_lo != nullptr) store_f32(o_lo, base + d, x - rounded(o, x));
      }
    }
    if (lse != nullptr && sub == 0)
      lse[(long)bh * T_ + t] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* o_lo, int B, int T_, int S, int H, int K,
                   int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                       (size_t)BK * D + (size_t)BQ * (BK + 1));
  auto kern = fa_fwd_kernel<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, static_cast<T*>(o_lo),
      T_, S, H, K, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, void* o_lo, int B, int T_, int S, int H,
                       int K, int D, int causal, int window, float scale,
                       cudaStream_t stream) {
  if (D <= 32) return launch<T, 8>(q, k, v, o, lse, o_lo, B, T_, S, H, K, D, causal, window, scale, stream);
  if (D <= 64) return launch<T, 16>(q, k, v, o, lse, o_lo, B, T_, S, H, K, D, causal, window, scale, stream);
  if (D <= 128) return launch<T, 32>(q, k, v, o, lse, o_lo, B, T_, S, H, K, D, causal, window, scale, stream);
  if (D <= 256) return launch<T, 64>(q, k, v, o, lse, o_lo, B, T_, S, H, K, D, causal, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 mma.sync path, head dims 16 and 32
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 64;          // query rows per block: 4 warps x 16 rows
constexpr int THREADS = 128;
constexpr int BK = 32;          // keys per KV tile

// Q, then two stages of K and of V.
template <int D>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * (D + PAD);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  __nv_bfloat16* __restrict__ o_lo, int T_, int S, int H,
                  int K, int causal, int window, float scale_log2) {
  constexpr int DP = D + PAD;       // row stride of the staged tiles
  constexpr int KC = D / 16;        // k-chunks of QK^T over the head dim
  constexpr int NS = BK / 8;        // score n-tiles per warp
  constexpr int NO = D / 8;         // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Kbuf = Qs + BQ * DP;
  __nv_bfloat16* Vbuf = Kbuf + 2 * BK * DP;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  // Heaviest causal tiles (last queries) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int offs = S - T_;

  const int q_last = min(q0 + BQ, T_) - 1;
  const int pos_lo = offs + q0, pos_hi = offs + q_last;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int kv_end = causal ? min(S, pos_hi + 1) : S;
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  // Pipeline: group 0 is the Q tile and the first K/V tile; each
  // iteration commits the next tile's group (empty past the last) before
  // it waits for its own, so one tile's copies overlap the current tile's
  // products.
  load_rows_async<BQ, D, THREADS>(Qs, q, b, q0, T_, H, h);
  if (n_tiles > 0) {
    load_rows_async<BK, D, THREADS>(Kbuf, k, b, kv_begin, S, K, kh);
    load_rows_async<BK, D, THREADS>(Vbuf, v, b, kv_begin, S, K, kh);
  }
  cp_async_commit();

  const int qpos[2] = {offs + q0 + warp * 16 + g, offs + q0 + warp * 16 + g + 8};
  // This warp's rows all see every key of a tile in [full_lo, full_hi).
  const int wpos_lo = offs + q0 + warp * 16, wpos_hi = wpos_lo + 15;
  const int full_lo = window > 0 ? wpos_hi - window + 1 : 0;
  const int full_hi = causal ? min(S, wpos_lo + 1) : S;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BK;
    const __nv_bfloat16* Ks = Kbuf + (it & 1) * BK * DP;
    const __nv_bfloat16* Vs = Vbuf + (it & 1) * BK * DP;
    if (it + 1 < n_tiles) {     // that stage was freed by the last barrier
      load_rows_async<BK, D, THREADS>(Kbuf + ((it + 1) & 1) * BK * DP, k, b,
                                      k0 + BK, S, K, kh);
      load_rows_async<BK, D, THREADS>(Vbuf + ((it + 1) & 1) * BK * DP, v, b,
                                      k0 + BK, S, K, kh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's BK keys.
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4];
      ldmatrix_x4(qa, a_frag_addr(Qs, DP, warp * 16, kc * 16));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, bt_frag_addr(Ks, DP, n * 8, kc * 16));
        mma_bf16(sc[n], qa, kb[0], kb[1]);
        mma_bf16(sc[n + 1], qa, kb[2], kb[3]);
      }
    }

    // Mask (only where the tile is not wholly visible to the warp), scale
    // into the log2 domain, running max per row.
    const bool full = k0 >= full_lo && k0 + BK <= full_hi;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        bool ok = true;
        if (!full) {
          const int kpos = k0 + n * 8 + 2 * t + (i & 1);
          ok = kpos < S;
          if (causal) ok = ok && kpos <= qpos[r];
          if (window > 0) ok = ok && kpos > qpos[r] - window;
        }
        const float x = ok ? sc[n][i] * scale_log2 : -INFINITY;
        sc[n][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
    bool seen[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      seen[r] = m_new != -INFINITY;
      corr[r] = seen[r] ? exp2f(m[r] - m_new) : 1.f;     // exp2(-inf) = 0
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = seen[r] ? exp2f(sc[n][i] - m[r]) : 0.f;
        sc[n][i] = p;
        ps[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * corr[r] + ps[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the score accumulators of key n-tiles 2j, 2j+1 are the A
    // fragment of key chunk j.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, b_frag_addr(Vs, DP, j * 16, n * 8));
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();            // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = q0 + warp * 16 + g + 8 * r;
    if (tq < T_) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      const long row = ((long)(b * T_ + tq) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
        uint32_t hi = pack_bf16(x0, x1);
        *reinterpret_cast<uint32_t*>(o + row + n * 8 + 2 * t) = hi;
        if (o_lo != nullptr) {
          const __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&hi);
          *reinterpret_cast<uint32_t*>(o_lo + row + n * 8 + 2 * t) =
              pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
        }
      }
      // m is in the log2 domain: lse = ln(2^m * l).
      if (lse != nullptr && t == 0)
        lse[(long)bh * T_ + tq] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* o_lo, int B, int T_, int S, int H, int K,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  auto kern = fa_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, static_cast<__nv_bfloat16*>(o_lo), T_, S, H, K, causal, window,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 wgmma path, head dims 64, 128 and 256 (helpers in wgmma_tma.cuh)
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

// Tiles per head dim: BM query rows a block (two consumer warpgroups of 64),
// BN keys a KV tile, STAGES KV tiles in the ring.  Mirrored by
// WGMMA_TILES in kernels/flash_attention.py.
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BM = 128, BN = 128, STAGES = 3; };
template <> struct Tiles<128> { static constexpr int BM = 128, BN = 128, STAGES = 2; };
template <> struct Tiles<256> { static constexpr int BM = 128, BN = 64, STAGES = 2; };

constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory, from a 1024-byte-aligned base: Q (BM x D), STAGES K tiles,
// STAGES V tiles (BN x D each), each stored as D/64 tiles of 64 columns;
// then the barriers.
template <int D>
struct Layout {
  static constexpr int BM = Tiles<D>::BM, BN = Tiles<D>::BN, STAGES = Tiles<D>::STAGES;
  static constexpr int HALVES = D / BOX;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;   // q_full, k_full[], v_full[], empty[]
  static constexpr size_t SMEM = BAR_OFF + N_BARS * 8 + 1024;   // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ o_lo, int T_, int S, int H,
                    int K, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int BM = L::BM, BN = L::BN, STAGES = L::STAGES;
  constexpr int NS = BN / 8;          // 8-key blocks of a score row
  constexpr int NO = D / 8;           // 8-column blocks of an output row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  // Blocks start in order of their linear index: the heaviest query tiles
  // (the last rows, under a causal mask) of every (b, h) go first.
  const int BH = gridDim.y;
  const int lin = blockIdx.x + blockIdx.y * gridDim.x;
  const int bh = lin % BH;
  const int q0 = (gridDim.x - 1 - lin / BH) * BM;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int offs = S - T_;             // query t sits at key position offs+t

  // Keys any row of this block can see, from a BN-aligned start.
  const int q_last = min(q0 + BM, T_) - 1;
  const int pos_lo = offs + q0, pos_hi = offs + q_last;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int kv_end = causal ? min(S, pos_hi + 1) : S;
  kv_begin = (kv_begin / BN) * BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // Producer warpgroup: one thread keeps the ring full with TMA copies.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::HALVES; ++c)
        tma_load_4d(Qs + c * BM * 128, &tq, q_full, c * BOX, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // Stage s is free once both consumers released tile j - STAGES.
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int k0 = kv_begin + j * BN;
        unsigned char* Ks = smem + L::K_OFF + s * L::KV_BYTES;
        unsigned char* Vs = smem + L::V_OFF + s * L::KV_BYTES;
        mbar_arrive_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::HALVES; ++c)
          tma_load_4d(Ks + c * BN * 128, &tk, &k_full[s], c * BOX, kh, k0, b);
        mbar_arrive_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::HALVES; ++c)
          tma_load_4d(Vs + c * BN * 128, &tv, &v_full[s], c * BOX, kh, k0, b);
      }
    }
  } else {
    // Consumer warpgroup wq: query rows q0 + 64 wq .. + 63.
    reg_alloc<CONSUMER_REGS>();
    const int wq = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wq + 16 * warp + g;          // and r0 + 8
    const int qpos[2] = {offs + q0 + r0, offs + q0 + r0 + 8};
    // This warp's rows all see every key of a tile in [full_lo, full_hi).
    const int wpos_lo = offs + q0 + 64 * wq + 16 * warp, wpos_hi = wpos_lo + 15;
    const int full_lo = window > 0 ? wpos_hi - window + 1 : 0;
    const int full_hi = causal ? min(S, wpos_lo + 1) : S;

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const int k0 = kv_begin + j * BN;
      const unsigned char* Ks = smem + L::K_OFF + s * L::KV_BYTES;
      const unsigned char* Vs = smem + L::V_OFF + s * L::KV_BYTES;

      // S = Q K^T: 64 rows x BN keys, D/16 k-steps, A = this warpgroup's Q
      // rows and B = the K tile, both K-major.
      float sc[BN / 2];
      mbar_wait(&k_full[s], ph);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        const uint64_t dq = desc_sw128(Qs + c * BM * 128 + wq * 64 * 128 + off, 16, 1024);
        const uint64_t dk = desc_sw128(Ks + c * BN * 128 + off, 16, 1024);
        if constexpr (BN == 64) wgmma_m64n64k16_ss(sc, dq, dk, kk > 0);
        else wgmma_m64n128k16_ss(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Mask (only where the tile is not wholly visible to the warp) and the
      // running max per row, on the unscaled scores: the scale is positive.
      const bool full = k0 >= full_lo && k0 + BN <= full_hi;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          if (!full) {
            const int kpos = k0 + n * 8 + 2 * t + (i & 1);
            bool ok = kpos < S;
            if (causal) ok = ok && kpos <= qpos[r];
            if (window > 0) ok = ok && kpos > qpos[r] - window;
            if (!ok) sc[4 * n + i] = -INFINITY;
          }
          mx[r] = fmaxf(mx[r], sc[4 * n + i]);
        }
      }
      // p = 2^(s * scale_log2 - mb) in one FFMA and one EX2.  Until the row
      // has seen a visible key its max is -inf, and mb = 0 keeps p =
      // 2^-inf = 0 instead of computing -inf - -inf; corr is then 0, which
      // leaves l and acc at 0.
      float corr[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        mb[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        corr[r] = exp2_ftz(m[r] * scale_log2 - mb[r]);
        m[r] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, -mb[r]));
          sc[4 * n + i] = p;
          ps[r] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
        ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
        l[r] = l[r] * corr[r] + ps[r];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[4 * n + 0] *= corr[0];
        acc[4 * n + 1] *= corr[0];
        acc[4 * n + 2] *= corr[1];
        acc[4 * n + 3] *= corr[1];
      }

      // O += P V: P in registers as the A operand (key blocks 2k and 2k+1
      // are k-step k), V (BN keys x D) MN-major from shared memory.  At
      // D=256 two m64n128k16 products a k-step, one per half of the
      // accumulator: V's 64-column tiles 0-1 and 2-3.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = tc::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = tc::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = tc::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = tc::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(&v_full[s], ph);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = desc_sw128(Vs + kk * 16 * 128, BN * 128, 1024);
        if constexpr (D == 64) {
          wgmma_m64n64k16_rs_tn(acc, pa[kk], dv, 1);
        } else if constexpr (D == 128) {
          wgmma_m64n128k16_rs_tn(acc, pa[kk], dv, 1);
        } else {
          const uint64_t dv_hi = desc_sw128(Vs + 2 * BN * 128 + kk * 16 * 128, BN * 128, 1024);
          wgmma_m64n128k16_rs_tn(*reinterpret_cast<float(*)[64]>(acc), pa[kk], dv, 1);
          wgmma_m64n128k16_rs_tn(*reinterpret_cast<float(*)[64]>(acc + 64), pa[kk], dv_hi, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&empty[s]);          // both products of this stage are done
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq = q0 + r0 + 8 * r;
      if (tq < T_) {
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
        const long row = ((long)(b * T_ + tq) * H + h) * D;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float x0 = acc[4 * n + 2 * r] * inv, x1 = acc[4 * n + 2 * r + 1] * inv;
          uint32_t hi = tc::pack_bf16(x0, x1);
          *reinterpret_cast<uint32_t*>(o + row + n * 8 + 2 * t) = hi;
          if (o_lo != nullptr) {
            const __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&hi);
            *reinterpret_cast<uint32_t*>(o_lo + row + n * 8 + 2 * t) =
                tc::pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
          }
        }
        // m is the unscaled max: lse = ln(2^(m * scale_log2) * l).
        if (lse != nullptr && t == 0)
          lse[(long)bh * T_ + tq] =
              l[r] > 0.f ? (m[r] * scale_log2 + log2f(l[r])) * tc::LN2 : -INFINITY;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* o_lo, int B, int T_, int S, int H, int K,
                   int causal, int window, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, T_, H, D, L::BM) || !encode(&tk, k, B, S, K, D, L::BN) ||
      !encode(&tv, v, B, S, K, D, L::BN))
    return cudaErrorInvalidValue;
  auto kern = fa_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + L::BM - 1) / L::BM, B * H);
  kern<<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
      static_cast<__nv_bfloat16*>(o_lo), T_, S, H, K, causal, window,
      scale * tc::LOG2E);
  return cudaGetLastError();
}

}  // namespace wg

// Which kernel a forward call takes: 2 = the bf16 wgmma kernel (head dims
// 64, 128 and 256), 1 = the bf16 mma.sync kernel (head dims 16 and 32), 0 =
// the f32-FMA kernel.  dtype as below; `aligned` is nonzero when q, k, v and
// o all start on 16 bytes (TMA and the 16-byte cp.async copies need it).
// repro_flash_attention_fwd dispatches by this function.
extern "C" int repro_flash_attention_fwd_path(int dtype, int D, int aligned) {
  if (dtype != 1 || !aligned) return 0;
  if (D == 64 || D == 128 || D == 256) return 2;
  return D == 16 || D == 32 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  All tensors are
// contiguous: q, o (B,T,H,D); k, v (B,S,K,D); lse (B,H,T) f32 or null.
// o_lo, (B,T,H,D) in o's dtype or null, receives what rounding the f32
// result to o lost (f32 - o, rounded), so that the backward's Delta =
// rowsum(dO * O) can read O to about 16 bits instead of bf16's 8; o itself
// is the same with or without it.  Returns the launch's cudaError_t (0 on
// success); the kernel runs asynchronously on `stream`.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* o_lo, int dtype, int B, int T, int S, int H, int K, int D,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || K <= 0 || H % K != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  switch (repro_flash_attention_fwd_path(dtype, D, aligned)) {
    case 2:
      if (D == 64) return (int)wg::launch<64>(q, k, v, o, ls, o_lo, B, T, S, H, K, causal, window, scale, st);
      if (D == 128) return (int)wg::launch<128>(q, k, v, o, ls, o_lo, B, T, S, H, K, causal, window, scale, st);
      return (int)wg::launch<256>(q, k, v, o, ls, o_lo, B, T, S, H, K, causal, window, scale, st);
    case 1:
      if (D == 16) return (int)tc::launch<16>(q, k, v, o, ls, o_lo, B, T, S, H, K, causal, window, scale, st);
      return (int)tc::launch<32>(q, k, v, o, ls, o_lo, B, T, S, H, K, causal, window, scale, st);
  }
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, ls, o_lo, B, T, S, H, K, D, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, ls, o_lo, B, T, S, H, K, D, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
