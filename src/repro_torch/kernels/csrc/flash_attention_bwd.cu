// Backward of flash attention for Hopper (sm_90a).
//
// The forward (flash_attention.cu) replaces the Pallas TPU kernel
// `flash_attention_pallas`, which has no backward: the reference trains
// through its chunked jnp attention (src/repro/kernels/ops.py) and lets JAX
// differentiate it.  Here attention on the card is a CUDA kernel, so its
// gradient is one too.  Same function as autograd of the plain attention:
// q (B,T,H,D), k, v (B,S,K,D), H % K == 0, query row t at key position
// S-T+t, optional causal mask and sliding window identical to the forward's.
//
// The FA2 scheme, with the forward's per-row log-sum-exp `lse` (B,H,T):
//   Delta_t = rowsum(dO_t * O_t)                          (delta kernel)
//   P = exp(S*scale - lse),  S = Q K^T, recomputed tile by tile
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// Delta reads O as o + o_lo, the forward's bf16 output plus the residual it
// lost in rounding: from the rounded o alone, Delta's error, summed over
// the thousand queries that see an early key, moves that key's dK by more
// than the bf16 tolerance (PERF.md).
// A row that sees no key has lse = -inf and gets P = 0, so it adds nothing
// and its dQ is 0 (never exp(s - -inf)).  Rows past T and keys past S are
// staged as zeros and masked.  Every launch is deterministic: no atomics,
// every sum in a fixed order.
//
// Two paths, chosen by repro_flash_attention_bwd_path (exported, so callers
// can ask which one a call takes):
//
// * bf16 with D in {16, 32, 64, 128, 256} and 16-byte aligned pointers (the
//   training path): tensor cores, mma.sync m16n8k16 with bf16 inputs and
//   f32 accumulation, ldmatrix / ldmatrix.trans (helpers in mma_bf16.cuh).
//   Four launches:
//   - delta kernel: one warp per (b, t, h) row.
//   - dK/dV kernel, one block per (64-key tile, b, kv head, group of query
//     heads).  FA2's scheme with keys as the rows.  Up to D=128 (128
//     threads) each warp owns 16 keys and computes S^T = K Q^T and
//     dP^T = V dO^T, forms P^T and dS^T = P^T (dP^T - Delta) in f32
//     registers, and repacks them as bf16 A fragments for dV += P^T dO and
//     dK += dS^T Q, with no shared memory round trip (as the forward
//     repacks P for P.V).  The dK and dV accumulators stay in registers
//     for the whole block: 128 a thread at D=128, so query tiles are 32
//     rows there (64 up to D=64).  The Q / dO tiles and their lse / Delta
//     are double-buffered with cp.async, so the next tile's copies overlap
//     the current tile's products.
//   - At D=256 (recurrentgemma's local layers) one warp's dK and dV would
//     be 256 registers a thread, over the 255 cap.  So the block has 256
//     threads, and two warps share each 16-key slab, each owning 128 of
//     the output columns (128 accumulators a thread, as at D=128).  The
//     pair splits S^T and dP^T rather than both computing them: one warp
//     computes S^T over all of D and forms P^T, the other dP^T; they swap
//     the two 16 x 32 f32 tiles through shared memory behind a named
//     barrier of their 64 threads, and each forms dS^T and runs dV and dK
//     on its columns.  So a pair does the 4 products of 2*D flops per
//     (key, query) that one warp does at D <= 128, not 6.  Shared memory:
//     K, V and two stages of Q and dO (32 queries) plus the exchange, 149
//     KB, one block per SM; 238 registers, no spills (ptxas -v, PERF.md).
//   - The H/K query heads of a KV head (GQA sums over them) are split into
//     G groups, G from the shape (repro_flash_attention_bwd_groups: enough
//     blocks for 512, at most H/K).  At the starcoder2-3b training shape
//     that gives G=4 and 16 x 8 x 4 = 512 blocks instead of 128, and at
//     recurrentgemma-9b's local training shape G=6 and 47 x 2 x 6 = 564.
//     Each block writes its f32 partial dK / dV to scratch that the caller
//     allocates (2 G B S K D floats: 34 MB and 74 MB there, written and
//     read once, about 20 and 44 us), and a reduce kernel sums the G
//     partials in a fixed order and rounds once.  The key tile is the
//     slowest block index, so the heaviest causal tiles (the first keys)
//     are issued first.
//   - dQ kernel, one block per (64-query tile, b, h), heaviest tiles first,
//     K / V tiles double-buffered with cp.async.  It recomputes S = Q K^T
//     and dP = dO V^T (7 products in all instead of 5, about 90 GFLOP at
//     the starcoder2 training shape) rather than reading dS back: writing
//     dS would be B H T S bf16, about 100 MB each way at that shape, more
//     than the whole bound, and accumulating dQ from the dK/dV blocks would
//     need atomics and give up determinism.  At D=256 it takes the
//     forward's budget and the warp pairs above: 32-key K / V tiles, Q and
//     dO fragments read from shared memory per k-chunk, one warp of a pair
//     computing S and P and the other dP, and each accumulating 128 of the
//     256 dQ columns (64 registers a thread); 148 KB of shared memory, one
//     block of 8 warps per SM, 129 registers.
// * everything else (f32, other head dims up to 256, unaligned pointers):
//   f32 FMAs on the CUDA cores, three launches (delta, dK/dV, dQ).  Each of
//   the 32 rows of a tile is owned by 8 lanes of one warp that split its 32
//   scores and its D output columns, so a row's P and dS go through shared
//   memory only within the warp; one block per (32-key tile, b, kv head)
//   sums the whole GQA group.  Staged rows are padded to D+1 floats so the
//   dot products read shared memory without bank conflicts.
//
// Bound on an H100 SXM: the five products of 2*D flops per visible (query,
// key) pair, at 989 TFLOP/s on the tensor cores, against the bytes (q, k,
// v, o, dO, lse read once; dq, dk, dv written once) at 3.35 TB/s.  At the
// starcoder2-3b training shape (B=4, T=S=1024, H=24, K=2, D=128, causal)
// that is 64.5 GFLOP, 65 us (0.0652 ms), against 109 MB, 33 us; at
// recurrentgemma-9b's local training shape (B=2, T=S=3000, H=16, K=1,
// D=256, window 2048) 331.6 GFLOP, 0.3353 ms, against 209 MB, 62 us.
// So both are bound by operations; the kernels do 7 products, not 5 (464
// GFLOP at the local shape).  The tensor-core path runs mma.sync from each
// warp in turn; wgmma, TMA and warp specialisation, which the card's full
// rate needs, are later work (ROADMAP.md).  The FMA path is bound by the
// CUDA cores' 67 TFLOP/s f32 rate at best.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BR = 32;          // rows (queries or keys) per tile
constexpr int THREADS = 256;    // 8 lanes per row
constexpr int LANES = THREADS / BR;
constexpr int PER_LANE = BR / LANES;   // scores per lane

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int S, int causal,
                                        int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Stage rows [r0, r0 + BR) of a (B, N, heads, D) tensor at (b, head) into
// shared memory as f32 with row stride D+1; rows past N are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0,
                                      int N, int heads, int head, int D) {
  const int DS = D + 1;
  for (int idx = threadIdx.x; idx < BR * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int n = r0 + r;
    dst[r * DS + d] =
        n < N ? load_f32(src, ((long)(b * N + n) * heads + head) * D + d) : 0.f;
  }
}

// Delta[b,h,t] = sum_d dO[b,t,h,d] * O[b,t,h,d], one warp per row, with O
// read as o + o_lo when the forward wrote its rounding residual o_lo.
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
             const T* __restrict__ dout, float* __restrict__ delta, int B,
             int T_, int H, int D) {
  const long row = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * T_ * H) return;             // whole warp leaves
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    float ov = load_f32(o, row * D + d);
    if (o_lo != nullptr) ov += load_f32(o_lo, row * D + d);
    acc = fmaf(load_f32(dout, row * D + d), ov, acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    // row enumerates (b, t, h); delta is laid out (b, h, t).
    const int h = row % H;
    const long bt = row / H;
    const int t = bt % T_, b = bt / T_;
    delta[((long)b * H + h) * T_ + t] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* o_lo, const void* dout,
                         float* delta, int B, int T_, int H, int D,
                         cudaStream_t stream) {
  const long rows = (long)B * T_ * H;
  const int rows_per_block = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    THREADS, 0, stream>>>(static_cast<const T*>(o),
                                          static_cast<const T*>(o_lo),
                                          static_cast<const T*>(dout), delta,
                                          B, T_, H, D);
  return cudaGetLastError();
}

// DPT: output columns per lane (>= ceil(D / 8)), so the accumulators stay
// in registers.
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int T_, int S, int H,
            int K, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Ks = smem;                  // BR x DS
  float* Vs = Ks + BR * DS;          // BR x DS
  float* Qs = Vs + BR * DS;          // BR x DS
  float* dOs = Qs + BR * DS;         // BR x DS
  float* Ps = dOs + BR * DS;         // BR x (BR+1), [key][query]
  float* dSs = Ps + BR * (BR + 1);   // BR x (BR+1), [key][query]
  float* lse_s = dSs + BR * (BR + 1);
  float* delta_s = lse_s + BR;

  const int tid = threadIdx.x;
  const int row = tid / LANES;       // key row within the tile
  const int sub = tid % LANES;
  const int bk = blockIdx.y;
  const int b = bk / K, kh = bk % K;
  const int rep = H / K;
  const int k0 = blockIdx.x * BR;
  const int offs = S - T_;
  const int kpos = k0 + row;

  stage(Ks, k, b, k0, S, K, kh, D);
  stage(Vs, v, b, k0, S, K, kh, D);

  // Queries that can see some key of this tile: causal needs
  // offs + t >= k0, a window needs offs + t < k_last + window.
  const int k_last = min(k0 + BR, S) - 1;
  int t_begin = causal ? max(0, k0 - offs) : 0;
  const int t_end = window > 0 ? min(T_, k_last - offs + window) : T_;
  t_begin = (t_begin / BR) * BR;

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    const float* lse_bh = lse + ((long)b * H + h) * T_;
    const float* delta_bh = delta + ((long)b * H + h) * T_;
    for (int q0 = t_begin; q0 < t_end; q0 += BR) {
      __syncthreads();                 // previous tile fully consumed
      stage(Qs, q, b, q0, T_, H, h, D);
      stage(dOs, dout, b, q0, T_, H, h, D);
      if (tid < BR) {
        const int t = q0 + tid;
        lse_s[tid] = t < T_ ? lse_bh[t] : -INFINITY;
        delta_s[tid] = t < T_ ? delta_bh[t] : 0.f;
      }
      __syncthreads();

      // This lane's queries: sub + 8*j.  s = K_row . Q_j, dp = V_row . dO_j.
      float s_[PER_LANE], dp[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) s_[j] = dp[j] = 0.f;
      const float* kr = Ks + row * DS;
      const float* vr = Vs + row * DS;
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
          const int qi = sub + LANES * j;
          s_[j] = fmaf(kd, Qs[qi * DS + d], s_[j]);
          dp[j] = fmaf(vd, dOs[qi * DS + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int qi = sub + LANES * j;
        const float l = lse_s[qi];
        const bool ok = l != -INFINITY &&
                        visible(kpos, offs + q0 + qi, S, causal, window);
        const float p = ok ? expf(s_[j] * scale - l) : 0.f;
        Ps[row * (BR + 1) + qi] = p;
        dSs[row * (BR + 1) + qi] = p * (dp[j] - delta_s[qi]);
      }
      __syncwarp();                    // the row's P and dS are its warp's

      const float* pr = Ps + row * (BR + 1);
      const float* dsr = dSs + row * (BR + 1);
      for (int j = 0; j < BR; ++j) {
        const float p = pr[j], ds = dsr[j];
        const float* qj = Qs + j * DS;
        const float* doj = dOs + j * DS;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int d = sub + LANES * c;
          if (d < D) {
            dv_acc[c] = fmaf(p, doj[d], dv_acc[c]);
            dk_acc[c] = fmaf(ds, qj[d], dk_acc[c]);
          }
        }
      }
    }
  }

  if (kpos < S) {
    const long base = ((long)(b * S + kpos) * K + kh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + LANES * c;
      if (d < D) {
        store_f32(dk, base + d, dk_acc[c] * scale);
        store_f32(dv, base + d, dv_acc[c]);
      }
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int T_, int S, int H, int K, int D, int causal,
          int window, float scale) {
  extern __shared__ float smem[];
  const int DS = D + 1;
  float* Qs = smem;                  // BR x DS
  float* dOs = Qs + BR * DS;         // BR x DS
  float* Ks = dOs + BR * DS;         // BR x DS
  float* Vs = Ks + BR * DS;          // BR x DS
  float* dSs = Vs + BR * DS;         // BR x (BR+1), [query][key]

  const int tid = threadIdx.x;
  const int row = tid / LANES;       // query row within the tile
  const int sub = tid % LANES;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * BR;
  const int offs = S - T_;
  const int t = q0 + row;
  const int qpos = offs + t;

  stage(Qs, q, b, q0, T_, H, h, D);
  stage(dOs, dout, b, q0, T_, H, h, D);
  const float l = t < T_ ? lse[(long)bh * T_ + t] : -INFINITY;
  const float dl = t < T_ ? delta[(long)bh * T_ + t] : 0.f;

  // Keys any row of this tile can see (as the forward).
  const int q_last = min(q0 + BR, T_) - 1;
  int kv_begin = window > 0 ? max(0, offs + q0 - window + 1) : 0;
  const int kv_end = causal ? min(S, offs + q_last + 1) : S;
  kv_begin = (kv_begin / BR) * BR;

  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BR) {
    __syncthreads();                   // previous tile fully consumed
    stage(Ks, k, b, k0, S, K, kh, D);
    stage(Vs, v, b, k0, S, K, kh, D);
    __syncthreads();

    // This lane's keys: sub + 8*j.
    float s_[PER_LANE], dp[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s_[j] = dp[j] = 0.f;
    const float* qr = Qs + row * DS;
    const float* dor = dOs + row * DS;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dod = dor[d];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int kj = sub + LANES * j;
        s_[j] = fmaf(qd, Ks[kj * DS + d], s_[j]);
        dp[j] = fmaf(dod, Vs[kj * DS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int kj = sub + LANES * j;
      const bool ok = l != -INFINITY &&
                      visible(k0 + kj, qpos, S, causal, window);
      const float p = ok ? expf(s_[j] * scale - l) : 0.f;
      dSs[row * (BR + 1) + kj] = p * (dp[j] - dl);
    }
    __syncwarp();                      // the row's dS is its warp's

    const float* dsr = dSs + row * (BR + 1);
    for (int j = 0; j < BR; ++j) {
      const float ds = dsr[j];
      const float* kr = Ks + j * DS;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = sub + LANES * c;
        if (d < D) acc[c] = fmaf(ds, kr[d], acc[c]);
      }
    }
  }

  if (t < T_) {
    const long base = ((long)(b * T_ + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + LANES * c;
      if (d < D) store_f32(dq, base + d, acc[c] * scale);
    }
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* o_lo, const void* dout,
                   const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int T_,
                   int S, int H, int K, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err = launch_delta<T>(o, o_lo, dout, delta, B, T_, H, D, stream);
  if (err != cudaSuccess) return err;

  const size_t tile = sizeof(float) * (size_t)BR * (D + 1);
  const size_t scores = sizeof(float) * (size_t)BR * (BR + 1);
  const size_t smem_kv = 4 * tile + 2 * scores + 2 * sizeof(float) * BR;
  auto kv_kern = dkdv_kernel<T, DPT>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((S + BR - 1) / BR, B * K), THREADS, smem_kv, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      T_, S, H, K, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = 4 * tile + scores;
  auto q_kern = dq_kernel<T, DPT>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((T_ + BR - 1) / BR, B * H), THREADS, smem_q, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), T_, S, H, K, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* o_lo, const void* dout,
                       const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int T_, int S, int H, int K, int D, int causal,
                       int window, float scale, cudaStream_t st) {
  if (D <= 32) return launch<T, 4>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 64) return launch<T, 8>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 128) return launch<T, 16>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 256) return launch<T, 32>(q, k, v, o, o_lo, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------
namespace tc {

constexpr int THREADS = 128;      // 4 warps x 16 rows
constexpr int BKV = 64;           // keys per dK/dV block and per dQ KV tile
constexpr int BQ_DQ = 64;         // queries per dQ block
constexpr int TARGET_BLOCKS = 512;  // dK/dV blocks the group split aims at
constexpr int REDUCE_THREADS = 256;

// Queries per tile of the dK/dV pass.  A warp owns 16 keys and keeps their
// dK and dV accumulators (2 * D/2 f32 registers a thread) for the whole
// block; at D=128 that is 128 registers, so the tiles hold 32 queries
// (S^T and dP^T 16 registers each) and not 64.
template <int D>
__host__ __device__ constexpr int dkdv_bq() { return D <= 64 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BKV + 4 * dkdv_bq<D>()) * (D + PAD) +
         sizeof(float) * 4 * dkdv_bq<D>();
}

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BQ_DQ + 4 * BKV) * (D + PAD);
}

// dK/dV partials of one (key tile, b, kv head, group of query heads).
// Warp w owns keys k0+16w .. k0+16w+15 and computes, per query tile,
// S^T = K Q^T and dP^T = V dO^T (keys as the accumulator's rows), then
// P^T = exp(S^T * scale - lse) and dS^T = P^T * (dP^T - Delta) in f32
// registers, repacked as bf16 A fragments for dV += P^T dO and
// dK += dS^T Q.  Q / dO tiles (and their lse / Delta) are double-buffered
// with cp.async across the flattened loop over (head, query tile).  The
// unscaled f32 sums go to dk_part / dv_part (groups, B, S, K, D).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    int B, int T_, int S, int H, int K, int groups, int causal,
                    int window, float scale_log2) {
  constexpr int BQ = dkdv_bq<D>();
  constexpr int DP = D + PAD;
  constexpr int KC = D / 16;        // k-chunks of S^T and dP^T over D
  constexpr int NQ = BQ / 8;        // query n-tiles of S^T and dP^T
  constexpr int NO = D / 8;         // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BKV * DP;
  __nv_bfloat16* Qbuf = Vs + BKV * DP;          // two stages
  __nv_bfloat16* dObuf = Qbuf + 2 * BQ * DP;    // two stages
  float* lse_buf = reinterpret_cast<float*>(dObuf + 2 * BQ * DP);
  float* dl_buf = lse_buf + 2 * BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // The key tile is the slowest index, so the blocks issued first hold the
  // first key tiles: the heaviest under a causal mask.
  const int per_tile = B * K * groups;
  const int kt = blockIdx.x / per_tile;
  int rest = blockIdx.x % per_tile;
  const int grp = rest % groups;
  rest /= groups;
  const int kh = rest % K, b = rest / K;
  const int rep = H / K;
  const int h_begin = kh * rep + grp * rep / groups;
  const int h_end = kh * rep + (grp + 1) * rep / groups;
  const int k0 = kt * BKV;
  const int offs = S - T_;

  // Queries that can see some key of this tile: causal needs
  // offs + t >= k0, a window needs offs + t < k_last + window.
  const int k_last = min(k0 + BKV, S) - 1;
  int t_begin = causal ? max(0, k0 - offs) : 0;
  const int t_end = window > 0 ? min(T_, k_last - offs + window) : T_;
  t_begin = (t_begin / BQ) * BQ;
  const int n_qt = t_end > t_begin ? (t_end - t_begin + BQ - 1) / BQ : 0;
  const int n_iter = n_qt * (h_end - h_begin);

  auto issue = [&](int it) {
    const int h = h_begin + it / n_qt, q0 = t_begin + (it % n_qt) * BQ;
    const int st = it & 1;
    load_rows_async<BQ, D, THREADS>(Qbuf + st * BQ * DP, q, b, q0, T_, H, h);
    load_rows_async<BQ, D, THREADS>(dObuf + st * BQ * DP, dout, b, q0, T_, H, h);
    if (tid < BQ) {
      const int tq = q0 + tid;
      const long i = ((long)b * H + h) * T_ + min(tq, T_ - 1);
      cp_async_4(lse_buf + st * BQ + tid, lse + i, tq < T_);
      cp_async_4(dl_buf + st * BQ + tid, delta + i, tq < T_);
    }
  };

  // Group 0: the block's K and V tiles and the first query tile.
  load_rows_async<BKV, D, THREADS>(Ks, k, b, k0, S, K, kh);
  load_rows_async<BKV, D, THREADS>(Vs, v, b, k0, S, K, kh);
  if (n_iter > 0) issue(0);
  cp_async_commit();

  const int kr0 = warp * 16;
  const int kpos[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = t_begin + (it % n_qt) * BQ;
    const int st = it & 1;
    if (it + 1 < n_iter) issue(it + 1);   // that stage was freed by the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Qs = Qbuf + st * BQ * DP;
    const __nv_bfloat16* dOs = dObuf + st * BQ * DP;
    const float* lse_s = lse_buf + st * BQ;
    const float* dl_s = dl_buf + st * BQ;

    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sT[n][i] = dpT[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, a_frag_addr(Ks, DP, kr0, kc * 16));
      ldmatrix_x4(va, a_frag_addr(Vs, DP, kr0, kc * 16));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t qb[4], ob[4];
        ldmatrix_x4(qb, bt_frag_addr(Qs, DP, n * 8, kc * 16));
        mma_bf16(sT[n], ka, qb[0], qb[1]);
        mma_bf16(sT[n + 1], ka, qb[2], qb[3]);
        ldmatrix_x4(ob, bt_frag_addr(dOs, DP, n * 8, kc * 16));
        mma_bf16(dpT[n], va, ob[0], ob[1]);
        mma_bf16(dpT[n + 1], va, ob[2], ob[3]);
      }
    }

    // P^T and dS^T in place.  A query past T, a key past S, a masked pair
    // and a row that sees no key (lse = -inf) all give P = 0.
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int qi = n * 8 + 2 * t + (i & 1);
        const int tq = q0 + qi, qpos = offs + tq;
        const float l = lse_s[qi];
        bool ok = tq < T_ && kpos[r] < S && l != -INFINITY;
        if (causal) ok = ok && kpos[r] <= qpos;
        if (window > 0) ok = ok && kpos[r] > qpos - window;
        const float p = ok ? exp2f(sT[n][i] * scale_log2 - l * LOG2E) : 0.f;
        dpT[n][i] = p * (dpT[n][i] - dl_s[qi]);
        sT[n][i] = p;
      }
    }

    // dV += P^T dO and dK += dS^T Q: n-tiles 2j, 2j+1 of P^T and dS^T are
    // the A fragments of query chunk j.
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sT[2 * j][0], sT[2 * j][1]),
                              pack_bf16(sT[2 * j][2], sT[2 * j][3]),
                              pack_bf16(sT[2 * j + 1][0], sT[2 * j + 1][1]),
                              pack_bf16(sT[2 * j + 1][2], sT[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpT[2 * j][0], dpT[2 * j][1]),
                              pack_bf16(dpT[2 * j][2], dpT[2 * j][3]),
                              pack_bf16(dpT[2 * j + 1][0], dpT[2 * j + 1][1]),
                              pack_bf16(dpT[2 * j + 1][2], dpT[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, b_frag_addr(dOs, DP, j * 16, n * 8));
        mma_bf16(dv[n], pa, ob[0], ob[1]);
        mma_bf16(dv[n + 1], pa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, b_frag_addr(Qs, DP, j * 16, n * 8));
        mma_bf16(dk[n], da, qb[0], qb[1]);
        mma_bf16(dk[n + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();            // this stage is free for the tile after next
  }

  // Every key of the tile below S gets its partial, zero if no query saw it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] < S) {
      const long base = ((((long)grp * B + b) * S + kpos[r]) * K + kh) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(dk_part + base + n * 8 + 2 * t) =
            make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + base + n * 8 + 2 * t) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ of one (query tile of 64 rows, b, h), walking the KV tiles its rows
// can see as the forward does: S = Q K^T and dP = dO V^T, then P and
// dS = P * (dP - Delta) in registers, repacked as the A fragment of
// dQ += dS K.  K / V tiles are double-buffered with cp.async.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int T_, int S, int H, int K,
                  int causal, int window, float scale_log2, float scale) {
  constexpr int BQ = BQ_DQ;
  constexpr int DP = D + PAD;
  constexpr int KC = D / 16;
  constexpr int NS = BKV / 8;       // key n-tiles of S and dP
  constexpr int NO = D / 8;         // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * DP;
  __nv_bfloat16* Kbuf = dOs + BQ * DP;          // two stages
  __nv_bfloat16* Vbuf = Kbuf + 2 * BKV * DP;    // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  // Heaviest causal tiles (last queries) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int offs = S - T_;

  const int q_last = min(q0 + BQ, T_) - 1;
  int kv_begin = window > 0 ? max(0, offs + q0 - window + 1) : 0;
  const int kv_end = causal ? min(S, offs + q_last + 1) : S;
  kv_begin = (kv_begin / BKV) * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  int tq[2], qpos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tq[r] = q0 + warp * 16 + g + 8 * r;
    qpos[r] = offs + tq[r];
    const bool in = tq[r] < T_;
    l2[r] = in ? lse[(long)bh * T_ + tq[r]] * LOG2E : -INFINITY;
    dl[r] = in ? delta[(long)bh * T_ + tq[r]] : 0.f;
  }

  // Group 0: Q, dO and the first K/V tile.
  load_rows_async<BQ, D, THREADS>(Qs, q, b, q0, T_, H, h);
  load_rows_async<BQ, D, THREADS>(dOs, dout, b, q0, T_, H, h);
  if (n_tiles > 0) {
    load_rows_async<BKV, D, THREADS>(Kbuf, k, b, kv_begin, S, K, kh);
    load_rows_async<BKV, D, THREADS>(Vbuf, v, b, kv_begin, S, K, kh);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BKV;
    const __nv_bfloat16* Ks = Kbuf + (it & 1) * BKV * DP;
    const __nv_bfloat16* Vs = Vbuf + (it & 1) * BKV * DP;
    if (it + 1 < n_tiles) {     // that stage was freed by the last barrier
      load_rows_async<BKV, D, THREADS>(Kbuf + ((it + 1) & 1) * BKV * DP, k, b,
                                       k0 + BKV, S, K, kh);
      load_rows_async<BKV, D, THREADS>(Vbuf + ((it + 1) & 1) * BKV * DP, v, b,
                                       k0 + BKV, S, K, kh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, a_frag_addr(Qs, DP, warp * 16, kc * 16));
      ldmatrix_x4(oa, a_frag_addr(dOs, DP, warp * 16, kc * 16));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, bt_frag_addr(Ks, DP, n * 8, kc * 16));
        mma_bf16(sc[n], qa, kb[0], kb[1]);
        mma_bf16(sc[n + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, bt_frag_addr(Vs, DP, n * 8, kc * 16));
        mma_bf16(dp[n], oa, vb[0], vb[1]);
        mma_bf16(dp[n + 1], oa, vb[2], vb[3]);
      }
    }

#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int kpos = k0 + n * 8 + 2 * t + (i & 1);
        bool ok = kpos < S && l2[r] != -INFINITY;
        if (causal) ok = ok && kpos <= qpos[r];
        if (window > 0) ok = ok && kpos > qpos[r] - window;
        const float p = ok ? exp2f(sc[n][i] * scale_log2 - l2[r]) : 0.f;
        dp[n][i] = p * (dp[n][i] - dl[r]);
      }
    }

#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, b_frag_addr(Ks, DP, j * 16, n * 8));
        mma_bf16(acc[n], da, kb[0], kb[1]);
        mma_bf16(acc[n + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();            // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tq[r] < T_) {
      __nv_bfloat16* row = dq + ((long)(b * T_ + tq[r]) * H + h) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dim 256: pairs of warps split the output columns
// ---------------------------------------------------------------------------
// A warp that owns 16 rows cannot hold their outputs at D=256: dK and dV
// would be 256 f32 registers a thread.  So two warps share each 16-row
// slab, and each owns D/2 of the output columns: dK and dV are then 128
// registers a thread, as at D=128, and dQ 64.  The pair splits the two
// score products, each over all of D, rather than both recomputing them:
// role 0 computes the scores and turns them into P, role 1 the score
// gradients dP.  Each writes its 16 x N f32 tile to shared memory in the
// accumulator's lane order, a named barrier of the pair's 64 threads
// orders the exchange, and each reads the other's.  Both form
// dS = P (dP - Delta) in f32 from the same bits, round P and dS to bf16 as
// the kernels above do, and run the output products on their columns.

constexpr int PAIR_THREADS = 256;   // 4 pairs of warps, one 16-row slab each
constexpr int PAIR_BQ = 32;         // queries per Q / dO tile of the dK/dV pass
constexpr int PAIR_BK = 32;         // keys per K / V tile of the dQ pass

// The f32 exchange tiles: 8 warps x (N/8 n-tiles x 4 values x 32 lanes).
__host__ __device__ constexpr size_t xchg_floats(int N) { return 8 * 16 * (size_t)N; }

template <int D>
__host__ __device__ constexpr size_t dkdv_pair_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BKV + 4 * PAIR_BQ) * (D + PAD) +
         sizeof(float) * (4 * PAIR_BQ + xchg_floats(PAIR_BQ));
}

template <int D>
__host__ __device__ constexpr size_t dq_pair_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BQ_DQ + 4 * PAIR_BK) * (D + PAD) +
         sizeof(float) * xchg_floats(PAIR_BK);
}

// This warp's NT n-tiles `x` to its slot of `xchg`, its partner's back in
// `y`, behind the pair's named barrier (ids 1-4; 0 is __syncthreads).  The
// block barrier that ends each tile frees the slots for the next.
template <int NT>
__device__ __forceinline__ void pair_exchange(float* xchg, int pair, int role,
                                              const float (&x)[NT][4],
                                              float (&y)[NT][4]) {
  const int lane = threadIdx.x % 32;
  float4* mine = reinterpret_cast<float4*>(xchg) + (pair * 2 + role) * NT * 32;
  const float4* theirs =
      reinterpret_cast<const float4*>(xchg) + (pair * 2 + (role ^ 1)) * NT * 32;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    mine[n * 32 + lane] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
  asm volatile("bar.sync %0, 64;\n" :: "r"(pair + 1) : "memory");
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 o = theirs[n * 32 + lane];
    y[n][0] = o.x; y[n][1] = o.y; y[n][2] = o.z; y[n][3] = o.w;
  }
}

// Role 0's x (P) and role 1's x (dP) after the exchange: P into x and
// dS = P (dP - Delta) into y, in f32, the same bits in both warps.
// dl(n, i) is the Delta of accumulator element (n, i).
template <int NT, typename DeltaAt>
__device__ __forceinline__ void pair_p_ds(int role, float (&x)[NT][4],
                                          float (&y)[NT][4], DeltaAt dl) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = role ? y[n][i] : x[n][i];
      const float dp = role ? x[n][i] : y[n][i];
      x[n][i] = p;
      y[n][i] = p * (dp - dl(n, i));
    }
}

// dK/dV partials of one (64-key tile, b, kv head, group of query heads),
// as bwd_dkdv_mma_kernel: pair w/2 owns keys k0+16(w/2) .. +15 and warp w
// columns (w%2) D/2 .. +D/2-1 of their dK and dV.  Per 32-query tile, role
// 0 computes S^T = K Q^T and P^T, role 1 dP^T = V dO^T; after the
// exchange each accumulates dV += P^T dO and dK += dS^T Q on its columns.
template <int D>
__global__ void __launch_bounds__(PAIR_THREADS)
bwd_dkdv_pair_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int B, int T_, int S, int H, int K, int groups, int causal,
                     int window, float scale_log2) {
  constexpr int BQ = PAIR_BQ;
  constexpr int DP = D + PAD;
  constexpr int KC = D / 16;        // k-chunks of S^T and dP^T over D
  constexpr int NQ = BQ / 8;        // query n-tiles of S^T and dP^T
  constexpr int NH = D / 16;        // n-tiles of a warp's half of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BKV * DP;
  __nv_bfloat16* Qbuf = Vs + BKV * DP;          // two stages
  __nv_bfloat16* dObuf = Qbuf + 2 * BQ * DP;    // two stages
  float* lse_buf = reinterpret_cast<float*>(dObuf + 2 * BQ * DP);
  float* dl_buf = lse_buf + 2 * BQ;
  float* xchg = dl_buf + 2 * BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, role = warp & 1;
  const int per_tile = B * K * groups;
  const int kt = blockIdx.x / per_tile;
  int rest = blockIdx.x % per_tile;
  const int grp = rest % groups;
  rest /= groups;
  const int kh = rest % K, b = rest / K;
  const int rep = H / K;
  const int h_begin = kh * rep + grp * rep / groups;
  const int h_end = kh * rep + (grp + 1) * rep / groups;
  const int k0 = kt * BKV;
  const int offs = S - T_;

  const int k_last = min(k0 + BKV, S) - 1;
  int t_begin = causal ? max(0, k0 - offs) : 0;
  const int t_end = window > 0 ? min(T_, k_last - offs + window) : T_;
  t_begin = (t_begin / BQ) * BQ;
  const int n_qt = t_end > t_begin ? (t_end - t_begin + BQ - 1) / BQ : 0;
  const int n_iter = n_qt * (h_end - h_begin);

  auto issue = [&](int it) {
    const int h = h_begin + it / n_qt, q0 = t_begin + (it % n_qt) * BQ;
    const int st = it & 1;
    load_rows_async<BQ, D, PAIR_THREADS>(Qbuf + st * BQ * DP, q, b, q0, T_, H, h);
    load_rows_async<BQ, D, PAIR_THREADS>(dObuf + st * BQ * DP, dout, b, q0, T_, H, h);
    if (tid < BQ) {
      const int tq = q0 + tid;
      const long i = ((long)b * H + h) * T_ + min(tq, T_ - 1);
      cp_async_4(lse_buf + st * BQ + tid, lse + i, tq < T_);
      cp_async_4(dl_buf + st * BQ + tid, delta + i, tq < T_);
    }
  };

  load_rows_async<BKV, D, PAIR_THREADS>(Ks, k, b, k0, S, K, kh);
  load_rows_async<BKV, D, PAIR_THREADS>(Vs, v, b, k0, S, K, kh);
  if (n_iter > 0) issue(0);
  cp_async_commit();

  const int kr0 = pair * 16;
  const int kpos[2] = {k0 + kr0 + g, k0 + kr0 + g + 8};
  const int c0 = role * (D / 2);              // this warp's output columns
  const __nv_bfloat16* rows = role ? Vs : Ks;  // A of this warp's score product
  float dk[NH][4], dv[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = t_begin + (it % n_qt) * BQ;
    const int st = it & 1;
    if (it + 1 < n_iter) issue(it + 1);   // that stage was freed by the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Qs = Qbuf + st * BQ * DP;
    const __nv_bfloat16* dOs = dObuf + st * BQ * DP;
    const float* lse_s = lse_buf + st * BQ;
    const float* dl_s = dl_buf + st * BQ;
    const __nv_bfloat16* cols = role ? dOs : Qs;

    float x[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag_addr(rows, DP, kr0, kc * 16));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t bq[4];
        ldmatrix_x4(bq, bt_frag_addr(cols, DP, n * 8, kc * 16));
        mma_bf16(x[n], a, bq[0], bq[1]);
        mma_bf16(x[n + 1], a, bq[2], bq[3]);
      }
    }
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int qi = n * 8 + 2 * t + (i & 1);
          const int tq = q0 + qi, qpos = offs + tq;
          const float l = lse_s[qi];
          bool ok = tq < T_ && kpos[r] < S && l != -INFINITY;
          if (causal) ok = ok && kpos[r] <= qpos;
          if (window > 0) ok = ok && kpos[r] > qpos - window;
          x[n][i] = ok ? exp2f(x[n][i] * scale_log2 - l * LOG2E) : 0.f;
        }
      }
    }
    float y[NQ][4];
    pair_exchange<NQ>(xchg, pair, role, x, y);
    pair_p_ds<NQ>(role, x, y, [&](int n, int i) {
      return dl_s[n * 8 + 2 * t + (i & 1)];
    });

#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                              pack_bf16(x[2 * j][2], x[2 * j][3]),
                              pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                              pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(y[2 * j][0], y[2 * j][1]),
                              pack_bf16(y[2 * j][2], y[2 * j][3]),
                              pack_bf16(y[2 * j + 1][0], y[2 * j + 1][1]),
                              pack_bf16(y[2 * j + 1][2], y[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NH; n += 2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, b_frag_addr(dOs, DP, j * 16, c0 + n * 8));
        mma_bf16(dv[n], pa, ob[0], ob[1]);
        mma_bf16(dv[n + 1], pa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, b_frag_addr(Qs, DP, j * 16, c0 + n * 8));
        mma_bf16(dk[n], da, qb[0], qb[1]);
        mma_bf16(dk[n + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();            // this stage and the exchange slots are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] < S) {
      const long base = ((((long)grp * B + b) * S + kpos[r]) * K + kh) * D + c0;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        *reinterpret_cast<float2*>(dk_part + base + n * 8 + 2 * t) =
            make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + base + n * 8 + 2 * t) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ of one (64-query tile, b, h), as bwd_dq_mma_kernel with the forward's
// D=256 budget: 32-key K / V tiles double-buffered with cp.async, Q and dO
// fragments read from shared memory per k-chunk.  Pair w/2 owns queries
// q0+16(w/2) .. +15 and warp w columns (w%2) D/2 .. +D/2-1 of their dQ;
// role 0 computes S = Q K^T and P, role 1 dP = dO V^T, and after the
// exchange each accumulates dQ += dS K on its columns.
template <int D>
__global__ void __launch_bounds__(PAIR_THREADS)
bwd_dq_pair_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int T_, int S, int H, int K,
                   int causal, int window, float scale_log2, float scale) {
  constexpr int BQ = BQ_DQ;
  constexpr int BK = PAIR_BK;
  constexpr int DP = D + PAD;
  constexpr int KC = D / 16;
  constexpr int NS = BK / 8;        // key n-tiles of S and dP
  constexpr int NH = D / 16;        // n-tiles of a warp's half of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * DP;
  __nv_bfloat16* Kbuf = dOs + BQ * DP;          // two stages
  __nv_bfloat16* Vbuf = Kbuf + 2 * BK * DP;     // two stages
  float* xchg = reinterpret_cast<float*>(Vbuf + 2 * BK * DP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, role = warp & 1;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  // Heaviest causal tiles (last queries) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int offs = S - T_;

  const int q_last = min(q0 + BQ, T_) - 1;
  int kv_begin = window > 0 ? max(0, offs + q0 - window + 1) : 0;
  const int kv_end = causal ? min(S, offs + q_last + 1) : S;
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  int tq[2], qpos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tq[r] = q0 + pair * 16 + g + 8 * r;
    qpos[r] = offs + tq[r];
    const bool in = tq[r] < T_;
    l2[r] = in ? lse[(long)bh * T_ + tq[r]] * LOG2E : -INFINITY;
    dl[r] = in ? delta[(long)bh * T_ + tq[r]] : 0.f;
  }

  load_rows_async<BQ, D, PAIR_THREADS>(Qs, q, b, q0, T_, H, h);
  load_rows_async<BQ, D, PAIR_THREADS>(dOs, dout, b, q0, T_, H, h);
  if (n_tiles > 0) {
    load_rows_async<BK, D, PAIR_THREADS>(Kbuf, k, b, kv_begin, S, K, kh);
    load_rows_async<BK, D, PAIR_THREADS>(Vbuf, v, b, kv_begin, S, K, kh);
  }
  cp_async_commit();

  const int c0 = role * (D / 2);              // this warp's output columns
  const __nv_bfloat16* rows = role ? dOs : Qs; // A of this warp's score product
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BK;
    const __nv_bfloat16* Ks = Kbuf + (it & 1) * BK * DP;
    const __nv_bfloat16* Vs = Vbuf + (it & 1) * BK * DP;
    if (it + 1 < n_tiles) {     // that stage was freed by the last barrier
      load_rows_async<BK, D, PAIR_THREADS>(Kbuf + ((it + 1) & 1) * BK * DP, k, b,
                                           k0 + BK, S, K, kh);
      load_rows_async<BK, D, PAIR_THREADS>(Vbuf + ((it + 1) & 1) * BK * DP, v, b,
                                           k0 + BK, S, K, kh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cols = role ? Vs : Ks;

    float x[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag_addr(rows, DP, pair * 16, kc * 16));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, bt_frag_addr(cols, DP, n * 8, kc * 16));
        mma_bf16(x[n], a, kb[0], kb[1]);
        mma_bf16(x[n + 1], a, kb[2], kb[3]);
      }
    }
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int kpos = k0 + n * 8 + 2 * t + (i & 1);
          bool ok = kpos < S && l2[r] != -INFINITY;
          if (causal) ok = ok && kpos <= qpos[r];
          if (window > 0) ok = ok && kpos > qpos[r] - window;
          x[n][i] = ok ? exp2f(x[n][i] * scale_log2 - l2[r]) : 0.f;
        }
      }
    }
    float y[NS][4];
    pair_exchange<NS>(xchg, pair, role, x, y);
    pair_p_ds<NS>(role, x, y, [&](int, int i) { return dl[i >> 1]; });

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(y[2 * j][0], y[2 * j][1]),
                              pack_bf16(y[2 * j][2], y[2 * j][3]),
                              pack_bf16(y[2 * j + 1][0], y[2 * j + 1][1]),
                              pack_bf16(y[2 * j + 1][2], y[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NH; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, b_frag_addr(Ks, DP, j * 16, c0 + n * 8));
        mma_bf16(acc[n], da, kb[0], kb[1]);
        mma_bf16(acc[n + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();            // this stage and the exchange slots are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tq[r] < T_) {
      __nv_bfloat16* row = dq + ((long)(b * T_ + tq[r]) * H + h) * D + c0;
#pragma unroll
      for (int n = 0; n < NH; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// dk = scale * sum_g dk_part[g], dv = sum_g dv_part[g], summed in f32 in
// the fixed order g = 0, 1, ..., then rounded to bf16 once; four values a
// thread per step.
__global__ void __launch_bounds__(REDUCE_THREADS)
bwd_reduce_kernel(const float4* __restrict__ dk_part,
                  const float4* __restrict__ dv_part, uint2* __restrict__ dk,
                  uint2* __restrict__ dv, long n4, int groups, float scale) {
  for (long i = (long)blockIdx.x * REDUCE_THREADS + threadIdx.x; i < n4;
       i += (long)gridDim.x * REDUCE_THREADS) {
    float4 a = dk_part[i], c = dv_part[i];
    for (int gi = 1; gi < groups; ++gi) {
      const float4 x = dk_part[gi * n4 + i], y = dv_part[gi * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dk[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale),
                       pack_bf16(a.z * scale, a.w * scale));
    dv[i] = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

// The dK/dV and dQ kernels of head dim D; only these are instantiated.
template <int D>
auto dkdv_kernel() {
  if constexpr (D > 128) return &bwd_dkdv_pair_kernel<D>;
  else return &bwd_dkdv_mma_kernel<D>;
}
template <int D>
auto dq_kernel() {
  if constexpr (D > 128) return &bwd_dq_pair_kernel<D>;
  else return &bwd_dq_mma_kernel<D>;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* o_lo, const void* dout,
                   const float* lse, float* delta, float* partial, void* dq, void* dk, void* dv,
                   int B, int T_, int S, int H, int K, int groups, int causal,
                   int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  cudaError_t err = launch_delta<bf16>(o, o_lo, dout, delta, B, T_, H, D, stream);
  if (err != cudaSuccess) return err;

  const long n = (long)B * S * K * D;           // elements of dk (and dv)
  float* dk_part = partial;
  float* dv_part = partial + (long)groups * n;
  // Head dim 256 runs the warp-pair kernels, with the same grids.
  constexpr bool pairs = D > 128;
  constexpr int threads = pairs ? PAIR_THREADS : THREADS;
  constexpr size_t kv_smem = pairs ? dkdv_pair_smem<D>() : dkdv_smem<D>();
  constexpr size_t q_smem = pairs ? dq_pair_smem<D>() : dq_smem<D>();
  auto kv_kern = dkdv_kernel<D>();
  auto q_kern = dq_kernel<D>();
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const long kv_blocks = (long)((S + BKV - 1) / BKV) * B * K * groups;
  kv_kern<<<(unsigned)kv_blocks, threads, kv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, dk_part, dv_part, B, T_, S, H, K, groups,
      causal, window, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((T_ + BQ_DQ - 1) / BQ_DQ, B * H), threads, q_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dq), T_, S, H, K, causal,
      window, scale * LOG2E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long n4 = n / 4;                        // D is a multiple of 16
  const long want = (n4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const long blocks = want < 132L * 16 ? want : 132L * 16;
  bwd_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part),
      reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),
      static_cast<uint2*>(dv), n4, groups, scale);
  return cudaGetLastError();
}

}  // namespace tc

// Which kernels a backward call takes: 1 = the bf16 tensor-core kernels, 0 =
// the f32-FMA kernels.  dtype as below; `aligned` is nonzero when q, k, v,
// dout, dq, dk and dv all start on 16 bytes.  repro_flash_attention_bwd
// dispatches by this function.
extern "C" int repro_flash_attention_bwd_path(int dtype, int D, int aligned) {
  return dtype == 1 && aligned &&
         (D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// The number of groups G the H/K query heads of a KV head are split into
// on the tensor-core path: enough (key tile, b, kv head, group) blocks for
// TARGET_BLOCKS, at most one group per query head.  The caller allocates
// the f32 partials, 2 * G * B * S * K * D values, and passes G back.
extern "C" int repro_flash_attention_bwd_groups(int B, int S, int H, int K) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return 1;
  const long base = (long)((S + tc::BKV - 1) / tc::BKV) * B * K;
  const long want = (tc::TARGET_BLOCKS + base - 1) / base;
  const long g = want < H / K ? want : H / K;
  return (int)(g > 1 ? g : 1);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// All tensors are contiguous: q, o, dout, dq (B,T,H,D); k, v, dk, dv
// (B,S,K,D); lse (B,H,T) f32 from the forward; o_lo (B,T,H,D), the
// forward's rounding residual of o, or null; delta (B,H,T) f32 scratch
// that this call fills.  On the tensor-core path `partial` is f32 scratch
// of 2 * groups * B * S * K * D values, with 1 <= groups <= H/K (see
// repro_flash_attention_bwd_groups); the FMA path reads neither.  Returns
// the first failing launch's cudaError_t (0 on success); the kernels run
// asynchronously on `stream`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* o_lo, const void* dout, const void* lse, void* delta,
    void* partial, void* dq,
    void* dk, void* dv, int dtype, int B, int T, int S, int H, int K, int D,
    int groups, int causal, int window, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || K <= 0 || H % K != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
        reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  if (repro_flash_attention_bwd_path(dtype, D, aligned)) {
    if (groups < 1 || groups > H / K || partial == nullptr)
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(partial);
    switch (D) {
      case 16: return (int)tc::launch<16>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 32: return (int)tc::launch<32>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 64: return (int)tc::launch<64>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 128: return (int)tc::launch<128>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 256: return (int)tc::launch<256>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
    }
  }
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, o_lo, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, o_lo, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
