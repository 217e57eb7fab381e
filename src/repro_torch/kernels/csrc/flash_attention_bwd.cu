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
// Three paths, chosen by repro_flash_attention_bwd_path (exported, so
// callers can ask which one a call takes).  Both tensor-core paths launch
// the delta kernel (one warp per (b, t, h) row), then dK/dV and dQ (one
// kernel of both kinds of block on the wgmma path, two kernels on
// mma.sync), then a reduce kernel (on the wgmma path only when the GQA
// group is split, below).
//
// * 2, bf16 with D in {64, 128, 256} and 16-byte aligned pointers (the
//   training path of every arch): Hopper's wgmma, fed by TMA copies into
//   mbarrier rings (namespace wgb; helpers in wgmma_tma.cuh).  The forward's
//   warp-specialised block: a producer warpgroup at 24 registers
//   (setmaxnreg) whose first thread issues every copy, and two consumer
//   warpgroups at 240.  Tensor maps see q, k, v and dO as 4-d (D, heads,
//   rows, B), so TMA zero-fills rows past T or S.
//   - dK/dV blocks: one per (key tile, b, kv head, group of query heads).
//     At D in {64, 128} a block has 128 keys, each consumer warpgroup owns
//     64 and keeps their dK and dV in f32 registers for the whole block (128
//     a thread at D=128).  Q and dO stream through the ring in stages of 128
//     queries at D=64, 64 at D=128 (the registers' limit), with the stage's
//     -lse log2e and Delta, which 64 producer threads write.  Per stage S^T =
//     K Q^T and dP^T = V dO^T (wgmma, both operands from shared memory,
//     K-major), P^T and dS^T formed on the accumulators and packed in place
//     to bf16 as the register A of dV += P^T dO and dK += dS^T Q, dO and Q
//     read MN-major from the same swizzled tiles.
//   - At D=256 (recurrentgemma's local layers, paligemma) one warpgroup's dK
//     and dV of 64 keys would be 256 registers a thread.  So a block has 64
//     keys, which both consumers share, each owning 128 of the output
//     columns (128 registers a thread again), over stages of 64 queries.
//     Each score product runs once over all of D: consumer 0 computes S^T
//     and P^T, consumer 1 dP^T; they swap the 64 x 64 f32 tiles through
//     shared memory behind a barrier of their 256 threads, both form dS^T
//     from the same bits, and each runs dV and dK on its columns.
//   - dQ blocks: one per 128 query rows of one (b, h), Q and dO loaded
//     once, K and V streaming through the ring in stages of 128 keys (64 at
//     D=256, where the ring is three slots that V and K tiles take in turn,
//     each released as soon as its products are done): S = Q K^T, dP = dO
//     V^T, dS, dQ += dS K with K read MN-major; the forward's kernel with a
//     second score product.
//   - Both kinds of block run in one launch, dK/dV blocks first and each
//     kind heaviest first, so the dQ blocks fill the last wave of the
//     dK/dV blocks.
//   - The softmax recompute is the forward's: -lse log2e is one constant
//     per query (-inf past T or for a row that sees no key), so a score
//     takes one FFMA and one ex2.approx.ftz and P = 0 needs no select;
//     masks apply only in tiles the causal diagonal, the window or S cuts.
//     A block or warpgroup skips a stage it sees none of.
// * 1, bf16 with D in {16, 32} and aligned pointers (no arch's path):
//   mma.sync m16n8k16 with bf16 inputs and f32 accumulation, ldmatrix /
//   ldmatrix.trans and cp.async double buffers (namespace tc; helpers in
//   mma_bf16.cuh).
//   - dK/dV kernel, one block of 128 threads per (64-key tile, b, kv head,
//     group of query heads).  FA2's scheme with keys as the rows: each
//     warp owns 16 keys and computes S^T and dP^T, forms P^T and dS^T in
//     f32 registers and repacks them as bf16 A fragments for dV and dK,
//     with no shared memory round trip.  Q / dO tiles of 64 queries (and
//     their lse / Delta) are double-buffered with cp.async.
//   - dQ kernel, one block per (64-query tile, b, h), heaviest tiles first,
//     K / V tiles double-buffered with cp.async.
// * 0, everything else (f32, other head dims up to 256, unaligned
//   pointers): f32 FMAs on the CUDA cores, three launches (delta, dK/dV,
//   dQ).  Each of the 32 rows of a tile is owned by 8 lanes of one warp
//   that split its 32 scores and its D output columns, so a row's P and dS
//   go through shared memory only within the warp; one block per (32-key
//   tile, b, kv head) sums the whole GQA group.  Staged rows are padded to
//   D+1 floats so the dot products read shared memory without bank
//   conflicts.
//
// On both tensor-core paths the H/K query heads of a KV head (GQA sums over
// them) are split into G groups, G from the shape
// (repro_flash_attention_bwd_groups: enough dK/dV blocks for 256 of the
// wgmma kernel's, or 512 of mma.sync's, at most H/K): G=4 at the
// starcoder2-3b training shape, G=3 at recurrentgemma-9b's local one, G=6
// at paligemma-3b's.  Each
// block writes its f32 partial dK / dV to scratch that the caller allocates
// (2 G B S K D floats), and the reduce kernel sums the G partials in a
// fixed order and rounds once; with G = 1 a wgmma block writes dK and dV in
// bf16 itself.  The key tile is the slowest block index, so the heaviest
// causal tiles (the first keys) are issued first.  The dQ kernel recomputes
// S = Q K^T and dP = dO V^T (7 products in all instead of 5) rather than
// reading dS back: writing dS would be B H T S bf16, about 100 MB each way
// at the starcoder2 training shape, more than the whole bound, and
// accumulating dQ from the dK/dV blocks would need atomics and give up
// determinism.
//
// Bound on an H100 SXM: the five products of 2*D flops per visible (query,
// key) pair, at 989 TFLOP/s on the tensor cores, against the bytes (q, k,
// v, o, dO, lse read once; dq, dk, dv written once) at 3.35 TB/s.  At the
// starcoder2-3b training shape (B=4, T=S=1024, H=24, K=2, D=128, causal)
// that is 64.5 GFLOP, 65 us (0.0652 ms), against 109 MB, 33 us; at
// whisper-small's encoder (B=4, T=S=1500, H=K=12, D=64, non-causal) 69.1
// GFLOP, 0.0699 ms; at recurrentgemma-9b's local training shape (B=2,
// T=S=3000, H=16, K=1, D=256, window 2048) 331.6 GFLOP, 0.3353 ms, against
// 209 MB, 62 us.  So all are bound by operations; the kernels execute 7
// products, not 5.  The FMA path is bound by the CUDA cores' 67 TFLOP/s f32
// rate at best.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

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

// Instantiated at head dims 16 and 32 only.
constexpr int THREADS = 128;      // 4 warps x 16 rows
constexpr int BKV = 64;           // keys per dK/dV block and per dQ KV tile
constexpr int BQ_KV = 64;         // queries per Q / dO tile of the dK/dV pass
constexpr int BQ_DQ = 64;         // queries per dQ block
constexpr int TARGET_BLOCKS = 512;  // dK/dV blocks the group split aims at
constexpr int REDUCE_THREADS = 256;

template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * BKV + 4 * BQ_KV) * (D + PAD) +
         sizeof(float) * 4 * BQ_KV;
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
  constexpr int BQ = BQ_KV;
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
  constexpr size_t kv_smem = dkdv_smem<D>();
  constexpr size_t q_smem = dq_smem<D>();
  auto kv_kern = &bwd_dkdv_mma_kernel<D>;
  auto q_kern = &bwd_dq_mma_kernel<D>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  const long kv_blocks = (long)((S + BKV - 1) / BKV) * B * K * groups;
  kv_kern<<<(unsigned)kv_blocks, THREADS, kv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, dk_part, dv_part, B, T_, S, H, K, groups,
      causal, window, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((T_ + BQ_DQ - 1) / BQ_DQ, B * H), THREADS, q_smem, stream>>>(
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

// ---------------------------------------------------------------------------
// bf16 wgmma path, head dims 64, 128 and 256 (helpers in wgmma_tma.cuh)
// ---------------------------------------------------------------------------
// The forward's warp-specialised block (flash_attention.cu, namespace wg):
// one producer warpgroup at 24 registers whose first thread issues every
// TMA copy into an mbarrier ring, and two consumer warpgroups at 240 that
// run the products as wgmma.  Every operand tile is what a 4-d tensor map
// (D, heads, rows, B) writes with a 128-byte swizzle: rows past T or S
// arrive as zeros.  Boxes are 64 rows, so one map per tensor serves both
// kernels, whatever their tiles.
namespace wgb {

using namespace hopper;
using tc::LOG2E;
using tc::pack_bf16;

// Tiles per head dim.  dK/dV: BN keys a block (64 per consumer warpgroup;
// at D=256 both consumers share 64 keys and split the output columns), BQ
// queries a stage of the Q / dO ring, STAGES stages.  dQ: DQ_BM query rows
// a block (64 per consumer warpgroup), DQ_BN keys a stage of the K / V
// ring, DQ_STAGES stages (at D=256 slots, each holding one K or one V
// tile); chosen on the card (PERF.md).  Mirrored by WGMMA_BWD_TILES in
// kernels/flash_attention.py.
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 128, BN = 128, STAGES = 2, DQ_BM = 128, DQ_BN = 128, DQ_STAGES = 2; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BN = 128, STAGES = 2, DQ_BM = 128, DQ_BN = 128, DQ_STAGES = 2; };
template <> struct Tiles<256> { static constexpr int BQ = 64, BN = 64, STAGES = 2, DQ_BM = 128, DQ_BN = 64, DQ_STAGES = 3; };

constexpr int CONSUMERS = 2;                  // warpgroups of 64 rows (keys or queries)
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int ROWS = 64;                      // rows per TMA box
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int TARGET_BLOCKS = 256;            // dK/dV blocks the group split aims at
constexpr int LSE_THREADS = 64;               // producer threads that stage -lse log2e, Delta

// A barrier of the 256 consumer threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS * 128) : "memory");
}

// Copies rows r0 .. r0 + N - 1 of one (b, head) of `map`, all D columns,
// into a tile of N rows stored as D/64 column tiles of N x 128 bytes.
template <int N, int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int r0, int b) {
#pragma unroll
  for (int c = 0; c < D / BOX; ++c)
#pragma unroll
    for (int r = 0; r < N / ROWS; ++r)
      tma_load_4d(dst + c * N * 128 + r * ROWS * 128, map, bar, c * BOX, head,
                  r0 + r * ROWS, b);
}

// acc (64 x N, f32) = A B over D: A = 64 rows of a K-major tile at `a` (a
// tile of MA rows), B = the N rows of a K-major tile at `b`.  Committed as
// one group.
template <int N, int D, int MA>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = desc_sw128(a + c * MA * 128 + off, 16, 1024);
    const uint64_t db = desc_sw128(b + c * N * 128 + off, 16, 1024);
    if constexpr (N == 64) wgmma_m64n64k16_ss(acc, da, db, kk > 0);
    else wgmma_m64n128k16_ss(acc, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D, f32) += A B: A (64 x KN) in registers, k-step kk in a[kk]; B
// the KN x D tile at `b` read MN-major (its D columns contiguous).
// Committed as one group.
template <int KN, int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], const uint32_t (&a)[KN / 16][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 128, KN * 128, 1024);
    if constexpr (D == 64) wgmma_m64n64k16_rs_tn(acc, a[kk], db, 1);
    else wgmma_m64n128k16_rs_tn(acc, a[kk], db, 1);
  }
  wgmma_commit();
}

// Accumulator blocks 2k and 2k+1 packed to bf16: the A fragment of k-step k.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// dK/dV: K and V (BN x D each), then STAGES x {Q, dO (BQ x D each)}, then
// STAGES x {BQ values of -lse log2e, BQ of Delta}, then at D=256 the two
// consumers' exchange slots (64 x BQ f32 each), then the barriers.
template <int D>
struct KvLayout {
  static constexpr int BQ = Tiles<D>::BQ, BN = Tiles<D>::BN, STAGES = Tiles<D>::STAGES;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int O_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int L_OFF = O_OFF + STAGES * Q_BYTES;
  static constexpr int X_OFF = L_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BAR_OFF = X_OFF + (D == 256 ? CONSUMERS * 64 * BQ * 4 : 0);
  static constexpr int N_BARS = 1 + 2 * STAGES;   // kv_full, full[], empty[]
  static constexpr size_t SMEM = BAR_OFF + N_BARS * 8 + 1024;   // + alignment slack
};

// The consumers of a dK/dV block at D=256.  One warpgroup's dK and dV of
// 64 keys would be 256 f32 registers a thread, over the 240 setmaxnreg
// gives a consumer.  So both warpgroups hold the block's 64 keys and split
// the output columns: warpgroup w owns columns 128w .. 128w + 127 of their
// dK and dV, 64 + 64 f32 registers a thread.  Each score product runs over
// all of D once: warpgroup 0 computes S^T = K Q^T and P^T, warpgroup 1
// dP^T = V dO^T.  Each writes its 64 x BQ f32 tile to its exchange slot in
// accumulator order (thread i of both warpgroups holds the same positions),
// a barrier of the 256 consumer threads orders the exchange, and each reads
// the other's, so both form dS^T = P^T (dP^T - Delta) from the same bits.
// Then dV[:, cols] += P^T dO[:, cols] and dK[:, cols] += dS^T Q[:, cols],
// B the stage's column tiles 2w and 2w + 1.  Whether a stage is skipped
// depends on the keys alone, so both warpgroups take every exchange.
template <int D>
__device__ __forceinline__ void
dkdv_split_consumer(unsigned char* smem, uint64_t* kv_full, uint64_t* full,
                    uint64_t* empty, float* __restrict__ dk_part,
                    float* __restrict__ dv_part, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int B, int S, int K, int b, int kh,
                    int grp, int groups, int k0, int offs, int t_begin, int n_qt,
                    int n_iter, int causal, int window, float scale_log2, float scale) {
  using L = KvLayout<D>;
  constexpr int BQ = L::BQ, BN = L::BN, STAGES = L::STAGES;
  constexpr int HALF = D / CONSUMERS;              // output columns a warpgroup owns
  static_assert(BN == 64 && HALF == 128, "two warpgroups over 64 keys, 128 columns each");
  reg_alloc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr = k0 + 16 * warp + g;               // this thread's keys: kr, kr + 8
  const unsigned char* rows = smem + wg * L::V_OFF;   // K (warpgroup 0) or V
  float4* mine = reinterpret_cast<float4*>(smem + L::X_OFF) + wg * (BQ / 8) * 128 + wt;
  const float4* theirs =
      reinterpret_cast<const float4*>(smem + L::X_OFF) + (wg ^ 1) * (BQ / 8) * 128 + wt;

  float dk_acc[HALF / 2], dv_acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  int s = 0, ph = 0, qp0 = offs + t_begin;         // qp0: the stage's first query position
  bool first = true;
  for (int j = 0; j < n_iter; ++j) {
    const unsigned char* Qs = smem + L::Q_OFF + s * L::Q_BYTES;
    const unsigned char* Os = smem + L::O_OFF + s * L::Q_BYTES;
    const float* nl = reinterpret_cast<const float*>(smem + L::L_OFF) + s * 2 * BQ;
    mbar_wait(&full[s], ph);
    const bool none = k0 >= S || (causal && qp0 + BQ - 1 < k0) ||
                      (window > 0 && qp0 - window >= k0 + BN - 1);
    if (!none) {
      float x[BQ / 2];
      fence_regs(x);
      wgmma_fence();
      product_ss<BQ, D, BN>(x, rows, wg ? Os : Qs);
      wgmma_wait<0>();
      fence_regs(x);
      if (wg == 0) {
        // P^T in one FFMA and one EX2 a score, masked only where the
        // diagonal or the window cuts this warp's 16 keys.
        const int kwarp = k0 + 16 * warp;
        const bool all = (!causal || kwarp + 15 <= qp0) &&
                         (window <= 0 || kwarp > qp0 + BQ - 1 - window);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n * 8 + 2 * t + (i & 1);
            float p = exp2_ftz(fmaf(x[4 * n + i], scale_log2, nl[col]));
            if (!all) {
              const int kpos = kr + 8 * (i >> 1), qpos = qp0 + col;
              if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) p = 0.f;
            }
            x[4 * n + i] = p;
          }
        }
      }
      // The partner has read the last exchange; write ours, then read theirs.
      if (!first) consumers_sync(1);
      first = false;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
        mine[n * 128] = make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);
      consumers_sync(2);
      float y[BQ / 2];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float4 o = theirs[n * 128];
        y[4 * n] = o.x, y[4 * n + 1] = o.y, y[4 * n + 2] = o.z, y[4 * n + 3] = o.w;
      }
      // P^T into x, dS^T into y, in both warpgroups.
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = wg ? y[4 * n + i] : x[4 * n + i];
          const float dp = wg ? x[4 * n + i] : y[4 * n + i];
          x[4 * n + i] = p;
          y[4 * n + i] = p * (dp - nl[BQ + n * 8 + 2 * t + (i & 1)]);
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_a<BQ>(pa, x);
      pack_a<BQ>(da, y);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      product_rs<BQ, HALF>(dv_acc, pa, Os + 2 * wg * BQ * 128);
      product_rs<BQ, HALF>(dk_acc, da, Qs + 2 * wg * BQ * 128);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(&empty[s]);             // this stage's products are done
    if ((qp0 += BQ) >= offs + t_begin + n_qt * BQ) qp0 = offs + t_begin;
    if (++s == STAGES) s = 0, ph ^= 1;
  }

  // Every key of the tile below S gets its sums, zero if no query saw it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kr + 8 * r;
    if (kpos >= S) continue;
    const long row = ((long)(b * S + kpos) * K + kh) * D + HALF * wg;
    if (groups == 1) {
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + row + n * 8 + 2 * t) =
            pack_bf16(dk_acc[4 * n + 2 * r] * scale, dk_acc[4 * n + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + n * 8 + 2 * t) =
            pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
      }
    } else {
      const long base = (long)grp * B * S * K * D + row;
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n) {
        *reinterpret_cast<float2*>(dk_part + base + n * 8 + 2 * t) =
            make_float2(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + base + n * 8 + 2 * t) =
            make_float2(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

// dK/dV of one (BN-key tile, b, kv head, group of query heads).  Consumer
// warpgroup w owns keys k0 + 64w .. + 63 and keeps their dK and dV in f32
// registers for the whole block.  Per stage of BQ queries of one head:
// S^T = K Q^T and dP^T = V dO^T (keys as rows), P^T = 2^(S^T scale log2e -
// lse log2e) and dS^T = P^T (dP^T - Delta) on the accumulators, packed in
// place as the A operand of dV += P^T dO and dK += dS^T Q.  64 producer
// threads write each stage's -lse log2e (-inf for a query past T or one that
// sees no key, so P = 0 there with no select) and Delta.  With one
// group the block writes dk (scaled) and dv in bf16; else the unscaled f32
// sums go to dk_part / dv_part (groups, B, S, K, D).
template <int D>
__device__ __forceinline__ void
dkdv_block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
           const CUtensorMap* tdo, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk_part,
           float* __restrict__ dv_part, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int B, int T_, int S, int H, int K,
           int groups, int causal, int window, float scale_log2, float scale,
           int block, unsigned char* smem) {
  using L = KvLayout<D>;
  constexpr int BQ = L::BQ, BN = L::BN, STAGES = L::STAGES;
  static_assert(BQ % LSE_THREADS == 0 && LSE_THREADS <= 96, "lse / Delta threads");
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  // The key tile is the slowest index, so the blocks issued first hold the
  // first key tiles: the heaviest under a causal mask.
  const int per_tile = B * K * groups;
  const int kt = block / per_tile;
  int rest = block % per_tile;
  const int grp = rest % groups;
  rest /= groups;
  const int kh = rest % K, b = rest / K;
  const int rep = H / K;
  const int h_begin = kh * rep + grp * rep / groups;
  const int h_end = kh * rep + (grp + 1) * rep / groups;
  const int k0 = kt * BN;
  const int offs = S - T_;             // query t sits at key position offs+t

  // Queries that can see some key of this tile, from a BQ-aligned start.
  const int k_last = min(k0 + BN, S) - 1;
  int t_begin = causal ? max(0, k0 - offs) : 0;
  const int t_end = window > 0 ? min(T_, k_last - offs + window) : T_;
  t_begin = (t_begin / BQ) * BQ;
  const int n_qt = t_end > t_begin ? (t_end - t_begin + BQ - 1) / BQ : 0;
  const int n_iter = n_qt * (h_end - h_begin);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + LSE_THREADS);   // the TMA thread and the lse / Delta threads
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // The producer's loops walk (head, query tile) and the ring with
    // counters: no division in the 24 registers it keeps.
    reg_dealloc<PRODUCER_REGS>();
    const int pt = threadIdx.x - CONSUMERS * 128;
    if (pt == 0) {
      // One thread keeps the ring full with TMA copies.
      tma_prefetch_map(tq);
      tma_prefetch_map(tk);
      tma_prefetch_map(tv);
      tma_prefetch_map(tdo);
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      load_tile<BN, D>(smem, tk, kv_full, kh, k0, b);
      load_tile<BN, D>(smem + L::V_OFF, tv, kv_full, kh, k0, b);
      int s = 0, ph = 0, h = h_begin, q0 = t_begin;
      for (int j = 0; j < n_iter; ++j) {
        // Stage s is free once both consumers released stage j - STAGES.
        if (j >= STAGES) mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::Q_BYTES);
        load_tile<BQ, D>(smem + L::Q_OFF + s * L::Q_BYTES, tq, &full[s], h, q0, b);
        load_tile<BQ, D>(smem + L::O_OFF + s * L::Q_BYTES, tdo, &full[s], h, q0, b);
        if ((q0 += BQ) >= t_begin + n_qt * BQ) q0 = t_begin, ++h;
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    } else if (pt >= 32 && pt < 32 + LSE_THREADS) {
      // The next 64 threads write each stage's -lse log2e and Delta, BQ/64
      // queries each; off walks (b, h) rows of lse and delta (B H T < 2^31).
      const int i = pt - 32;
      const int q_end = t_begin + n_qt * BQ;
      int s = 0, ph = 0, q0 = t_begin, off = (b * H + h_begin) * T_;
      for (int j = 0; j < n_iter; ++j) {
        if (j >= STAGES) mbar_wait(&empty[s], ph ^ 1);
        float* nl = reinterpret_cast<float*>(smem + L::L_OFF) + s * 2 * BQ;
#pragma unroll
        for (int r = 0; r < BQ / LSE_THREADS; ++r) {
          const int x = i + r * LSE_THREADS;
          const bool in = q0 + x < T_;
          const float l = in ? lse[off + q0 + x] : -INFINITY;
          nl[x] = l == -INFINITY ? -INFINITY : -l * LOG2E;
          nl[BQ + x] = in ? delta[off + q0 + x] : 0.f;
        }
        mbar_arrive(&full[s]);
        if ((q0 += BQ) >= q_end) q0 = t_begin, off += T_;
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
  } else if constexpr (D == 256) {
    dkdv_split_consumer<D>(smem, kv_full, full, empty, dk_part, dv_part, dk, dv, B, S, K,
                           b, kh, grp, groups, k0, offs, t_begin, n_qt, n_iter, causal,
                           window, scale_log2, scale);
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + 64 * wg;                     // this warpgroup's first key
    const int kr = kw + 16 * warp + g;               // this thread's keys: kr, kr + 8
    const unsigned char* Ks = smem + 64 * wg * 128;  // its 64 rows of K and of V
    const unsigned char* Vs = smem + L::V_OFF + 64 * wg * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    int s = 0, ph = 0, qp0 = offs + t_begin;         // qp0: the stage's first query position
    for (int j = 0; j < n_iter; ++j) {
      const unsigned char* Qs = smem + L::Q_OFF + s * L::Q_BYTES;
      const unsigned char* Os = smem + L::O_OFF + s * L::Q_BYTES;
      const float* nl = reinterpret_cast<const float*>(smem + L::L_OFF) + s * 2 * BQ;
      mbar_wait(&full[s], ph);
      // A stage none of this warpgroup's keys is visible to, or keys all
      // past S: nothing to add.
      const bool none = kw >= S || (causal && qp0 + BQ - 1 < kw) ||
                        (window > 0 && qp0 - window >= kw + 63);
      if (!none) {
        float st[BQ / 2], dpt[BQ / 2];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        product_ss<BQ, D, BN>(st, Ks, Qs);
        product_ss<BQ, D, BN>(dpt, Vs, Os);
        wgmma_wait<1>();
        fence_regs(st);
        // P^T in one FFMA and one EX2 a score.  The warp's 16 keys see every
        // query of the stage unless the diagonal or the window cuts it.
        const int kwarp = kw + 16 * warp;
        const bool all = (!causal || kwarp + 15 <= qp0) &&
                         (window <= 0 || kwarp > qp0 + BQ - 1 - window);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n * 8 + 2 * t + (i & 1);
            float p = exp2_ftz(fmaf(st[4 * n + i], scale_log2, nl[col]));
            if (!all) {
              const int kpos = kr + 8 * (i >> 1), qpos = qp0 + col;
              if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) p = 0.f;
            }
            st[4 * n + i] = p;
          }
        }
        uint32_t pa[BQ / 16][4];
        pack_a<BQ>(pa, st);
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dpt[4 * n + i] = st[4 * n + i] * (dpt[4 * n + i] - nl[BQ + n * 8 + 2 * t + (i & 1)]);
        uint32_t da[BQ / 16][4];
        pack_a<BQ>(da, dpt);
        // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
        product_rs<BQ, D>(dv_acc, pa, Os);
        product_rs<BQ, D>(dk_acc, da, Qs);
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
      }
      mbar_arrive(&empty[s]);           // this stage's products are done
      if ((qp0 += BQ) >= offs + t_begin + n_qt * BQ) qp0 = offs + t_begin;
      if (++s == STAGES) s = 0, ph ^= 1;
    }

    // Every key of the tile below S gets its sums, zero if no query saw it.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = kr + 8 * r;
      if (kpos >= S) continue;
      if (groups == 1) {
        const long row = ((long)(b * S + kpos) * K + kh) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dk + row + n * 8 + 2 * t) =
              pack_bf16(dk_acc[4 * n + 2 * r] * scale, dk_acc[4 * n + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + row + n * 8 + 2 * t) =
              pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
        }
      } else {
        const long base = ((((long)grp * B + b) * S + kpos) * K + kh) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<float2*>(dk_part + base + n * 8 + 2 * t) =
              make_float2(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_part + base + n * 8 + 2 * t) =
              make_float2(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
        }
      }
    }
  }
}

// dQ: Q and dO (DQ_BM x D each), then DQ_STAGES K tiles and DQ_STAGES V
// tiles (DQ_BN x D each), then the barriers.  At D=256 the ring is
// DQ_STAGES slots of one tile each (K_OFF on), and its barriers are
// q_full, full[], empty[].
template <int D>
struct QLayout {
  static constexpr int BM = Tiles<D>::DQ_BM, BN = Tiles<D>::DQ_BN, STAGES = Tiles<D>::DQ_STAGES;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr int O_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = K_OFF + (D == 256 ? 1 : 2) * STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + (D == 256 ? 2 : 3) * STAGES;   // q_full, k_full[], v_full[], empty[]
  static constexpr size_t SMEM = BAR_OFF + N_BARS * 8 + 1024;
};

// dQ of DQ_BM query rows of one (b, h): the forward's kernel with a second
// score product.  Consumer warpgroup w owns rows q0 + 64w .. + 63; per K / V
// tile of the ring it computes S = Q K^T and dP = dO V^T, P = 2^(S scale
// log2e - lse log2e) and dS = P (dP - Delta) on the accumulators, packed in
// place as the A operand of dQ += dS K, K read MN-major.
template <int D>
__device__ __forceinline__ void
dq_block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
         const CUtensorMap* tdo, const float* __restrict__ lse,
         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B,
         int T_, int S, int H, int K, int causal, int window, float scale_log2,
         float scale, int lin, unsigned char* smem) {
  using L = QLayout<D>;
  constexpr int BM = L::BM, BN = L::BN, STAGES = L::STAGES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  // Blocks start in order of their index: the heaviest query tiles (the
  // last rows, under a causal mask) of every (b, h) go first.
  const int BH = B * H;
  const int bh = lin % BH;
  const int q0 = ((T_ + BM - 1) / BM - 1 - lin / BH) * BM;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int offs = S - T_;

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
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      tma_prefetch_map(tq);
      tma_prefetch_map(tk);
      tma_prefetch_map(tv);
      tma_prefetch_map(tdo);
      mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      load_tile<BM, D>(smem, tq, q_full, h, q0, b);
      load_tile<BM, D>(smem + L::O_OFF, tdo, q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const int k0 = kv_begin + j * BN;
        mbar_arrive_expect_tx(&k_full[s], L::KV_BYTES);
        load_tile<BN, D>(smem + L::K_OFF + s * L::KV_BYTES, tk, &k_full[s], kh, k0, b);
        mbar_arrive_expect_tx(&v_full[s], L::KV_BYTES);
        load_tile<BN, D>(smem + L::V_OFF + s * L::KV_BYTES, tv, &v_full[s], kh, k0, b);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wq = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wq + 16 * warp + g;          // and r0 + 8
    const unsigned char* Qs = smem + 64 * wq * 128;  // this warpgroup's rows of Q, dO
    const unsigned char* Os = smem + L::O_OFF + 64 * wq * 128;
    // Per row: -lse log2e (-inf past T or where the row sees no key, so
    // that P = 0 with no select), Delta and the key position.
    float nl[2], dl[2];
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq_ = q0 + r0 + 8 * r;
      const float l = tq_ < T_ ? lse[(long)bh * T_ + tq_] : -INFINITY;
      nl[r] = l == -INFINITY ? -INFINITY : -l * LOG2E;
      dl[r] = tq_ < T_ ? delta[(long)bh * T_ + tq_] : 0.f;
      qpos[r] = offs + tq_;
    }
    // This warpgroup's rows, and the keys every row of this warp sees.
    const int gpos_lo = offs + q0 + 64 * wq, gpos_hi = gpos_lo + 63;
    const int wpos_lo = gpos_lo + 16 * warp, wpos_hi = wpos_lo + 15;
    const int full_lo = window > 0 ? wpos_hi - window + 1 : 0;
    const int full_hi = causal ? min(S, wpos_lo + 1) : S;

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
      mbar_wait(&k_full[s], ph);
      mbar_wait(&v_full[s], ph);
      // A tile none of this warpgroup's rows sees, or rows all past T.
      const bool none = q0 + 64 * wq >= T_ || (causal && k0 > gpos_hi) ||
                        (window > 0 && k0 + BN - 1 <= gpos_lo - window);
      if (!none) {
        float sc[BN / 2], dp[BN / 2];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        product_ss<BN, D, BM>(sc, Qs, Ks);
        product_ss<BN, D, BM>(dp, Os, Vs);
        wgmma_wait<1>();
        fence_regs(sc);
        // P in one FFMA and one EX2 a score; masks only where the diagonal,
        // the window or S cuts the tile for this warp.
        const bool all = k0 >= full_lo && k0 + BN <= full_hi;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1;
            float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, nl[r]));
            if (!all) {
              const int kpos = k0 + n * 8 + 2 * t + (i & 1);
              if (kpos >= S || (causal && kpos > qpos[r]) ||
                  (window > 0 && kpos <= qpos[r] - window))
                p = 0.f;
            }
            sc[4 * n + i] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
        uint32_t da[BN / 16][4];
        pack_a<BN>(da, dp);
        fence_regs(acc);
        fence_regs(da);
        wgmma_fence();
        product_rs<BN, D>(acc, da, Ks);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
      }
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq_ = q0 + r0 + 8 * r;
      if (tq_ < T_) {
        __nv_bfloat16* row = dq + ((long)(b * T_ + tq_) * H + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
              pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
      }
    }
  }
}

// dQ at D=256: dq_block's work with the forward's Tiles<256> budget.  Q and
// dO of 128 rows take 128 KB, so the ring is three slots of one 64-key tile
// (32 KB) each, which V_j and K_j take in turn: V_j is released as soon as
// dP = dO V^T is done and K_j once dQ += dS K is, so the next tile's V and
// K load while this one's products run.  Each consumer warpgroup holds its
// 64 x 256 dQ in f32 (two halves of 64 registers); dQ += dS K runs as two
// m64n128k16 products a k-step, over K's column tiles 0-1 and 2-3.
template <int D>
__device__ __forceinline__ void
dq_split_block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
               const CUtensorMap* tdo, const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B,
               int T_, int S, int H, int K, int causal, int window, float scale_log2,
               float scale, int lin, unsigned char* smem) {
  using L = QLayout<D>;
  constexpr int BM = L::BM, BN = L::BN, SLOTS = L::STAGES;
  constexpr int HALF = D / 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + SLOTS;

  // As dq_block: the heaviest query tiles first, and the keys any row of
  // this block can see, from a BN-aligned start.
  const int BH = B * H;
  const int bh = lin % BH;
  const int q0 = ((T_ + BM - 1) / BM - 1 - lin / BH) * BM;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int offs = S - T_;
  const int q_last = min(q0 + BM, T_) - 1;
  const int pos_lo = offs + q0, pos_hi = offs + q_last;
  int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int kv_end = causal ? min(S, pos_hi + 1) : S;
  kv_begin = (kv_begin / BN) * BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      tma_prefetch_map(tq);
      tma_prefetch_map(tk);
      tma_prefetch_map(tv);
      tma_prefetch_map(tdo);
      mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
      load_tile<BM, D>(smem, tq, q_full, h, q0, b);
      load_tile<BM, D>(smem + L::O_OFF, tdo, q_full, h, q0, b);
      // Tile 2j of the ring is V_j, tile 2j + 1 is K_j.
      int slot = 0, ph = 0;
      for (int i = 0; i < 2 * n_tiles; ++i) {
        if (i >= SLOTS) mbar_wait(&empty[slot], ph ^ 1);
        mbar_arrive_expect_tx(&full[slot], L::KV_BYTES);
        load_tile<BN, D>(smem + L::K_OFF + slot * L::KV_BYTES, (i & 1) ? tk : tv,
                         &full[slot], kh, kv_begin + (i >> 1) * BN, b);
        if (++slot == SLOTS) slot = 0, ph ^= 1;
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wq = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wq + 16 * warp + g;          // and r0 + 8
    const unsigned char* Qs = smem + 64 * wq * 128;  // this warpgroup's rows of Q, dO
    const unsigned char* Os = smem + L::O_OFF + 64 * wq * 128;
    float nl[2], dl[2];
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq_ = q0 + r0 + 8 * r;
      const float l = tq_ < T_ ? lse[(long)bh * T_ + tq_] : -INFINITY;
      nl[r] = l == -INFINITY ? -INFINITY : -l * LOG2E;
      dl[r] = tq_ < T_ ? delta[(long)bh * T_ + tq_] : 0.f;
      qpos[r] = offs + tq_;
    }
    const int gpos_lo = offs + q0 + 64 * wq, gpos_hi = gpos_lo + 63;
    const int wpos_lo = gpos_lo + 16 * warp, wpos_hi = wpos_lo + 15;
    const int full_lo = window > 0 ? wpos_hi - window + 1 : 0;
    const int full_hi = causal ? min(S, wpos_lo + 1) : S;

    float acc[2][HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[0][i] = acc[1][i] = 0.f;

    mbar_wait(q_full, 0);
    int slot = 0, ph = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int sv = slot, pv = ph;
      if (++slot == SLOTS) slot = 0, ph ^= 1;
      const int sk = slot, pk = ph;
      if (++slot == SLOTS) slot = 0, ph ^= 1;
      const int k0 = kv_begin + j * BN;
      const unsigned char* Vs = smem + L::K_OFF + sv * L::KV_BYTES;
      const unsigned char* Ks = smem + L::K_OFF + sk * L::KV_BYTES;
      mbar_wait(&full[sk], pk);
      mbar_wait(&full[sv], pv);
      const bool none = q0 + 64 * wq >= T_ || (causal && k0 > gpos_hi) ||
                        (window > 0 && k0 + BN - 1 <= gpos_lo - window);
      if (none) {
        mbar_arrive(&empty[sv]);
        mbar_arrive(&empty[sk]);
        continue;
      }
      float sc[BN / 2], dp[BN / 2];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      product_ss<BN, D, BM>(sc, Qs, Ks);
      product_ss<BN, D, BM>(dp, Os, Vs);
      wgmma_wait<1>();
      fence_regs(sc);
      const bool all = k0 >= full_lo && k0 + BN <= full_hi;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          float p = exp2_ftz(fmaf(sc[4 * n + i], scale_log2, nl[r]));
          if (!all) {
            const int kpos = k0 + n * 8 + 2 * t + (i & 1);
            if (kpos >= S || (causal && kpos > qpos[r]) ||
                (window > 0 && kpos <= qpos[r] - window))
              p = 0.f;
          }
          sc[4 * n + i] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      mbar_arrive(&empty[sv]);          // V_j is read
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
      uint32_t da[BN / 16][4];
      pack_a<BN>(da, dp);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(da);
      wgmma_fence();
      product_rs<BN, HALF>(acc[0], da, Ks);
      product_rs<BN, HALF>(acc[1], da, Ks + 2 * BN * 128);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(da);
      mbar_arrive(&empty[sk]);          // K_j is read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq_ = q0 + r0 + 8 * r;
      if (tq_ < T_) {
        __nv_bfloat16* row = dq + ((long)(b * T_ + tq_) * H + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
              pack_bf16(acc[n / 16][4 * (n % 16) + 2 * r] * scale,
                        acc[n / 16][4 * (n % 16) + 2 * r + 1] * scale);
      }
    }
  }
}

// One launch for both passes: blocks [0, kv_blocks) are dK/dV blocks, the
// rest dQ blocks, each kind heaviest first.  So the dQ blocks fill the SMs
// the last wave of dK/dV blocks leaves idle, and the last wave is the
// lightest dQ blocks.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk_part, float* __restrict__ dv_part,
                 __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int T_, int S, int H, int K,
                 int groups, int causal, int window, float scale_log2, float scale,
                 int kv_blocks) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int block = blockIdx.x;
  if (block < kv_blocks)
    dkdv_block<D>(&tq, &tk, &tv, &tdo, lse, delta, dk_part, dv_part, dk, dv, B, T_, S,
                  H, K, groups, causal, window, scale_log2, scale, block, smem);
  else if constexpr (D == 256)
    dq_split_block<D>(&tq, &tk, &tv, &tdo, lse, delta, dq, B, T_, S, H, K, causal, window,
                      scale_log2, scale, block - kv_blocks, smem);
  else
    dq_block<D>(&tq, &tk, &tv, &tdo, lse, delta, dq, B, T_, S, H, K, causal, window,
                scale_log2, scale, block - kv_blocks, smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* o_lo, const void* dout,
                   const float* lse, float* delta, float* partial, void* dq, void* dk,
                   void* dv, int B, int T_, int S, int H, int K, int groups, int causal,
                   int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using KL = KvLayout<D>;
  using QL = QLayout<D>;
  cudaError_t err = launch_delta<bf16>(o, o_lo, dout, delta, B, T_, H, D, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B, T_, H, D, ROWS) || !encode(&tk, k, B, S, K, D, ROWS) ||
      !encode(&tv, v, B, S, K, D, ROWS) || !encode(&tdo, dout, B, T_, H, D, ROWS))
    return cudaErrorInvalidValue;

  const long n = (long)B * S * K * D;           // elements of dk (and dv)
  float* dk_part = partial;
  float* dv_part = groups > 1 ? partial + (long)groups * n : nullptr;
  auto kern = bwd_wgmma_kernel<D>;
  constexpr size_t smem = KL::SMEM > QL::SMEM ? KL::SMEM : QL::SMEM;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long kv_blocks = (long)((S + KL::BN - 1) / KL::BN) * B * K * groups;
  const long q_blocks = (long)((T_ + QL::BM - 1) / QL::BM) * B * H;
  kern<<<(unsigned)(kv_blocks + q_blocks), THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, dk_part, dv_part, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, T_, S, H, K, groups, causal,
      window, scale * LOG2E, scale, (int)kv_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;

  const long n4 = n / 4;                        // D is a multiple of 16
  const long want = (n4 + tc::REDUCE_THREADS - 1) / tc::REDUCE_THREADS;
  const long blocks = want < 132L * 16 ? want : 132L * 16;
  tc::bwd_reduce_kernel<<<(unsigned)blocks, tc::REDUCE_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part),
      reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),
      static_cast<uint2*>(dv), n4, groups, scale);
  return cudaGetLastError();
}

}  // namespace wgb

// Which kernels a backward call takes: 2 = the bf16 wgmma kernel (head
// dims 64, 128 and 256), 1 = the bf16 mma.sync kernels (16 and 32), 0 = the
// f32-FMA kernels.  dtype as below; `aligned` is
// nonzero when q, k, v, dout, dq, dk and dv all start on 16 bytes.
// repro_flash_attention_bwd dispatches by this function.
extern "C" int repro_flash_attention_bwd_path(int dtype, int D, int aligned) {
  if (dtype != 1 || !aligned) return 0;
  if (D == 64 || D == 128 || D == 256) return 2;
  return D == 16 || D == 32 ? 1 : 0;
}

// The number of groups G the H/K query heads of a KV head are split into
// on the tensor-core paths: enough (key tile, b, kv head, group) blocks for
// the target of the kernels a bf16 call at head dim D takes (the dK/dV
// block's keys, Tiles<D>::BN, and 256 blocks on the wgmma path; 64-key
// tiles and 512 blocks on mma.sync), at most one group per query head.  The caller allocates the
// f32 partials, 2 * G * B * S * K * D values (none for G = 1 on the wgmma
// path), and passes G back.
extern "C" int repro_flash_attention_bwd_groups(int B, int S, int H, int K, int D) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return 1;
  const bool wgmma = repro_flash_attention_bwd_path(1, D, 1) == 2;
  const int tile = !wgmma     ? tc::BKV
                   : D == 64   ? wgb::Tiles<64>::BN
                   : D == 128  ? wgb::Tiles<128>::BN
                               : wgb::Tiles<256>::BN;
  const int target = wgmma ? wgb::TARGET_BLOCKS : tc::TARGET_BLOCKS;
  const long base = (long)((S + tile - 1) / tile) * B * K;
  const long want = (target + base - 1) / base;
  const long g = want < H / K ? want : H / K;
  return (int)(g > 1 ? g : 1);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// All tensors are contiguous: q, o, dout, dq (B,T,H,D); k, v, dk, dv
// (B,S,K,D); lse (B,H,T) f32 from the forward; o_lo (B,T,H,D), the
// forward's rounding residual of o, or null; delta (B,H,T) f32 scratch
// that this call fills.  On the tensor-core paths `partial` is f32 scratch
// of 2 * groups * B * S * K * D values, with 1 <= groups <= H/K (see
// repro_flash_attention_bwd_groups), or null on the wgmma path with one
// group; the FMA path reads neither.  Returns
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
  const int path = repro_flash_attention_bwd_path(dtype, D, aligned);
  if (path != 0) {
    if (groups < 1 || groups > H / K || (partial == nullptr && (path == 1 || groups > 1)))
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(partial);
    switch (D) {
      case 16: return (int)tc::launch<16>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 32: return (int)tc::launch<32>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 64: return (int)wgb::launch<64>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 128: return (int)wgb::launch<128>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
      case 256: return (int)wgb::launch<256>(q, k, v, o, o_lo, dout, ls, dl, part, dq, dk, dv, B, T, S, H, K, groups, causal, window, scale, st);
    }
  }
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, o_lo, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, o_lo, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
