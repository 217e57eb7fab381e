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
// Three launches, all deterministic and without atomics:
// * delta kernel: one warp per (b, t, h) row.
// * dK/dV kernel: one block per (KV tile of 32 keys, b, kv head).  It loops
//   over the H/K query heads that share the KV head (GQA sums there) and
//   over the query tiles that can see the KV tile; dK and dV stay in
//   registers for the whole loop and are written once.
// * dQ kernel: one block per (query tile of 32 rows, b, h), looping over
//   the KV tiles its rows can see, as the forward does.
// A row that sees no key has lse = -inf and gets P = 0, so it adds nothing
// and its dQ is 0 (never exp(s - -inf)).  Rows past T and keys past S are
// staged as zeros and masked.
//
// Arithmetic is f32 FMAs on the CUDA cores for every dtype and head dim up
// to 256 (bf16 is upcast when staged); each of the 32 rows of a tile is
// owned by 8 lanes of one warp that split its 32 scores and its D output
// columns, so a row's P and dS go through shared memory only within the
// warp.  Staged rows are padded to D+1 floats so the dot products read
// shared memory without bank conflicts.
//
// Bound on an H100 SXM at the starcoder2-3b training shape (B=4,
// T=S=1024, H=24, K=2, D=128, causal, bf16): the five products of 2*D
// flops per visible (query, key) pair are 64.5 GFLOP, about 65 us at
// 989 TFLOP/s on the tensor cores; the bytes (q, k, v, o, dO, lse read
// once; dq, dk, dv written once) are about 70 MB, 21 us at 3.35 TB/s.  So
// it is bound by operations.  This kernel recomputes QK^T and dO V^T in
// both the dK/dV and the dQ pass (7 products instead of 5) and runs them
// on the CUDA cores, whose f32 rate is 67 TFLOP/s: it is written to be
// right, not fast.  The tensor-core version is later work (ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// Delta[b,h,t] = sum_d dO[b,t,h,d] * O[b,t,h,d], one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int B, int T_, int H, int D) {
  const long row = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * T_ * H) return;             // whole warp leaves
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(load_f32(dout, row * D + d), load_f32(o, row * D + d), acc);
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
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int T_,
                   int S, int H, int K, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const long rows = (long)B * T_ * H;
  const int rows_per_block = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    THREADS, 0, stream>>>(static_cast<const T*>(o), do_,
                                          delta, B, T_, H, D);
  cudaError_t err = cudaGetLastError();
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
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int T_, int S, int H, int K, int D, int causal,
                       int window, float scale, cudaStream_t st) {
  if (D <= 32) return launch<T, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 64) return launch<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 128) return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  if (D <= 256) return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T_, S, H, K, D, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it).
// All tensors are contiguous: q, o, dout, dq (B,T,H,D); k, v, dk, dv
// (B,S,K,D); lse (B,H,T) f32 from the forward; delta (B,H,T) f32 scratch
// that this call fills.  Returns the first failing launch's cudaError_t (0
// on success); the kernels run asynchronously on `stream`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int T, int S, int H, int K, int D, int causal,
    int window, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || K <= 0 || H % K != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, dout, ls, dl, dq, dk, dv, B, T, S, H, K, D, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
