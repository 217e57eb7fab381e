// LayerNorm and RMSNorm over the last dim, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes its norms in jnp
// (src/repro/models/layers.py `apply_norm`, `_qk_normalize`) and leaves
// their fusion to XLA.  The port's plain version,
// `repro_torch.kernels.ref.norm_ref`, is that chain of PyTorch ops: an f32
// copy of x, then six (RMSNorm) or eleven (LayerNorm) separate passes over
// f32 temporaries and a cast back, about 40 / 68 B an element forward where
// one read and one write of bf16 is 4 B, and autograd's backward through it
// as much again.
//
// Same function, row by row, with the chain's rounding points:
//   LayerNorm  mean = sum(x) / C,  d = x - mean,  var = sum(d * d) / C
//              y = (d * rstd) * scale + bias,     rstd = rsqrt(var + eps)
//   RMSNorm    ms = sum(x * x) / C,  y = (x * rstd) * scale,  rstd = rsqrt(ms + eps)
// x is read in its dtype (f32 or bf16) and taken to f32 exactly; scale and
// bias are f32; y is rounded once, to x's dtype.  Each product and sum the
// chain rounds apart is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn), which nvcc never contracts into an FMA; rsqrtf is
// the instruction PyTorch's rsqrt runs on the card.  Only the order of the
// two f32 row sums differs from the chain's (two passes as there, not
// Welford and not E[x^2] - mean^2).  The backward, from the saved mean and
// rstd, with x_hat = d * rstd (LayerNorm) or x * rstd and g = dy * scale:
//   LayerNorm  dx = rstd * ((g - mean(g)) - x_hat * mean(g * x_hat))
//   RMSNorm    dx = rstd * (g - x_hat * mean(g * x_hat))
//   dscale = sum over rows of dy * x_hat,  dbias = sum over rows of dy.
//
// Bound on an H100 SXM: one read of x and one write of y forward (4 B an
// element in bf16, plus a few bytes a row of statistics), one read of x
// and dy and one write of dx backward (6 B); at 3.35 TB/s starcoder2-3b's
// 8192 x 3072 bf16 rows take 30 us forward and 45 us backward.  A few
// operations an element and one rsqrt a row are far below that, so both
// kernels are bound by bytes, and their design keeps each row on chip.
//
// Design.  A row is taken by a group of TPR threads; thread t of the group
// holds its K vectors of VEC elements (16 bytes of x) at vector indices
// t, t + TPR, ... in registers, and the C % VEC elements after the last
// whole vector (the tail) one a thread.  Rows of 16-byte-aligned starts
// (base, row stride and width) are read and written with 16-byte loads and
// stores; any other layout takes the same slots element by element.  Rows
// may have a stride (a split's views of one projection are read in place).
// The shape of the launch follows the width: up to 32 vectors a row, one
// vector a thread and several rows a warp (TPR a power of two: Jamba's B/C
// norms of 16 take 2 threads, its dt norm of 160 and a qk-norm head of 128
// one row a half or whole warp); wider rows a multiple of 32 threads, each
// holding up to 8 vectors forward and 32 elements of x and of dy backward
// (MAX_WIDTH, 16384, in registers: llama3-405b's rows are the widest).
// Row sums: a shuffle butterfly inside the warp (both lanes of a pair add
// the same two values, so every lane ends with the same bits), then the
// group's warps through shared memory, added in warp order by every thread.
// The forward reads x once and writes y, the row's mean (LayerNorm) and
// rstd once.
//
// The backward computes dx for each row and accumulates dy * x_hat (and dy)
// per column in shared memory, one accumulator set per row group.  A block
// of up to 512 threads holds as many groups as fit, and takes a fixed range
// of rows, its groups walking it in turn; the grid is one wave of such
// blocks (SMs times the blocks an SM holds).  At its end the block adds its
// groups' accumulators in group order and writes its partial vector to
// row `block` of an f32 scratch; a second launch adds the partials of each
// column in block order.  No atomics, so a second call gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_TPR = 512;         // threads a row at most (and a block)
constexpr int FWD_BLOCK = 256;       // threads a forward block aims at
constexpr int BWD_BLOCK = 512;       // threads a backward block holds at most
constexpr int TARGET_TPR = 128;      // threads a wide row aims at
constexpr int FWD_MAX_K = 8;         // vectors of x a thread holds forward
constexpr int BWD_MAX_FLOATS = 32;   // elements of x (and of dy) a thread holds backward
constexpr int MAX_SMEM = 200 * 1024; // the backward's accumulators at most
constexpr int SUM_COLS = 32;         // partial sums: columns a block,
constexpr int SUM_LANES = 8;         //   and partial rows added apart in it

struct Row {
  int C;        // width
  int nvec;     // whole vectors of VEC elements a row: C / VEC
  int tail;     // the C % VEC elements after them, one a thread
  float inv_c;  // 1 / C, as the chain's mean scales its sum
  bool vec;     // every row start 16-byte aligned: vector loads and stores
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements at p as f32: 16-byte loads when `vec` (p then
// 16-byte aligned), else one at a time.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* x, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* x, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        x[i + 2 * k] = f.x;
        x[i + 2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float* x, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
  }
}
template <int N>
__device__ __forceinline__ void store_n(__nv_bfloat16* p, const float* x, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[i + 2 * k], x[i + 2 * k + 1]);
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(x[i]);
  }
}

// Asks the card to bring `bytes` (a multiple of 16) at the 16-byte aligned
// global address p into L2 (Hopper's bulk prefetch; one instruction a row).
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(p), "r"(bytes) : "memory");
}

// The sums of v over the TPR threads of this thread's row group, in every
// thread of the group with the same bits.  Called by every thread of the
// block alike (TPR is the block's; above a warp it syncs the block).
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int tpr, float* red) {
  const int width = tpr < WARP ? tpr : WARP;
  for (int o = width / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (tpr > WARP) {
    const int warp = threadIdx.x / WARP, wpg = tpr / WARP;
    const int first = warp / wpg * wpg;
    if (threadIdx.x % WARP == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) red[warp * N + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = red[first * N + i];
      for (int w = 1; w < wpg; ++w) s += red[(first + w) * N + i];
      v[i] = s;
    }
    __syncthreads();
  }
}

// Forward: one row a group, G = blockDim / tpr groups a block.
template <typename T, bool LN, int K>
__global__ void __launch_bounds__(MAX_TPR)
norm_fwd_kernel(const T* __restrict__ x, long long ld, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                long long R, Row rw, int tpr, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[MAX_TPR / WARP];
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + g;
  const bool live = row < R;
  const T* xr = x + (live ? row : 0LL) * ld;

  float v[K][VEC];
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = t + k * tpr;
    ok[k] = live && q < rw.nvec;
    if (ok[k]) {
      load_n<VEC>(xr + (long long)q * VEC, v[k], rw.vec);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
    }
  }
  const bool tl = live && t < rw.tail;
  const int tcol = rw.nvec * VEC + t;
  float vt = tl ? to_f32(xr[tcol]) : 0.f;

  float mean = 0.f;
  if (LN) {
    float s[1] = {vt};
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[0] += v[k][j];
    group_sum(s, tpr, red);
    mean = s[0] * rw.inv_c;
  }
  float q2[1] = {0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!ok[k]) continue;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (LN) v[k][j] = __fsub_rn(v[k][j], mean);
      q2[0] += __fmul_rn(v[k][j], v[k][j]);
    }
  }
  if (tl) {
    if (LN) vt = __fsub_rn(vt, mean);
    q2[0] += __fmul_rn(vt, vt);
  }
  group_sum(q2, tpr, red);
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(q2[0], rw.inv_c), eps));
  if (!live) return;                        // past the block's last sync
  if (t == 0) {
    if (LN) mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  T* yr = y + row * rw.C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!ok[k]) continue;
    const int c0 = (t + k * tpr) * VEC;
    float sc[VEC], bi[VEC], o[VEC];
    load_n<VEC>(scale + c0, sc, rw.vec);
    if (LN) load_n<VEC>(bias + c0, bi, rw.vec);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float u = __fmul_rn(__fmul_rn(v[k][j], rstd), sc[j]);
      if (LN) u = __fadd_rn(u, bi[j]);
      o[j] = u;
    }
    store_n<VEC>(yr + c0, o, rw.vec);
  }
  if (tl) {
    float u = __fmul_rn(__fmul_rn(vt, rstd), scale[tcol]);
    if (LN) u = __fadd_rn(u, bias[tcol]);
    yr[tcol] = from_f32<T>(u);
  }
}

// Backward: rows [blockIdx.x * rows_per_block, + rows_per_block) of R, the
// block's groups taking them in turn.  dx written per row; the block's sums
// of dy * x_hat (and of dy) per column to row blockIdx.x of `part` (and of
// `part` + gridDim.x * C).  Shared memory: the accumulators, [group][slot][t].
template <typename T, bool LN, int K>
__global__ void __launch_bounds__(MAX_TPR)
norm_bwd_kernel(const T* __restrict__ x, long long ld, const T* __restrict__ dy,
                const float* __restrict__ scale, const float* __restrict__ mean_in,
                const float* __restrict__ rstd_in, T* __restrict__ dx,
                float* __restrict__ part, long long R, long long rows_per_block,
                Row rw, int tpr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int S = K * VEC + 1;            // slots a thread: its vectors' elements, its tail
  extern __shared__ float acc[];
  __shared__ float red[2 * MAX_TPR / WARP];
  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  float* acc_s = acc + g * S * tpr + t;     // slot s at acc_s[s * tpr]
  float* acc_b = acc_s + groups * S * tpr;  // LayerNorm only
#pragma unroll
  for (int s = 0; s < S; ++s) {
    acc_s[s * tpr] = 0.f;
    if (LN) acc_b[s * tpr] = 0.f;
  }

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < R ? r0 + rows_per_block : R;
  const long long iters = r1 > r0 ? (r1 - r0 + groups - 1) / groups : 0;
  const int tcol = rw.nvec * VEC + t;
  for (long long it = 0; it < iters; ++it) {
    const long long row = r0 + it * groups + g;
    const bool live = row < r1;
    const T* xr = x + (live ? row : 0LL) * ld;
    const T* dyr = dy + (live ? row : 0LL) * rw.C;
    float xv[K][VEC], gv[K][VEC];
    bool ok[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * tpr;
      ok[k] = live && q < rw.nvec;
      if (ok[k]) {
        load_n<VEC>(xr + (long long)q * VEC, xv[k], rw.vec);
        load_n<VEC>(dyr + (long long)q * VEC, gv[k], rw.vec);
      }
    }
    // The group's next row into L2 while this one is worked on: the block
    // holds one row a group, so its loads would otherwise wait on DRAM
    // every turn.
    if (t == 0 && rw.vec && row + groups < r1) {
      const unsigned bytes = (unsigned)(rw.C * sizeof(T));
      prefetch_l2(x + (row + groups) * ld, bytes);
      prefetch_l2(dy + (row + groups) * rw.C, bytes);
    }
    const bool tl = live && t < rw.tail;
    float xt = 0.f, gt = 0.f;
    if (tl) {
      xt = to_f32(xr[tcol]);
      gt = to_f32(dyr[tcol]);
    }
    const float mean = (LN && live) ? mean_in[row] : 0.f;
    const float rstd = live ? rstd_in[row] : 0.f;

    // x_hat into xv, g = dy * scale into gv; the column sums; the row sums.
    float sums[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      const int c0 = (t + k * tpr) * VEC;
      float sc[VEC];
      load_n<VEC>(scale + c0, sc, rw.vec);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = LN ? __fmul_rn(__fsub_rn(xv[k][j], mean), rstd)
                            : __fmul_rn(xv[k][j], rstd);
        const float d = gv[k][j];
        const int s = (k * VEC + j) * tpr;
        acc_s[s] += __fmul_rn(d, xh);
        if (LN) acc_b[s] += d;
        const float gg = __fmul_rn(d, sc[j]);
        if (LN) sums[0] += gg;
        sums[1] += __fmul_rn(gg, xh);
        xv[k][j] = xh;
        gv[k][j] = gg;
      }
    }
    if (tl) {
      const float xh = LN ? __fmul_rn(__fsub_rn(xt, mean), rstd) : __fmul_rn(xt, rstd);
      const int s = K * VEC * tpr;
      acc_s[s] += __fmul_rn(gt, xh);
      if (LN) acc_b[s] += gt;
      const float gg = __fmul_rn(gt, scale[tcol]);
      if (LN) sums[0] += gg;
      sums[1] += __fmul_rn(gg, xh);
      xt = xh;
      gt = gg;
    }
    group_sum(sums, tpr, red);
    if (!live) continue;
    const float a = __fmul_rn(sums[0], rw.inv_c), b = __fmul_rn(sums[1], rw.inv_c);
    T* dxr = dx + row * rw.C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float u = LN ? __fsub_rn(gv[k][j], a) : gv[k][j];
        o[j] = __fmul_rn(rstd, __fsub_rn(u, __fmul_rn(xv[k][j], b)));
      }
      store_n<VEC>(dxr + (t + k * tpr) * VEC, o, rw.vec);
    }
    if (tl) {
      const float u = LN ? __fsub_rn(gt, a) : gt;
      dxr[tcol] = from_f32<T>(__fmul_rn(rstd, __fsub_rn(u, __fmul_rn(xt, b))));
    }
  }

  // The block's partial vectors: each column's accumulators added in group
  // order.  Every column of the row is written (zeros where the block took
  // no row).
  __syncthreads();
  for (int i = threadIdx.x; i < S * tpr; i += blockDim.x) {
    const int s = i / tpr, tt = i % tpr;
    int col;
    if (s < K * VEC) {
      const int q = tt + (s / VEC) * tpr;
      if (q >= rw.nvec) continue;
      col = q * VEC + s % VEC;
    } else {
      if (tt >= rw.tail) continue;
      col = rw.nvec * VEC + tt;
    }
    float ps = 0.f, pb = 0.f;
    for (int gr = 0; gr < groups; ++gr) {
      ps += acc[(gr * S + s) * tpr + tt];
      if (LN) pb += acc[((groups + gr) * S + s) * tpr + tt];
    }
    part[(long long)blockIdx.x * rw.C + col] = ps;
    if (LN) part[((long long)gridDim.x + blockIdx.x) * rw.C + col] = pb;
  }
}

// out_y[c] = sum over b < P of part[y][b][c], added in b order: SUM_LANES
// lanes take every SUM_LANES-th partial row, then their sums in lane order.
// blockIdx.y picks the scale's (0) or the bias's (1) partials.
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out0,
                    float* __restrict__ out1, int P, int C) {
  __shared__ float lanes[SUM_LANES][SUM_COLS];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  const float* p = part + (long long)blockIdx.y * P * C;
  float s = 0.f;
  if (col < C)
    for (int b = threadIdx.y; b < P; b += SUM_LANES) s += p[(long long)b * C + col];
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= C) return;
  float total = lanes[0][threadIdx.x];
#pragma unroll
  for (int l = 1; l < SUM_LANES; ++l) total += lanes[l][threadIdx.x];
  (blockIdx.y == 0 ? out0 : out1)[col] = total;
}

// Threads a row (tpr), vectors a thread (K) and rows a block (groups).
struct Plan {
  int K, tpr, groups;
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Up to a warp's worth of vectors: one vector a thread, TPR a power of two
// (at least the tail), several rows a warp.  Wider: K doubles (up to kmax)
// until the row takes at most TARGET_TPR threads, rounded up to warps.
Plan plan(const Row& rw, int kmax, int block) {
  Plan p;
  if (rw.nvec <= WARP) {
    const int need = rw.nvec > rw.tail ? rw.nvec : rw.tail;
    p.K = 1;
    p.tpr = pow2_at_least(need > 1 ? need : 1);
    p.groups = block / p.tpr;
  } else {
    int K = 1;
    while (K < kmax && (rw.nvec + K - 1) / K > TARGET_TPR) K *= 2;
    p.K = K;
    p.tpr = ((rw.nvec + K - 1) / K + WARP - 1) / WARP * WARP;
    p.groups = p.tpr < block ? block / p.tpr : 1;
  }
  return p;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
Row row_of(int C, long long ld, bool aligned) {
  constexpr int VEC = 16 / sizeof(T);
  Row rw;
  rw.C = C;
  rw.nvec = C / VEC;
  rw.tail = C - rw.nvec * VEC;
  rw.inv_c = 1.0f / (float)C;
  rw.vec = aligned && C % VEC == 0 && ld % VEC == 0;
  return rw;
}

template <typename T, bool LN, int K>
cudaError_t launch_fwd(const T* x, long long ld, const float* scale, const float* bias,
                       T* y, float* mean, float* rstd, long long R, const Row& rw,
                       const Plan& p, float eps, cudaStream_t st) {
  const long long grid = (R + p.groups - 1) / p.groups;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  norm_fwd_kernel<T, LN, K><<<(unsigned)grid, p.groups * p.tpr, 0, st>>>(
      x, ld, scale, bias, y, mean, rstd, R, rw, p.tpr, eps);
  return cudaGetLastError();
}

template <typename T, bool LN>
cudaError_t fwd(const void* x, long long ld, const void* scale, const void* bias,
                void* y, void* mean, void* rstd, long long R, int C, float eps,
                cudaStream_t st) {
  const bool al = aligned16(x) && aligned16(y) && aligned16(scale)
                  && (!LN || aligned16(bias));
  const Row rw = row_of<T>(C, ld, al);
  const Plan p = plan(rw, FWD_MAX_K, FWD_BLOCK);
  if (p.tpr > MAX_TPR) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  switch (p.K) {
    case 1: return launch_fwd<T, LN, 1>(xp, ld, sp, bp, yp, mp, rp, R, rw, p, eps, st);
    case 2: return launch_fwd<T, LN, 2>(xp, ld, sp, bp, yp, mp, rp, R, rw, p, eps, st);
    case 4: return launch_fwd<T, LN, 4>(xp, ld, sp, bp, yp, mp, rp, R, rw, p, eps, st);
    case 8: return launch_fwd<T, LN, 8>(xp, ld, sp, bp, yp, mp, rp, R, rw, p, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's launch: its plan, shared memory, grid and rows a block.
struct Bwd {
  Plan p;
  int smem;
  int grid;
  long long rows_per_block;
};

// The backward's kernels are built for the K its plans take: K * VEC at
// most BWD_MAX_FLOATS.
template <typename T, int K>
constexpr bool bwd_built() { return K * (16 / (int)sizeof(T)) <= BWD_MAX_FLOATS; }

template <typename T, bool LN, int K>
const void* bwd_kernel_k() {
  if constexpr (bwd_built<T, K>())
    return reinterpret_cast<const void*>(norm_bwd_kernel<T, LN, K>);
  else
    return nullptr;
}

template <typename T, bool LN>
const void* bwd_kernel(int K) {
  switch (K) {
    case 1: return bwd_kernel_k<T, LN, 1>();
    case 2: return bwd_kernel_k<T, LN, 2>();
    case 4: return bwd_kernel_k<T, LN, 4>();
    case 8: return bwd_kernel_k<T, LN, 8>();
    default: return nullptr;
  }
}

template <typename T, bool LN>
cudaError_t bwd_geometry(long long R, int C, Bwd* b) {
  constexpr int VEC = 16 / sizeof(T);
  const Row rw = row_of<T>(C, C, true);      // the plan depends on C alone
  Plan p = plan(rw, BWD_MAX_FLOATS / VEC, BWD_BLOCK);
  if (p.tpr > MAX_TPR) return cudaErrorInvalidValue;
  const int per_group = (LN ? 2 : 1) * (p.K * VEC + 1) * p.tpr * (int)sizeof(float);
  while (p.groups > 1 && p.groups * per_group > MAX_SMEM) --p.groups;
  if (p.groups * per_group > MAX_SMEM) return cudaErrorInvalidValue;
  const void* k = bwd_kernel<T, LN>(p.K);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MAX_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, p.groups * p.tpr,
                                                    p.groups * per_group);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long grid = (R + p.groups - 1) / p.groups;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  if (grid < 1) grid = 1;
  b->p = p;
  b->smem = p.groups * per_group;
  b->grid = (int)grid;
  b->rows_per_block = (R + grid - 1) / grid;
  return cudaSuccess;
}

template <typename T, bool LN, int K>
cudaError_t launch_bwd(const T* x, long long ld, const T* dy, const float* scale,
                       const float* mean, const float* rstd, T* dx, float* part,
                       long long R, const Row& rw, const Bwd& b, cudaStream_t st) {
  if constexpr (bwd_built<T, K>()) {
    norm_bwd_kernel<T, LN, K><<<b.grid, b.p.groups * b.p.tpr, b.smem, st>>>(
        x, ld, dy, scale, mean, rstd, dx, part, R, b.rows_per_block, rw, b.p.tpr);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, bool LN>
cudaError_t bwd(const void* x, long long ld, const void* dy, const void* scale,
                const void* mean, const void* rstd, void* dx, void* part,
                void* dscale, void* dbias, long long R, int C, cudaStream_t st) {
  Bwd b;
  cudaError_t e = bwd_geometry<T, LN>(R, C, &b);
  if (e != cudaSuccess) return e;
  const bool al = aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(scale);
  const Row rw = row_of<T>(C, ld, al);
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const float* sp = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  switch (b.p.K) {
    case 1: e = launch_bwd<T, LN, 1>(xp, ld, dyp, sp, mp, rp, dxp, pp, R, rw, b, st); break;
    case 2: e = launch_bwd<T, LN, 2>(xp, ld, dyp, sp, mp, rp, dxp, pp, R, rw, b, st); break;
    case 4: e = launch_bwd<T, LN, 4>(xp, ld, dyp, sp, mp, rp, dxp, pp, R, rw, b, st); break;
    case 8: e = launch_bwd<T, LN, 8>(xp, ld, dyp, sp, mp, rp, dxp, pp, R, rw, b, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid((C + SUM_COLS - 1) / SUM_COLS, LN ? 2 : 1);
  sum_partials_kernel<<<grid, dim3(SUM_COLS, SUM_LANES), 0, st>>>(
      pp, static_cast<float*>(dscale), static_cast<float*>(dbias), b.grid, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x, y, dy and dx; scale, bias, mean,
// rstd, the partial sums, dscale and dbias are f32.  layernorm: 1 for
// LayerNorm, 0 for RMSNorm (mean, bias and dbias unused).  x holds R rows of C elements, row r at x + r * ld (ld >= C);
// y, dy and dx are contiguous (ld = C).  Each returns the launch's
// cudaError_t (0 on success); the kernels run asynchronously on `stream`.

// y = norm(x); mean (LayerNorm) and rstd: R floats each.
extern "C" int repro_norm_fwd(const void* x, long long ld, const void* scale,
                              const void* bias, void* y, void* mean, void* rstd,
                              int dtype, int layernorm, long long R, int C,
                              float eps, void* stream) {
  if (R <= 0 || C <= 0 || ld < C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (dtype * 2 + (layernorm != 0)) {
    case 0: return (int)fwd<float, false>(x, ld, scale, nullptr, y, nullptr, rstd, R, C, eps, st);
    case 1: return (int)fwd<float, true>(x, ld, scale, bias, y, mean, rstd, R, C, eps, st);
    case 2: return (int)fwd<bf16, false>(x, ld, scale, nullptr, y, nullptr, rstd, R, C, eps, st);
    case 3: return (int)fwd<bf16, true>(x, ld, scale, bias, y, mean, rstd, R, C, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows of partial sums (each C floats) the backward writes, for the scale
// (and as many again for the bias under LayerNorm), on the current device;
// negative: the cudaError_t, negated, that refuses the shape.
extern "C" long long repro_norm_bwd_partials(int dtype, int layernorm, long long R, int C) {
  if (R <= 0 || C <= 0) return -(long long)cudaErrorInvalidValue;
  Bwd b;
  cudaError_t e;
  switch (dtype * 2 + (layernorm != 0)) {
    case 0: e = bwd_geometry<float, false>(R, C, &b); break;
    case 1: e = bwd_geometry<float, true>(R, C, &b); break;
    case 2: e = bwd_geometry<__nv_bfloat16, false>(R, C, &b); break;
    case 3: e = bwd_geometry<__nv_bfloat16, true>(R, C, &b); break;
    default: return -(long long)cudaErrorInvalidValue;
  }
  return e == cudaSuccess ? (long long)b.grid : -(long long)e;
}

// dx, dscale (C) and, under LayerNorm, dbias (C) from
// x, dy, the scale and the forward's mean and rstd; part holds
// repro_norm_bwd_partials(...) rows of C floats (twice that under LayerNorm).
extern "C" int repro_norm_bwd(const void* x, long long ld, const void* dy,
                              const void* scale, const void* mean, const void* rstd,
                              void* dx, void* part, void* dscale, void* dbias,
                              int dtype, int layernorm, long long R, int C,
                              void* stream) {
  if (R <= 0 || C <= 0 || ld < C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (dtype * 2 + (layernorm != 0)) {
    case 0: return (int)bwd<float, false>(x, ld, dy, scale, nullptr, rstd, dx, part,
                                          dscale, nullptr, R, C, st);
    case 1: return (int)bwd<float, true>(x, ld, dy, scale, mean, rstd, dx, part,
                                         dscale, dbias, R, C, st);
    case 2: return (int)bwd<bf16, false>(x, ld, dy, scale, nullptr, rstd, dx, part,
                                         dscale, nullptr, R, C, st);
    case 3: return (int)bwd<bf16, true>(x, ld, dy, scale, mean, rstd, dx, part,
                                        dscale, dbias, R, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
