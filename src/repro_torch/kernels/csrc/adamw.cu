// The AdamW update of one parameter leaf in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes AdamW in jnp
// (src/repro/train/optimizer.py) and leaves its fusion to XLA.  The port's
// plain version, the slice loop of `repro_torch.train.optimizer`
// (`update_in_slices`), runs about two dozen separate PyTorch kernels a
// slice, each reading and writing f32 temporaries: about 200 B a parameter.
//
// Same function, element by element, in the loop's order and with each
// operation rounded where PyTorch's own kernel rounds it:
//   gf    = g * clip
//   mf    = b1 * m + c1 * gf                       c1 = (float)(1 - b1)
//   vf    = b2 * v + (c2 * gf) * gf                c2 = (float)(1 - b2)
//   delta = (mf / bc1) / (sqrt(vf / bc2) + eps)
//   delta = delta + wd * p                         matrices only
//   p     = p - lr * delta,  m = mf,  v = vf       stored in their dtypes
// clip, bc1 and bc2 are 0-d f32 tensors on the card, read through pointers
// (no host sync); the Python scalars are f32, as PyTorch casts a scalar
// operand of an f32 tensor.
//
// Exactness: PyTorch rounds each of those operations apart, so every one is
// an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA.  PyTorch's
// add and sub kernels compute a + alpha * b, which nvcc contracts to
// fma(alpha, b, a): with alpha = +-1 that is a + b or a - b rounded once, so
// __fadd_rn / __fsub_rn give the same bits.  The division is true IEEE
// division in both (PyTorch divides by a CUDA tensor, never by a reciprocal),
// the square root IEEE, and stores round to nearest even (__float2bfloat16_rn,
// as c10::BFloat16 does on the card).  The build has no --use_fast_math, so
// denormals are kept, as PyTorch keeps them.
//
// Bound on an H100 SXM: one read of p, g, m and v and one write of p, m and
// v, 22 B a parameter for bf16 p and g with f32 moments; at 3.35 TB/s that is
// 20.9 ms for starcoder2-3b's 3.18 G parameters and 27.4 ms for the 3-layer
// phi3.5-MoE's 4.17 G.  The arithmetic (about 15 operations and one square
// root a parameter) is far below it, so the kernel is bound by bytes.
//
// Design: one launch per leaf, elementwise, no atomics, no temporaries, so
// the result is deterministic by construction.  Each thread takes 8
// consecutive elements an iteration: 16-byte loads and stores (one for 8
// bf16, two for 8 f32) on the bulk of the leaf, whose start is the first
// element at which all four tensors are 16-byte aligned; the head before it
// and the tail after the last whole group of 8 go element by element (the
// whole leaf does when no such start exists).  A grid-stride loop over a
// grid sized to the leaf, capped at BLOCKS_PER_SM blocks on each of the 132
// SMs, so each thread takes one group unless the leaf is larger; 64-bit
// indices (llama3-405b's embedding holds 2.1 G elements).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // elements a thread takes an iteration
constexpr int SMS = 132;
// The grid covers the leaf, one group of VEC a thread, up to this many
// blocks an SM (any leaf below 2.2 G elements); the cap keeps the grid an
// int.  On an H100 SXM at 700 W, over starcoder2-3b's and phi3.5-MoE's
// leaves, such a grid took 24.4 / 30.3 ms where a grid-stride loop over 8
// blocks an SM took 26.2 / 33.6 ms and over 64 blocks 24.7 / 31.8 ms.
constexpr int BLOCKS_PER_SM = 8192;

struct Hyper {
  float b1, c1, b2, c2, eps, lr, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements at a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  reinterpret_cast<uint4*>(p)[0] = u;
}

// One element: p, g, m, v in f32 in; the new p, m and v in f32 out.
template <bool DECAY>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float clip, float bc1, float bc2,
                                       const Hyper& h) {
  const float gf = __fmul_rn(g, clip);
  const float mf = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, gf));
  const float vf = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, gf), gf));
  float delta = __fdiv_rn(__fdiv_rn(mf, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, bc2)), h.eps));
  if (DECAY) delta = __fadd_rn(delta, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, delta));
  m = mf;
  v = vf;
}

template <bool DECAY, typename P, typename G, typename S>
__device__ __forceinline__ void update_one(P* __restrict__ p, const G* __restrict__ g,
                                           S* __restrict__ m, S* __restrict__ v,
                                           int64_t i, float clip, float bc1,
                                           float bc2, const Hyper& h) {
  float pf = to_f32(p[i]), mf = to_f32(m[i]), vf = to_f32(v[i]);
  update<DECAY>(pf, to_f32(g[i]), mf, vf, clip, bc1, bc2, h);
  p[i] = from_f32<P>(pf);
  m[i] = from_f32<S>(mf);
  v[i] = from_f32<S>(vf);
}

// Elements [0, head) and [head + VEC * nvec, n) one at a time, the groups
// of VEC between them vectorised.
template <bool DECAY, typename P, typename G, typename S>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g, S* __restrict__ m,
             S* __restrict__ v, const float* __restrict__ clip_ptr,
             const float* __restrict__ bc1_ptr, const float* __restrict__ bc2_ptr,
             int64_t n, int64_t head, int64_t nvec, Hyper h) {
  const float clip = *clip_ptr, bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = first; i < head; i += stride)
    update_one<DECAY>(p, g, m, v, i, clip, bc1, bc2, h);
  for (int64_t k = first; k < nvec; k += stride) {
    const int64_t i = head + k * VEC;
    float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
#pragma unroll
    for (int u = 0; u < VEC; u += 8) {
      load8(p + i + u, pv + u);
      load8(g + i + u, gv + u);
      load8(m + i + u, mv + u);
      load8(v + i + u, vv + u);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      update<DECAY>(pv[j], gv[j], mv[j], vv[j], clip, bc1, bc2, h);
#pragma unroll
    for (int u = 0; u < VEC; u += 8) {
      store8(p + i + u, pv + u);
      store8(m + i + u, mv + u);
      store8(v + i + u, vv + u);
    }
  }
  for (int64_t i = head + nvec * VEC + first; i < n; i += stride)
    update_one<DECAY>(p, g, m, v, i, clip, bc1, bc2, h);
}

template <typename T>
bool aligned(const void* base, int64_t i) {
  return reinterpret_cast<uintptr_t>(static_cast<const T*>(base) + i) % 16 == 0;
}

template <typename P, typename G, typename S>
cudaError_t launch(void* p, const void* g, void* m, void* v, const float* clip,
                   const float* bc1, const float* bc2, int64_t n, bool decay,
                   const Hyper& h, cudaStream_t stream) {
  // The first element at which all four tensors are 16-byte aligned; VEC is
  // a multiple of every dtype's elements in 16 bytes, so if none of the
  // first VEC is, none is, and the whole leaf goes element by element.
  int64_t head = n;
  for (int64_t i = 0; i < VEC && i < n; ++i)
    if (aligned<P>(p, i) && aligned<G>(g, i) && aligned<S>(m, i) && aligned<S>(v, i)) {
      head = i;
      break;
    }
  const int64_t nvec = (n - head) / VEC;
  const int64_t scalar = n - nvec * VEC;            // head + tail
  const int64_t units = nvec > scalar ? nvec : scalar;
  const int64_t blocks = (units + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < SMS * BLOCKS_PER_SM ? blocks : SMS * BLOCKS_PER_SM);
  P* pp = static_cast<P*>(p);
  const G* gp = static_cast<const G*>(g);
  S* mp = static_cast<S*>(m);
  S* vp = static_cast<S*>(v);
  if (decay)
    adamw_kernel<true><<<grid, THREADS, 0, stream>>>(pp, gp, mp, vp, clip, bc1, bc2,
                                                     n, head, nvec, h);
  else
    adamw_kernel<false><<<grid, THREADS, 0, stream>>>(pp, gp, mp, vp, clip, bc1, bc2,
                                                      n, head, nvec, h);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, of the parameter p, the gradient g and
// the moments m and v (one dtype).  The four sets the port trains with are
// built: (p, g, m/v) = (bf16, bf16, f32), (f32, f32, f32), (bf16, f32, f32)
// (bf16 weights with f32 gradients accumulated over microbatches) and
// (bf16, bf16, bf16) (bf16 moments); any other set returns
// cudaErrorInvalidValue.  p, g, m, v hold n contiguous elements; clip, bc1
// and bc2 point at one f32 each on the card.  Writes p, m and v in place.
// Returns the launch's cudaError_t (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_adamw_update(void* p, const void* g, void* m, void* v,
                                  const void* clip, const void* bc1, const void* bc2,
                                  int p_dtype, int g_dtype, int s_dtype,
                                  long long n, int decay, float b1, float c1,
                                  float b2, float c2, float eps, float lr, float wd,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, c1, b2, c2, eps, lr, wd};
  const float* cp = static_cast<const float*>(clip);
  const float* b1p = static_cast<const float*>(bc1);
  const float* b2p = static_cast<const float*>(bc2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int set = p_dtype * 100 + g_dtype * 10 + s_dtype;
  switch (set) {
    case 110:
      return (int)launch<bf16, bf16, float>(p, g, m, v, cp, b1p, b2p, n, decay != 0, h, st);
    case 0:
      return (int)launch<float, float, float>(p, g, m, v, cp, b1p, b2p, n, decay != 0, h, st);
    case 100:
      return (int)launch<bf16, float, float>(p, g, m, v, cp, b1p, b2p, n, decay != 0, h, st);
    case 111:
      return (int)launch<bf16, bf16, bf16>(p, g, m, v, cp, b1p, b2p, n, decay != 0, h, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
