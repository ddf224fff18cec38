// Fused AdaGrad steps for Hopper (sm_90a).
//
// Replaces
//   K7  src/repro/kernels/fused_adagrad.py  fused_adagrad     (_kernel)
//   K8  src/repro/kernels/fused_adagrad.py  fused_adagrad_q8  (_kernel_q8)
//
// K7, for n elements of the gradient g and the fp32 accumulator a:
//   a'[i] = a[i] + g[i]*g[i]
//   u[i]  = (-lr * g[i]) / (sqrt(a'[i]) + eps)
// The TPU kernel pads to a (rows, 1024) tiling; here it is one flat pass
// with 16-byte loads, a scalar tail and a grid-stride loop.
//
// K8, for the (R, C) tiling of the int8 sqrt-space accumulator (codes q,
// one fp32 scale s a row) and the gradient's first n <= R*C elements
// (the rest are the reference's zero pad):
//   r = q*s,  r' = sqrt(r*r + g*g),  u = (-lr * g) / (r' + eps)
//   s' = max(max_j r'_j, 1e-12) / 127
//   q' = clip(floor(r'/s' + noise), 0, 127)
// One block takes one row (C <= 1024): each thread keeps up to four of
// its elements in registers, the row max goes through warp shuffles and
// shared memory, then the codes are written.  The fp32 accumulator never
// reaches device memory.
//
// Both kernels equal their plain PyTorch versions bit for bit.  PyTorch
// rounds every elementwise op apart, so the products and sums are written
// with __fmul_rn / __fadd_rn, which nvcc never contracts into an fma, and
// division and sqrt are the IEEE ones (__fdiv_rn, __fsqrt_rn; the library
// is built without --use_fast_math).  The row max is order-free.
//
// Bound: bytes.  K7 moves 16 B an element (g, a read; u, a' written) for
// about 6 flops; K8 14 B an element (g, q, noise read; u, q' written)
// plus 8 B a row, for about 10 flops.  Both sit far below the card's
// flop-per-byte ridge, so the design reads each input once and keeps
// every intermediate in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxCols = 1024;
constexpr int kPerThread = kMaxCols / kThreads;   // K8 elements a thread
constexpr float kLevels = 127.0f;
constexpr float kEpsScale = 1e-12f;

__device__ __forceinline__ void adagrad(float g, float a, float neg_lr,
                                        float eps, float* u, float* a_new) {
  const float an = __fadd_rn(a, __fmul_rn(g, g));
  *a_new = an;
  *u = __fdiv_rn(__fmul_rn(neg_lr, g), __fadd_rn(__fsqrt_rn(an), eps));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_adagrad_kernel(const float* __restrict__ g, const float* __restrict__ a,
                     float* __restrict__ u, float* __restrict__ a_out,
                     long long n, float neg_lr, float eps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    for (long long v = i; v < n4; v += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[v];
      const float4 av = reinterpret_cast<const float4*>(a)[v];
      float4 uv, anv;
      adagrad(gv.x, av.x, neg_lr, eps, &uv.x, &anv.x);
      adagrad(gv.y, av.y, neg_lr, eps, &uv.y, &anv.y);
      adagrad(gv.z, av.z, neg_lr, eps, &uv.z, &anv.z);
      adagrad(gv.w, av.w, neg_lr, eps, &uv.w, &anv.w);
      reinterpret_cast<float4*>(u)[v] = uv;
      reinterpret_cast<float4*>(a_out)[v] = anv;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride)
    adagrad(g[j], a[j], neg_lr, eps, &u[j], &a_out[j]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_adagrad_q8_kernel(const float* __restrict__ g,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        const float* __restrict__ noise,
                        float* __restrict__ u, int8_t* __restrict__ q_out,
                        float* __restrict__ scale_out, long long n, int C,
                        float neg_lr, float eps) {
  __shared__ float warp_maxes[kThreads / 32];
  const int row = blockIdx.x;
  const long long off = static_cast<long long>(row) * C;
  const float s = scale[row];
  float r_new[kPerThread];
  float gk[kPerThread];
  float amax = 0.f;     // r' >= 0
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    r_new[k] = 0.f;
    gk[k] = 0.f;
    if (j < C) {
      const long long idx = off + j;
      gk[k] = idx < n ? g[idx] : 0.f;
      const float r = __fmul_rn(static_cast<float>(q[idx]), s);
      r_new[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(r, r),
                                      __fmul_rn(gk[k], gk[k])));
      amax = fmaxf(amax, r_new[k]);
      if (idx < n)
        u[idx] = __fdiv_rn(__fmul_rn(neg_lr, gk[k]),
                           __fadd_rn(r_new[k], eps));
    }
  }
  amax = warp_max(amax);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) warp_maxes[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < n_warps ? warp_maxes[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) warp_maxes[0] = m;
  }
  __syncthreads();
  const float s_new = __fdiv_rn(fmaxf(warp_maxes[0], kEpsScale), kLevels);
  if (threadIdx.x == 0) scale_out[row] = s_new;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < C) {
      const long long idx = off + j;
      float c = floorf(__fadd_rn(__fdiv_rn(r_new[k], s_new), noise[idx]));
      c = fminf(fmaxf(c, 0.f), kLevels);
      q_out[idx] = static_cast<int8_t>(static_cast<int>(c));
    }
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

// K7.  g, a, u, a_out: n fp32 each.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_adagrad(const float* g, const float* a, float* u,
                             float* a_out, long long n, float lr, float eps,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(g, 16) && aligned(a, 16) && aligned(u, 16) &&
                   aligned(a_out, 16);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    fused_adagrad_kernel<true><<<grid, kThreads, 0, st>>>(g, a, u, a_out, n,
                                                          -lr, eps);
  else
    fused_adagrad_kernel<false><<<grid, kThreads, 0, st>>>(g, a, u, a_out, n,
                                                           -lr, eps);
  return static_cast<int>(cudaGetLastError());
}

// K8.  g: n fp32 (n <= R*C); q, q_out: (R, C) int8; scale, scale_out:
// (R,) fp32; noise: (R, C) fp32; u: n fp32.  C <= 1024.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_adagrad_q8(const float* g, const int8_t* q,
                                const float* scale, const float* noise,
                                float* u, int8_t* q_out, float* scale_out,
                                long long n, int R, int C, float lr,
                                float eps, void* stream) {
  if (R <= 0 || C <= 0 || C > kMaxCols || n <= 0 ||
      n > static_cast<long long>(R) * C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // enough threads for four elements each, in whole warps
  int threads = ((C + kPerThread - 1) / kPerThread + 31) / 32 * 32;
  if (threads > kThreads) threads = kThreads;
  fused_adagrad_q8_kernel<<<R, threads, 0, st>>>(
      g, q, scale, noise, u, q_out, scale_out, n, C, -lr, eps);
  return static_cast<int>(cudaGetLastError());
}
