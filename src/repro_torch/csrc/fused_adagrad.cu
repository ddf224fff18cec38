// Fused AdaGrad steps for Hopper (sm_90a): one launch for a whole list of
// parameter tensors (leaves).
//
// Replaces
//   K7  src/repro/kernels/fused_adagrad.py  fused_adagrad     (_kernel)
//   K8  src/repro/kernels/fused_adagrad.py  fused_adagrad_q8  (_kernel_q8)
//
// K7, for a leaf's gradient g and accumulator a:
//   a'[i] = a[i] + g[i]*g[i]
//   u[i]  = (-lr * g[i]) / (sqrt(a'[i]) + eps)
// K8, for the (R, C) tiling of a leaf's int8 sqrt-space accumulator (codes
// q, one fp32 scale s a row) and the gradient's first n <= R*C elements
// (the rest are the reference's zero pad):
//   r = q*s,  r' = sqrt(r*r + g*g),  u = (-lr * g) / (r' + eps)
//   s' = max(max_j r'_j, 1e-12) / 127
//   q' = clip(floor(r'/s' + noise), 0, 127)
// Then, in the same pass, u is multiplied by the draw's mask (a 0-d fp32
// tensor in device memory) when a scale pointer is given, and either
// added to the parameter (p' = p + u in fp32, rounded to p's type) or
// written out as the update.
//
// The leaves travel in a fixed-capacity table passed by value as a kernel
// parameter (__grid_constant__: read in place from the parameter bank):
// no host-to-device copy, no device allocation, so a launch can be
// captured in a CUDA graph.  The table holds each leaf's pointers, its
// element count, its operand types and whether all its pointers are
// 16-byte aligned, and the prefix sum of the blocks its leaves take:
//   K7: one block a chunk of kChunk elements, so a scalar and a
//       425,984-element table get work in proportion; 16-byte loads where
//       the leaf is aligned, scalar loads where it is not (a view) and on
//       the tail;
//   K8: one block a row of the leaf's tiling (C <= 1024): each thread
//       keeps up to four of its elements in registers, the row max goes
//       through warp shuffles and shared memory, then the codes are
//       written.  A block owns its row, so the codes and the scale are
//       read into registers before q' and s' overwrite them in place.
// A block finds its leaf by binary search over the prefix sum.
//
// The gradient and the parameter may be fp32 or bf16 (bf16 is widened
// exactly; a bf16 result is rounded to nearest even), and so may K7's
// accumulator (the bf16 state: a' is rounded to bf16 when it is stored,
// after u has taken the fp32 a').
//
// Both kernels equal their plain PyTorch versions bit for bit.  PyTorch
// rounds every elementwise op apart, so the products and sums are written
// with __fmul_rn / __fadd_rn, which nvcc never contracts into an fma, and
// division and sqrt are the IEEE ones (__fdiv_rn, __fsqrt_rn; the library
// is built without --use_fast_math).  The row max is order-free.
//
// Bound: bytes.  K7 applying an fp32 update moves 20 B an element (g, a,
// p read; a', p' written) for about 7 flops; K8 18 B an element (g, q,
// noise, p read; q', p' written) plus 8 B a row.  Both sit far below the
// card's flop-per-byte ridge, so the design reads each input once, keeps
// every intermediate in registers and writes no update tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeaves = 48;          // leaves a launch (table capacity)
constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;  // K7 elements a block
constexpr int kMaxCols = 1024;
constexpr int kPerThread = 4;        // K8 elements a thread at most
constexpr float kLevels = 127.0f;
constexpr float kEpsScale = 1e-12f;

// a leaf's flags
constexpr int kGradBf16 = 1;
constexpr int kAccumBf16 = 2;        // K7 only
constexpr int kDstBf16 = 4;          // the parameter, when it is applied
constexpr int kAligned = 8;          // K7: every pointer 16-byte aligned

struct K7Leaf {
  const void* g;
  const void* a;
  void* a_out;      // may equal a (in place)
  void* dst;        // p (apply), or u (fp32, written)
  long long n;
  int flags;
  int pad;
};

struct K7Table {
  K7Leaf leaf[kLeaves];
  int start[kLeaves + 1];   // first block of each leaf; start[n_leaves]: grid
  int n_leaves;
};

struct K8Leaf {
  const void* g;
  const int8_t* q;
  const float* s;
  int8_t* q_out;    // may equal q (in place)
  float* s_out;     // may equal s
  const float* noise;
  void* dst;        // p (apply), or u (fp32, written)
  long long n;      // gradient elements, <= R*C
  int C;
  int flags;
};

struct K8Table {
  K8Leaf leaf[kLeaves];
  int start[kLeaves + 1];   // first row (block) of each leaf
  int n_leaves;
};

// under the classic 4 KB kernel-parameter limit with the other parameters
static_assert(sizeof(K7Table) + 32 <= 4096, "K7 table too large");
static_assert(sizeof(K8Table) + 32 <= 4096, "K8 table too large");

template <class Table>
__device__ __forceinline__ int find_leaf(const Table& t, int block) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= block) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float load1(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store1(void* p, long long i, float v,
                                       bool bf) {
  if (bf) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}

// elements 4v .. 4v+3: 16 bytes of fp32 or 8 of bf16
__device__ __forceinline__ float4 load4(const void* p, long long v,
                                        bool bf) {
  if (!bf) return static_cast<const float4*>(p)[v];
  const uint2 w = static_cast<const uint2*>(p)[v];
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(void* p, long long v, float4 x,
                                       bool bf) {
  if (!bf) {
    static_cast<float4*>(p)[v] = x;
    return;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&lo);
  w.y = *reinterpret_cast<const unsigned int*>(&hi);
  static_cast<uint2*>(p)[v] = w;
}

struct Step {
  float neg_lr, eps, s;
  bool scaled;
};

// one element: a' into *a_new, -> the (scaled) update
__device__ __forceinline__ float adagrad(float g, float a, const Step& st,
                                         float* a_new) {
  const float an = __fadd_rn(a, __fmul_rn(g, g));
  *a_new = an;
  const float u = __fdiv_rn(__fmul_rn(st.neg_lr, g),
                            __fadd_rn(__fsqrt_rn(an), st.eps));
  return st.scaled ? __fmul_rn(u, st.s) : u;
}

__global__ void __launch_bounds__(kThreads)
fused_adagrad_kernel(const __grid_constant__ K7Table t,
                     const float* scale, float neg_lr, float eps,
                     int apply) {
  const int i = find_leaf(t, blockIdx.x);
  const K7Leaf& L = t.leaf[i];
  const long long begin =
      static_cast<long long>(blockIdx.x - t.start[i]) * kChunk;
  const long long end = min(begin + kChunk, L.n);
  const Step st{neg_lr, eps, scale ? *scale : 1.f, scale != nullptr};
  const bool gb = L.flags & kGradBf16, ab = L.flags & kAccumBf16,
             db = L.flags & kDstBf16;
  long long j0 = begin;
  if (L.flags & kAligned) {
    const long long v1 = end >> 2;   // begin is a multiple of 4
    for (long long v = (begin >> 2) + threadIdx.x; v < v1; v += kThreads) {
      const float4 g = load4(L.g, v, gb), a = load4(L.a, v, ab);
      float4 an, u;
      u.x = adagrad(g.x, a.x, st, &an.x);
      u.y = adagrad(g.y, a.y, st, &an.y);
      u.z = adagrad(g.z, a.z, st, &an.z);
      u.w = adagrad(g.w, a.w, st, &an.w);
      store4(L.a_out, v, an, ab);
      if (apply) {
        float4 p = load4(L.dst, v, db);
        p.x = __fadd_rn(p.x, u.x);
        p.y = __fadd_rn(p.y, u.y);
        p.z = __fadd_rn(p.z, u.z);
        p.w = __fadd_rn(p.w, u.w);
        store4(L.dst, v, p, db);
      } else {
        store4(L.dst, v, u, false);
      }
    }
    j0 = v1 << 2;
  }
  for (long long j = j0 + threadIdx.x; j < end; j += kThreads) {
    float an;
    const float u = adagrad(load1(L.g, j, gb), load1(L.a, j, ab), st, &an);
    store1(L.a_out, j, an, ab);
    if (apply) store1(L.dst, j, __fadd_rn(load1(L.dst, j, db), u), db);
    else static_cast<float*>(L.dst)[j] = u;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_adagrad_q8_kernel(const __grid_constant__ K8Table t,
                        const float* scale, float neg_lr, float eps,
                        int apply) {
  __shared__ float warp_maxes[kThreads / 32];
  const int i = find_leaf(t, blockIdx.x);
  const K8Leaf& L = t.leaf[i];
  const int row = blockIdx.x - t.start[i];
  const int C = L.C;
  const long long off = static_cast<long long>(row) * C;
  const long long n = L.n;
  const bool gb = L.flags & kGradBf16, db = L.flags & kDstBf16;
  const float s = L.s[row];            // read before s' is written below
  const float mask = scale ? *scale : 1.f;
  float r_new[kPerThread];
  float amax = 0.f;     // r' >= 0
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    r_new[k] = 0.f;
    if (j < C) {
      const long long idx = off + j;
      const float g = idx < n ? load1(L.g, idx, gb) : 0.f;
      const float r = __fmul_rn(static_cast<float>(L.q[idx]), s);
      r_new[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(g, g)));
      amax = fmaxf(amax, r_new[k]);
      if (idx < n) {
        float u = __fdiv_rn(__fmul_rn(neg_lr, g), __fadd_rn(r_new[k], eps));
        if (scale) u = __fmul_rn(u, mask);
        if (apply) store1(L.dst, idx, __fadd_rn(load1(L.dst, idx, db), u), db);
        else static_cast<float*>(L.dst)[idx] = u;
      }
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
  if (threadIdx.x == 0) L.s_out[row] = s_new;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < C) {
      const long long idx = off + j;
      float c = floorf(__fadd_rn(__fdiv_rn(r_new[k], s_new), L.noise[idx]));
      c = fminf(fmaxf(c, 0.f), kLevels);
      L.q_out[idx] = static_cast<int8_t>(static_cast<int>(c));
    }
  }
}

}  // namespace

// The table layout, for the Python side's check of its ctypes mirror:
// out[0..4] = sizeof(K7Table), sizeof(K8Table), the capacity, K7's chunk,
// K8's widest row.
extern "C" int fused_adagrad_layout(long long* out) {
  out[0] = sizeof(K7Table);
  out[1] = sizeof(K8Table);
  out[2] = kLeaves;
  out[3] = kChunk;
  out[4] = kMaxCols;
  return 0;
}

// K7 over the leaves of the K7Table at ``table`` (a host struct; the
// launch copies it).  scale: a device fp32 scalar or null; apply: 1 adds
// the update to dst in place, 0 writes it there.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int fused_adagrad(const void* table, const float* scale,
                             float lr, float eps, int apply, void* stream) {
  const K7Table* t = static_cast<const K7Table*>(table);
  if (t->n_leaves <= 0 || t->n_leaves > kLeaves ||
      t->start[t->n_leaves] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_adagrad_kernel<<<t->start[t->n_leaves], kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *t, scale, -lr, eps, apply);
  return static_cast<int>(cudaGetLastError());
}

// K8 over the leaves of the K8Table at ``table``, one block a row; scale
// and apply as for K7.
extern "C" int fused_adagrad_q8(const void* table, const float* scale,
                                float lr, float eps, int apply,
                                void* stream) {
  const K8Table* t = static_cast<const K8Table*>(table);
  if (t->n_leaves <= 0 || t->n_leaves > kLeaves ||
      t->start[t->n_leaves] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // enough threads for four elements each of the widest row, whole warps
  int cols = 0;
  for (int i = 0; i < t->n_leaves; ++i) {
    const int C = t->leaf[i].C;
    if (C <= 0 || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
    cols = C > cols ? C : cols;
  }
  const int threads = ((cols + kPerThread - 1) / kPerThread + 31) / 32 * 32;
  fused_adagrad_q8_kernel<<<t->start[t->n_leaves], threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      *t, scale, -lr, eps, apply);
  return static_cast<int>(cudaGetLastError());
}
