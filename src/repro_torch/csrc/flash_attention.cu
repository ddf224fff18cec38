// Flash attention forward for Hopper (sm_90a).
//
// Replaces
//   K9      src/repro/kernels/flash_attention.py  flash_attention  (_kernel)
//   K9-LSE  src/repro/kernels/flash_attention_bwd.py  _fwd  (_fwd_kernel)
//
// For bf16 or fp32 q, k, v of shape (B, S, H, hd) (KV heads repeated to
// H; hd 64 or 128, the model's head dims, or 32, the reduced model's)
// and every query row i of every (b, h):
//   o_i = sum_j softmax_j(s_ij) v_j,  s_ij = <q_i, k_j> * scale, masked
// where key j is visible when j <= i (causal) and i - j < window
// (window > 0); a masked score is -1e30, as on the TPU.  q and k are
// converted to fp32 before the dot; the running max m, the running sum l
// and the accumulator stay in fp32 (the online-softmax recurrence:
// m' = max(m, max_j s_j), corr = exp(m - m'), l' = l corr + sum_j
// exp(s_j - m'), acc' = acc corr + sum_j exp(s_j - m') v_j), and the
// output acc / max(l, 1e-30) is written in q's dtype.  K9-LSE (the
// training forward) also writes the row's log-sum-exp
// lse_i = m + log(max(l, 1e-30)) in fp32 at (b * H + h) * S + i, the
// residual of the backward (csrc/flash_attention_bwd.cu); with no LSE
// pointer (serving) nothing else changes.
//
// Layout.  One block per (query tile of kBQ = 64 rows, b * H + h); the
// block walks the key tiles of kBK = 32 rows that the mask leaves
// non-empty (those right of the diagonal are skipped when causal, those
// left of the window when window > 0), staging each K and V tile in
// shared memory as fp32.  Each query row is owned by hd / 32 threads
// (2 at hd 32), each holding 32 (16) of its q values and as many of its
// accumulator values in registers; a row's partial dot products meet by
// warp shuffles.  A thread's values are float4 chunks interleaved with
// its row-mates' (chunk c belongs to part c % threads a row), so the
// lanes of a warp read distinct banks or the same word of shared memory.  The
// (B, S, H, hd) operands are read in place (row stride H * hd): no
// transposed copy is made.
//
// Bound: operations.  The two products take 4 * hd flops per visible
// (query, key) pair: 32.2 GFLOP at (1, 4096, 15, 64) causal, against
// 31.5 MB of q, k, v and o.  That is 32.6 us at the bf16 tensor-core
// peak (989 TFLOP/s).  This first version runs both products on the fp32
// cores (67 TFLOP/s peak, so at least 480 us there) to keep the TPU
// kernel's fp32 arithmetic without a tensor-core path; mma / wgmma with
// a bf16 q kᵀ and cp.async / TMA staging are the route to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // key rows per staged tile
// head dims per thread: 32, and 16 at hd 32 (two threads a row)
template <int HD>
__host__ __device__ constexpr int head_part() { return HD == 32 ? 16 : 32; }
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBQ * (HD / head_part<HD>()))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int causal,
                 int window, float scale) {
  constexpr int kPart = head_part<HD>();
  constexpr int kTPR = HD / kPart;          // threads per query row
  constexpr int kThreads = kBQ * kTPR;
  constexpr int kChunks = HD / 4;           // float4 chunks per row
  __shared__ float4 ks[kBK * kChunks];
  __shared__ float4 vs[kBK * kChunks];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  // the heaviest (last) query tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int qpos = q0 + r;

  float qv[kPart], acc[kPart];
  const T* qrow = q + base + qpos * pos_stride;
#pragma unroll
  for (int i = 0; i < kPart / 4; ++i) {
    const float4 x = load4(qrow + 4 * (part + kTPR * i));
    qv[4 * i] = x.x;
    qv[4 * i + 1] = x.y;
    qv[4 * i + 2] = x.z;
    qv[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kPart; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_kb = S / kBK;
  const int hi = causal ? min((q0 + kBQ + kBK - 1) / kBK, n_kb) : n_kb;
  const int lo = window ? max(q0 - window, 0) / kBK : 0;
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks;
      const long long off = base + (kt * kBK + j) * pos_stride + 4 * c;
      ks[idx] = load4(k + off);
      vs[idx] = load4(v + off);
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kPart / 4; ++i) {
        const float4 kk = ks[j * kChunks + part + kTPR * i];
        d += qv[4 * i] * kk.x;
        d += qv[4 * i + 1] * kk.y;
        d += qv[4 * i + 2] * kk.z;
        d += qv[4 * i + 3] * kk.w;
      }
#pragma unroll
      for (int off = 1; off < kTPR; off <<= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      const int dist = qpos - (kt * kBK + j);
      bool vis = true;
      if (causal) vis = dist >= 0;
      if (window) vis = vis && dist < window;
      s[j] = vis ? d * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kPart; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < kPart / 4; ++i) {
        const float4 vv = vs[j * kChunks + part + kTPR * i];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + base + qpos * pos_stride;
#pragma unroll
  for (int i = 0; i < kPart / 4; ++i)
    store4(orow + 4 * (part + kTPR * i),
           make_float4(acc[4 * i] / denom, acc[4 * i + 1] / denom,
                       acc[4 * i + 2] / denom, acc[4 * i + 3] / denom));
  if (lse != nullptr && part == 0)
    lse[static_cast<long long>(bh) * S + qpos] = m + logf(denom);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int H, int causal, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid(S / kBQ, B * H);
  const dim3 block(kBQ * (HD / head_part<HD>()));
  flash_fwd_kernel<T, HD><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int H, int hd, int causal,
             int window, float scale, cudaStream_t st) {
  if (hd == 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, H, causal, window, scale,
                         st);
  if (hd == 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, H, causal, window, scale,
                         st);
  if (hd == 128)
    return launch<T, 128>(q, k, v, o, lse, B, S, H, causal, window, scale,
                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K9 and K9-LSE.  q, k, v, o: contiguous (B, S, H, hd) of one dtype
// (dtype 0 = float32, 1 = bfloat16), 16-byte aligned; hd in {32, 64,
// 128}; S a multiple of 64; window >= 0 (0 = none).  lse: null (K9), or
// (B, H, S) float32 (K9-LSE).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int B, int S, int H, int hd, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % kBQ || window < 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, l, B, S, H, hd, causal, window,
                           scale, st);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, o, l, B, S, H, hd, causal, window,
                          scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
