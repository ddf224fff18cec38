// Flash attention backward for Hopper (sm_90a): the two kernels of the
// FlashAttention-2 scheme.
//
// Replaces
//   K10 dkv  src/repro/kernels/flash_attention_bwd.py  _bwd  (_dkv_kernel)
//   K10 dq   src/repro/kernels/flash_attention_bwd.py  _bwd  (_dq_kernel)
//
// For q, k, v, do of shape (B, S, H, hd) in bf16 or fp32 (KV heads
// repeated to H; hd 64 or 128), the forward's row log-sum-exp lse and
// D = rowsum(do ∘ o), both (B, H, S) fp32, and every visible (query i,
// key j) pair of every (b, h) (j <= i when causal, i - j < window when
// window > 0, the forward's mask):
//   p_ij  = exp(<q_i, k_j> * scale - lse_i)       (0 where masked)
//   ds_ij = p_ij * (<do_i, v_j> - D_i) * scale
//   dv_j  = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
// with the operands converted to fp32 and every sum in fp32, as on the
// TPU; the outputs are written in q's dtype.
//
// Layout.  Both kernels reuse the forward's (csrc/flash_attention.cu):
// a block owns kRows = 64 rows of one (b, h), each row held by hd / 16
// threads with 16 of its values in registers, a row's partial dot
// products meeting by warp shuffles; the other side is staged in
// 32-row tiles in shared memory as fp32 (float4 chunks interleaved so a
// warp's lanes read distinct banks or one word); (B, S, H, hd) is read in
// place.
//   * dkv: one block per (key tile of 64 rows, b * H + h).  Each thread
//     holds its row's k, v and the dk, dv accumulators; the block walks
//     the 32-row query tiles the mask leaves non-empty (from the diagonal
//     on when causal, up to window positions past the tile when
//     windowed), staging q, do, lse and D, and recomputes p per pair.
//     The first key tiles, which most queries see, start first.
//   * dq: one block per (query tile of 64 rows, b * H + h).  Each thread
//     holds its row's q, do and the dq accumulator, lse_i and D_i; the
//     block walks the 32-row key tiles the forward walks, staging k and
//     v.  The last query tiles, which see most keys, start first.
//
// Bound: operations.  The backward's work is five products of 2 * hd
// flops per visible pair (s = q kᵀ, dp = do vᵀ, dv, dk, dq): at
// (1, 4096, 15, 64) causal, 125,859,840 pairs and 80.55 GFLOP, so
// 81.45 us at the bf16 tensor-core peak (989 TFLOP/s), against about
// 63 MB of q, k, v, o, do, dq, dk, dv, lse and D (19 us at 3.35 TB/s).
// This first version recomputes s and dp in both kernels (seven
// products, not five) and runs them all on the fp32 cores (67 TFLOP/s
// peak): it keeps the TPU kernel's fp32 arithmetic and sits far above
// the bound.  Tensor-core products and staged loads (cp.async / TMA) are
// the route to it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // rows a block owns
constexpr int kTile = 32;       // rows of a staged tile
constexpr int kPart = 16;       // head dims per thread
constexpr int kVec = kPart / 4; // float4 chunks per thread

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

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, const float* b) {
  float d = a.x * b[0];
  d += a.y * b[1];
  d += a.z * b[2];
  d += a.w * b[3];
  return d;
}

__device__ __forceinline__ void axpy4(float* acc, float s, float4 x) {
  acc[0] += s * x.x;
  acc[1] += s * x.y;
  acc[2] += s * x.z;
  acc[3] += s * x.w;
}

__device__ __forceinline__ bool visible(int dist, int causal, int window) {
  bool vis = true;
  if (causal) vis = dist >= 0;
  if (window) vis = vis && dist < window;
  return vis;
}

// one row's kPart values of x (chunk i of this thread is chunk
// part + TPR * i of the row) -> registers
template <typename T, int TPR>
__device__ __forceinline__ void load_part(const T* row, int part,
                                          float* out) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 x = load4(row + 4 * (part + TPR * i));
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}

template <typename T, int TPR>
__device__ __forceinline__ void store_part(T* row, int part,
                                           const float* acc) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    store4(row + 4 * (part + TPR * i),
           make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRows * (HD / kPart))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int causal,
                     int window, float scale) {
  constexpr int kTPR = HD / kPart;          // threads per key row
  constexpr int kThreads = kRows * kTPR;
  constexpr int kChunks = HD / 4;           // float4 chunks per row
  __shared__ float4 qs[kTile * kChunks];
  __shared__ float4 dos[kTile * kChunks];
  __shared__ float ls[kTile];
  __shared__ float ds_row[kTile];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const long long row0 = static_cast<long long>(bh) * S;
  const int kpos = k0 + r;

  float kr[kPart], vr[kPart], dka[kPart], dva[kPart];
  load_part<T, kTPR>(k + base + kpos * pos_stride, part, kr);
  load_part<T, kTPR>(v + base + kpos * pos_stride, part, vr);
#pragma unroll
  for (int i = 0; i < kPart; ++i) dka[i] = dva[i] = 0.f;

  const int n_qb = S / kTile;
  const int lo = causal ? k0 / kTile : 0;
  const int hi = window ? min((k0 + kRows + window - 2) / kTile + 1, n_qb)
                        : n_qb;
  for (int qt = lo; qt < hi; ++qt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int i = idx / kChunks, c = idx % kChunks;
      const long long off = base + (qt * kTile + i) * pos_stride + 4 * c;
      qs[idx] = load4(q + off);
      dos[idx] = load4(dout + off);
    }
    for (int i = tid; i < kTile; i += kThreads) {
      ls[i] = lse[row0 + qt * kTile + i];
      ds_row[i] = delta[row0 + qt * kTile + i];
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float4 qq[kVec], dd[kVec];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        qq[c] = qs[i * kChunks + part + kTPR * c];
        dd[c] = dos[i * kChunks + part + kTPR * c];
        s += dot4(qq[c], kr + 4 * c);
        dp += dot4(dd[c], vr + 4 * c);
      }
      s = row_sum<kTPR>(s);
      dp = row_sum<kTPR>(dp);
      const int dist = qt * kTile + i - kpos;
      const float p = visible(dist, causal, window)
                          ? expf(s * scale - ls[i]) : 0.f;
      const float ds = p * (dp - ds_row[i]) * scale;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        axpy4(dva + 4 * c, p, dd[c]);
        axpy4(dka + 4 * c, ds, qq[c]);
      }
    }
  }
  store_part<T, kTPR>(dk + base + kpos * pos_stride, part, dka);
  store_part<T, kTPR>(dv + base + kpos * pos_stride, part, dva);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRows * (HD / kPart))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int causal, int window, float scale) {
  constexpr int kTPR = HD / kPart;          // threads per query row
  constexpr int kThreads = kRows * kTPR;
  constexpr int kChunks = HD / 4;
  __shared__ float4 ks[kTile * kChunks];
  __shared__ float4 vs[kTile * kChunks];

  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  // the heaviest (last) query tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int qpos = q0 + r;
  const float lse_i = lse[static_cast<long long>(bh) * S + qpos];
  const float d_i = delta[static_cast<long long>(bh) * S + qpos];

  float qr[kPart], dor[kPart], dqa[kPart];
  load_part<T, kTPR>(q + base + qpos * pos_stride, part, qr);
  load_part<T, kTPR>(dout + base + qpos * pos_stride, part, dor);
#pragma unroll
  for (int i = 0; i < kPart; ++i) dqa[i] = 0.f;

  const int n_kb = S / kTile;
  const int hi = causal ? min((q0 + kRows + kTile - 1) / kTile, n_kb)
                        : n_kb;
  const int lo = window ? max(q0 - window, 0) / kTile : 0;
  for (int kt = lo; kt < hi; ++kt) {
    __syncthreads();
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = idx % kChunks;
      const long long off = base + (kt * kTile + j) * pos_stride + 4 * c;
      ks[idx] = load4(k + off);
      vs[idx] = load4(v + off);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float4 kk[kVec];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        kk[c] = ks[j * kChunks + part + kTPR * c];
        s += dot4(kk[c], qr + 4 * c);
        dp += dot4(vs[j * kChunks + part + kTPR * c], dor + 4 * c);
      }
      s = row_sum<kTPR>(s);
      dp = row_sum<kTPR>(dp);
      const int dist = qpos - (kt * kTile + j);
      const float p = visible(dist, causal, window)
                          ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - d_i) * scale;
#pragma unroll
      for (int c = 0; c < kVec; ++c) axpy4(dqa + 4 * c, ds, kk[c]);
    }
  }
  store_part<T, kTPR>(dq + base + qpos * pos_stride, part, dqa);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o1, *o2;   // dkv: dk, dv; dq: dq
  int B, S, H, causal, window;
  float scale;
};

template <typename T, int HD>
int launch(bool dkv, const Args& a, cudaStream_t st) {
  const dim3 grid(a.S / kRows, a.B * a.H);
  const dim3 block(kRows * (HD / kPart));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  if (dkv)
    flash_bwd_dkv_kernel<T, HD><<<grid, block, 0, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<T*>(a.o1),
        static_cast<T*>(a.o2), a.S, a.H, a.causal, a.window, a.scale);
  else
    flash_bwd_dq_kernel<T, HD><<<grid, block, 0, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<T*>(a.o1), a.S, a.H,
        a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int run(bool dkv, const Args& a, int hd, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.S % kRows || a.window < 0 ||
      a.B * a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(dkv, a, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(dkv, a, st);
  if (dtype == 1 && hd == 64) return launch<bf16, 64>(dkv, a, st);
  if (dtype == 1 && hd == 128) return launch<bf16, 128>(dkv, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K10 dkv.  q, k, v, dout, dk, dv: contiguous (B, S, H, hd) of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; lse, delta: (B, H, S)
// float32; hd in {64, 128}; S a multiple of 64; window >= 0 (0 = none).
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int H, int hd, int causal,
                                       int window, float scale, int dtype,
                                       void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, S, H, causal,
               window, scale};
  return run(true, a, hd, dtype, stream);
}

// K10 dq.  The operands of flash_attention_bwd_dkv; dq: (B, S, H, hd) in
// their dtype.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int S, int H, int hd,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, S, H,
               causal, window, scale};
  return run(false, a, hd, dtype, stream);
}
