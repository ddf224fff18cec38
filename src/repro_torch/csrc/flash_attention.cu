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
// (window > 0); a masked score is -1e30, as on the TPU.  The scores, the
// running max m, the running sum l and the accumulator stay in fp32 (the
// online-softmax recurrence: m' = max(m, max_j s_j), corr = exp(m - m'),
// l' = l corr + sum_j exp(s_j - m'), acc' = acc corr + sum_j
// exp(s_j - m') v_j), and the output acc / max(l, 1e-30) is written in
// q's dtype.  K9-LSE (the training forward) also writes the row's
// log-sum-exp lse_i = m + log(max(l, 1e-30)) in fp32 at (b * H + h) * S
// + i, the residual of the backward (csrc/flash_attention_bwd.cu); with
// no LSE pointer (serving) nothing else changes, so K9-LSE's output is
// bitwise K9's.
//
// bf16 (the model's dtype): tensor cores.  Both products are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (attention_mma.cuh):
// bf16 operands, exact products, fp32 accumulation.  s = q kᵀ takes the
// bf16 inputs as they are, so its products are exact and summed in fp32,
// as the TPU kernel's fp32 dot of the converted values is (in another
// order).  p = exp(s - m) is an fp32 intermediate; the product p v needs
// it in bf16, and rounded once (as FlashAttention-2 does) it puts output
// elements 34-70 times past chip_smoke.py's per-element limit of one bf16
// ulp (modelled on the CPU by tests/test_torch_kernels.py::
// test_k9_rounding_design).  So p is split, p = hi + lo with hi = bf16(p)
// and lo = bf16(p - hi), and o += p_hi v + p_lo v: three products where
// the TPU kernel has two.  l is summed from the fp32 p.  The scores are
// taken in log2 units (s * scale * log2 e, exp2), as K10 takes them; a p
// or corr below 2^-126 is flushed to zero (ex2.approx.ftz).
//   Layout: one block of 4 warps per (query tile of 64 rows, b * H + h);
//   warp w owns query rows 16w..16w+15 and holds their q as m16k16 A
//   fragments (ldmatrix, once), their m and l and their fp32 accumulator
//   in registers.  The block walks the key tiles the mask leaves
//   non-empty (up to the diagonal when causal, from window positions back
//   when windowed).  The grid runs b * H + h fastest, so the last query
//   tiles of every (b, h), which see most keys, start first and the
//   causal tail is short.  Each K and V tile (64 rows; 32 at hd 128) is
//   copied by cp.async into one of two shared-memory buffers, the next
//   tile's copy in flight during this tile's products; rows are padded by
//   16 bytes so that ldmatrix is free of bank conflicts.  Per tile and
//   warp:
//     s = q kᵀ                     (B: ldmatrix of the K rows)
//     scale; the mask (on every tile at hd 32 and 64, on the tiles that
//     cross the diagonal or the window's edge at hd 128); the row max
//     over the 4 lanes of a quad; corr, p = exp2(s - m'), l,
//     acc *= corr, all in fp32 registers
//     o += p_hi v + p_lo v         (B: ldmatrix.trans of the V rows)
//   The m16n8 accumulators of s are laid out as the m16k16 A operand, so
//   p goes from registers into p v without shared memory.  (B, S, H, hd)
//   is read in place.  mma.sync and not wgmma + TMA: p enters p v from
//   the warp's own accumulators, 16 rows a warp; wgmma takes a register
//   A operand only as a warpgroup's 64-row tile, with asynchronous fences
//   around each product and a producer warp feeding TMA copies through
//   mbarriers, which is a later rewrite (of K10 too).
//
// fp32 (the label party's ad-hoc ∇Z pass): the fp32 cores, as on the TPU
// (TF32 would change its numbers).  One block per (query tile of kBQ = 64
// rows, b * H + h) walks key tiles of kBK = 32 rows staged in shared
// memory as fp32.  Each query row is owned by hd / 32 threads (2 at hd
// 32), each holding 32 (16) of its q values and as many of its
// accumulator values in registers; a row's partial dot products meet by
// warp shuffles.  A thread's values are float4 chunks interleaved with
// its row-mates' (chunk c belongs to part c % threads a row), so the
// lanes of a warp read distinct banks or the same word of shared memory.
//
// Bound: operations.  The two products take 4 * hd flops per visible
// (query, key) pair: 32.2 GFLOP at (1, 4096, 15, 64) causal, against
// 31.5 MB of q, k, v and o (9.4 us at 3.35 TB/s).  That is 32.6 us at the
// bf16 tensor-core peak (989 TFLOP/s).  The bf16 kernel issues three
// products, 48.3 GFLOP, over the visible pairs, and the masked halves of
// the diagonal tiles besides.  What still holds it back: mma.sync, which
// issues from each warp in turn where wgmma keeps the tensor cores fed;
// the split's third product; the fp32 work between the products (exp2,
// the mask, the max over a quad, the rescale, the split) in the same
// warps, with no second warpgroup to overlap it; four warps a block,
// each waiting on the block's loads; the causal tiles' uneven lengths.
// The fp32 kernel runs on the fp32 cores (67 TFLOP/s peak, so at least
// 480 us there).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// key rows per tile: 64, and 32 at hd 128 (measured faster there); a
// divisor of 64, so that S % 64 == 0 leaves no partial tile
template <int HD>
__host__ __device__ constexpr int fwd_tile() { return HD == 128 ? 32 : 64; }

template <int HD>
constexpr int fwd_smem() {
  // q; k, v x 2 buffers
  return kM * row_stride<HD>() * 2 + 4 * fwd_tile<HD>() * row_stride<HD>() * 2;
}

// 2^x, flushing a result below 2^-126 to zero: such a p or corr is under
// an fp32 ulp of the row's largest term, which is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int S, int H, int causal, int window,
              float scale) {
  constexpr int kN = fwd_tile<HD>();    // key rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;          // k-steps of s over hd
  constexpr int kNT = kN / 8;           // n-tiles of s over the key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kM * kStr;            // 2 buffers
  bf16* Vs = Ks + 2 * kN * kStr;        // 2 buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest (last) query tiles of every (b, h) start first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int r0 = q0 + warp * 16;        // this warp's first query
  const int row = r0 + g;               // this thread's queries: row, row + 8

  const int n_kb = S / kN;
  const int hi = causal ? min((q0 + kM + kN - 1) / kN, n_kb) : n_kb;
  const int lo = window ? max(q0 - window, 0) / kN : 0;
  auto stage = [=](int buf, int kt) {
    const long long off = base + static_cast<long long>(kt) * kN * pos_stride;
    stage_rows<HD>(Ks + buf * kN * kStr, k + off, pos_stride, kN, tid);
    stage_rows<HD>(Vs + buf * kN * kStr, v + off, pos_stride, kN, tid);
  };
  stage_rows<HD>(Qs, q + base + static_cast<long long>(q0) * pos_stride,
                 pos_stride, kM, tid);
  stage(0, lo);
  cp_async_commit();

  // ldmatrix offsets: A (16 rows x 16 columns, row-major) and the
  // transposed B read the same way; the "col" B (n rows x k columns)
  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  uint32_t qf[kKS][4];
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    ldsm_x4(qf[ks], Qs + warp * 16 * kStr + a_off + 16 * ks);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows row (index 0) and row + 8 (index 1): the running max (log2
  // units) and this thread's part of the running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const float sl2 = scale * kLog2e;
  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with buf ^ 1
    if (kt + 1 < hi) stage(buf ^ 1, kt + 1);
    cp_async_commit();
    const bf16* kb = Ks + buf * kN * kStr;
    const bf16* vb = Vs + buf * kN * kStr;

    // s = q kᵀ: 16 queries x kN keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + 16 * np * kStr + b_off + 16 * ks);
        mma(s[2 * np], qf[ks], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }

    // scaled scores and the mask: at hd 32 and 64 on every tile
    // (measured faster there than a branch), at hd 128 on the tiles that
    // cross the diagonal or the window's edge for some row of this warp
    // (on every tile it spills there)
    const int k0 = kt * kN;
    const bool masked = HD < 128 || (causal && k0 + kN - 1 > r0) ||
                        (window && r0 + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= sl2;
        if (masked) {
          const int dist = row + 8 * (e >> 1) - (k0 + 8 * n + 2 * t + (e & 1));
          bool vis = !causal || dist >= 0;
          vis = vis && (!window || dist < window);
          if (!vis) s[n][e] = kNegInf;
        }
      }

    // the online softmax: p into s (fp32)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2_ftz(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_ftz(s[n][2 * r + c] - mx);
          s[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // o += p v, p split into hi + lo
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + 16 * kk * kStr + a_off + 16 * j);
        mma_split(acc[2 * j], ph, pl, bv[0], bv[1]);
        mma_split(acc[2 * j + 1], ph, pl, bv[2], bv[3]);
      }
    }
  }

  // the row sums meet over the quad; o = acc / max(l, 1e-30)
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= denom[e >> 1];
  store_rows<HD>(o + base + static_cast<long long>(r0) * pos_stride,
                 pos_stride, acc, g, t);
  if (lse != nullptr && t == 0) {
    const long long lrow = static_cast<long long>(bh) * S + row;
    lse[lrow] = m[0] / kLog2e + logf(denom[0]);
    lse[lrow + 8] = m[1] / kLog2e + logf(denom[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: the fp32 cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // key rows per staged tile
// head dims per thread: 32, and 16 at hd 32 (two threads a row)
template <int HD>
__host__ __device__ constexpr int head_part() { return HD == 32 ? 16 : 32; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int causal, int window,
               float scale, cudaStream_t stream) {
  static bool done[64] = {};
  constexpr int bytes = fwd_smem<HD>();
  const int e = allow_smem(flash_fwd_mma<HD>, bytes, done);
  if (e) return e;
  const dim3 grid(B * H, S / kM);
  flash_fwd_mma<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int causal, int window,
               float scale, cudaStream_t stream) {
  const dim3 grid(S / kBQ, B * H);
  const dim3 block(kBQ * (HD / head_part<HD>()));
  flash_fwd_kernel<float, HD><<<grid, block, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
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
  const auto args = [&](auto fn) {
    return fn(q, k, v, o, l, B, S, H, causal, window, scale, st);
  };
  if (dtype == 0 && hd == 32) return args(launch_f32<32>);
  if (dtype == 0 && hd == 64) return args(launch_f32<64>);
  if (dtype == 0 && hd == 128) return args(launch_f32<128>);
  if (dtype == 1 && hd == 32) return args(launch_mma<32>);
  if (dtype == 1 && hd == 64) return args(launch_mma<64>);
  if (dtype == 1 && hd == 128) return args(launch_mma<128>);
  return static_cast<int>(cudaErrorInvalidValue);
}
