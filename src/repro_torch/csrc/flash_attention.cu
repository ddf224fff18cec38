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
// fp32 (the label party's ad-hoc ∇Z pass): tensor cores too, at fp32
// accuracy, as K10's fp32 kernels (csrc/flash_attention_bwd.cu).  A single
// TF32 or bf16 rounding of an operand, or a two-part bf16 split, would put
// elements of o or lse past chip_smoke.py's fp32 limits (2^-17 |ref| +
// 2e-6 for o, 2^-17 |lse| + 1e-5; modelled on the CPU by
// tests/test_torch_kernels.py::test_k9_f32_split_design).  So every
// operand of both products is split into three bf16 parts, x = x1 + x2 +
// x3 (exact), and each fp32 product is six bf16 products
// (attention_mma.cuh): 12 per visible (query, key) pair and hd.  The
// tensor cores align a product's terms to the accumulator and drop the
// bits below it, so no long sum of big terms runs in one accumulator:
// s = q kᵀ is a small sum (the five small products, chained) and a big
// one (each k-step's q1 k1 summed from zero and added in fp32), added
// before the scale; p = exp2(s - m) is taken from those fp32 values,
// split into three parts from the accumulators (as the bf16 kernel
// splits it in two) and enters p v from registers; each key tile's share
// of o is summed from zero and added in fp32 to acc after acc *= corr.
// m, corr and l stay fp32, l summed from the fp32 p.  The layout is the
// bf16 kernel's (4 warps of 16 query rows, the grid b * H + h fastest,
// the heaviest query tiles first); q is split once per block from device
// memory into three parts in padded shared rows, read by ldmatrix every
// k-step; each K and V tile (f32_tile: 32 rows, 16 at hd 128, so that the
// accumulators, s's two sums and p's parts fit the registers) arrives in
// fp32 by cp.async (the next tile's copy in flight during this tile's
// products) and is split into its parts in shared memory once per block.
// The mask is applied on the tiles that cross the diagonal or the
// window's edge.
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
// In fp32 the work is bound by six bf16 products per product, 164.8
// TFLOP/s (195.5 us at (1, 4096, 15, 64); 481 us at the fp32 cores' 67),
// and the kernel issues twelve bf16 products per pair, 193 GFLOP there;
// besides the above it splits each K and V tile in shared memory, in the
// same warps, between its products.
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
// fp32: tensor cores, every operand in three bf16 parts
// ---------------------------------------------------------------------------
template <int HD>
constexpr int fwd_f32_smem() {
  // q's parts (3 x kM rows), the tile's k and v parts (2 x 3 x f32_tile
  // rows), the next k and v tile in fp32 (2 x f32_tile rows)
  constexpr int n = f32_tile<HD>();
  return 3 * (kM + 2 * n) * row_stride<HD>() * 2 + 2 * n * HD * 4;
}

// the body of flash_fwd_f32mma<HD> (below)
template <int HD>
__device__ __forceinline__ void fwd_f32mma(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           float* __restrict__ o,
                                           float* __restrict__ lse, int S,
                                           int H, int causal, int window,
                                           float scale) {
  constexpr int kN = f32_tile<HD>();   // key rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;         // k-steps of s over hd
  constexpr int kNT = kN / 8;          // n-tiles of s over the key tile
  constexpr int kHeld = kM * kStr;     // one part of q
  constexpr int kWalk = kN * kStr;     // one part of the tile's k or v
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qp = reinterpret_cast<bf16*>(smem);   // q's three parts
  bf16* Kp = Qp + 3 * kHeld;           // the tile's k, three parts
  bf16* Vp = Kp + 3 * kWalk;           // the tile's v, three parts
  float* Kf = reinterpret_cast<float*>(Vp + 3 * kWalk);  // next k, fp32
  float* Vf = Kf + kN * HD;            // next v, fp32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest (last) query tiles of every (b, h) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int r0 = q0 + warp * 16;        // this warp's first query
  const int row = r0 + g;               // this thread's queries: row, row + 8

  const int n_kt = S / kN;
  const int kt1 = causal ? min((q0 + kM + kN - 1) / kN, n_kt) : n_kt;
  const int kt0 = window ? max(q0 - window, 0) / kN : 0;
  auto stage = [=](int kt) {
    const long long off = base + static_cast<long long>(kt) * kN * pos_stride;
    stage_f32<HD>(Kf, k + off, pos_stride, kN, tid);
    stage_f32<HD>(Vf, v + off, pos_stride, kN, tid);
  };
  stage(kt0);
  cp_async_commit();
  split_rows<HD>(Qp, kHeld, q + base + static_cast<long long>(q0) * pos_stride,
                 pos_stride, kM, tid);

  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  const bf16* qw = Qp + warp * 16 * kStr;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows row (index 0) and row + 8 (index 1): the running max (log2
  // units) and this thread's part of the running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const float sl2 = scale * kLog2e;
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    split_rows<HD>(Kp, kWalk, Kf, HD, kN, tid);
    split_rows<HD>(Vp, kWalk, Vf, HD, kN, tid);
    __syncthreads();   // the parts are in place; Kf and Vf are free
    if (kt + 1 < kt1) stage(kt + 1);
    cp_async_commit();

    // s = q kᵀ, 16 queries x kN keys, as a big (q1 k1) and a small sum
    float sb[kNT][4], ss[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[n][e] = ss[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t aq[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(aq[i], qw + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bk[i], Kp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(sb[2 * np + half], ss[2 * np + half], aq, bk, half);
      }
    }

    // the scaled scores into sb, and the mask on the tiles that cross the
    // diagonal or the window's edge for some row of this warp
    const int k0 = kt * kN;
    const bool masked = (causal && k0 + kN - 1 > r0) ||
                        (window && r0 + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sb[n][e] = (sb[n][e] + ss[n][e]) * sl2;
        const int gap = row + 8 * (e >> 1) - k0 - 8 * n - 2 * t - (e & 1);
        if (masked && !visible(gap, causal, window)) sb[n][e] = kNegInf;
      }

    // the online softmax: p into sb (fp32)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mx = fmaxf(mx, fmaxf(sb[n][2 * r], sb[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2_ftz(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_ftz(sb[n][2 * r + c] - mx);
          sb[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // o += p v, p in three parts from the accumulators; per 16 columns
    // the tile's share is summed on its own and then added
    uint32_t pf[kN / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]);
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      float lo[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bv[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4_t(bv[i], Vp + i * kWalk + 16 * kk * kStr + a_off + 16 * j);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6_sum(lo[half], pf[kk], bv, half);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * j + half][e] += lo[half][e];
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
  store_rows_f32<HD>(o + base + static_cast<long long>(r0) * pos_stride,
                     pos_stride, acc, g, t);
  if (lse != nullptr && t == 0) {
    const long long lrow = static_cast<long long>(bh) * S + row;
    lse[lrow] = m[0] / kLog2e + logf(denom[0]);
    lse[lrow + 8] = m[1] / kLog2e + logf(denom[1]);
  }
}

// Declared with no minimum of blocks an SM: at hd 64 and 128 a minimum
// (even of one) lets ptxas take more registers, and runs slower (hd 64:
// 200 registers) or spills (hd 128: 255).  At hd 32, below, declared for
// two: with no minimum ptxas holds it to 128 registers and spills.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32mma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int causal,
                 int window, float scale) {
  fwd_f32mma<HD>(q, k, v, o, lse, S, H, causal, window, scale);
}

template <>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32mma<32>(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int causal,
                     int window, float scale) {
  fwd_f32mma<32>(q, k, v, o, lse, S, H, causal, window, scale);
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
int launch_f32mma(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int causal, int window,
                  float scale, cudaStream_t stream) {
  static bool done[64] = {};
  constexpr int bytes = fwd_f32_smem<HD>();
  const int e = allow_smem(flash_fwd_f32mma<HD>, bytes, done);
  if (e) return e;
  const dim3 grid(B * H, S / kM);
  flash_fwd_f32mma<HD><<<grid, kThreads, bytes, stream>>>(
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
  if (B <= 0 || H <= 0 || S <= 0 || S % kM || window < 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const auto args = [&](auto fn) {
    return fn(q, k, v, o, l, B, S, H, causal, window, scale, st);
  };
  if (dtype == 0 && hd == 32) return args(launch_f32mma<32>);
  if (dtype == 0 && hd == 64) return args(launch_f32mma<64>);
  if (dtype == 0 && hd == 128) return args(launch_f32mma<128>);
  if (dtype == 1 && hd == 32) return args(launch_mma<32>);
  if (dtype == 1 && hd == 64) return args(launch_mma<64>);
  if (dtype == 1 && hd == 128) return args(launch_mma<128>);
  return static_cast<int>(cudaErrorInvalidValue);
}
