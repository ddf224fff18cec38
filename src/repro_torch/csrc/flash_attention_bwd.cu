// Flash attention backward for Hopper (sm_90a): the two kernels of the
// FlashAttention-2 scheme.
//
// Replaces
//   K10 dkv  src/repro/kernels/flash_attention_bwd.py  _bwd  (_dkv_kernel)
//   K10 dq   src/repro/kernels/flash_attention_bwd.py  _bwd  (_dq_kernel)
//
// For q, k, v, do of shape (B, S, H, hd) in bf16 or fp32 (KV heads
// repeated to H; hd 32, 64 or 128), the forward's row log-sum-exp lse and
// D = rowsum(do ∘ o), both (B, H, S) fp32, and every visible (query i,
// key j) pair of every (b, h) (j <= i when causal, i - j < window when
// window > 0, the forward's mask):
//   p_ij  = exp(<q_i, k_j> * scale - lse_i)       (0 where masked)
//   ds_ij = p_ij * (<do_i, v_j> - D_i) * scale
//   dv_j  = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
// with every sum in fp32; the outputs are written in q's dtype.  No
// atomics: dk and dv come from one kernel, dq from another, each output
// element summed by one thread in a fixed order, so a run repeats bitwise.
//
// bf16 (the model's dtype): tensor cores.  Every product is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (attention_mma.cuh,
// shared with the forward): bf16 operands, exact products, fp32
// accumulation.  s = q kᵀ and dp = do vᵀ take the
// bf16 inputs as they are: exact products summed in fp32.  p and ds
// are fp32 intermediates; a product needs them in bf16, and rounded once
// (as FlashAttention-2 does) they put elements of dk, dv and dq up to
// about 100 times past chip_smoke.py's per-element limit of one bf16 ulp
// (modelled on the CPU by tests/test_torch_kernels.py::
// test_k10_rounding_design).  So each is split, x = hi + lo with
// hi = bf16(x) and lo = bf16(x - hi), and enters its product twice:
// dv += p_hi do + p_lo do, and so on.  That keeps about 16 bits of p and
// ds, and every element within the limit.  mma.sync and not wgmma: each
// warp owns 16 rows and feeds p and ds from its own accumulators, as
// registers, into the next products; wgmma's register operand needs a
// warpgroup's 64-row tile and asynchronous fences around it, which a
// later rewrite can take on.
//   * dkv: one block of 4 warps per (key tile of 64 rows, b * H + h);
//     warp w owns keys 16w..16w+15.  The block's k and v sit in shared
//     memory, read into A fragments per tile; dk and dv are fp32
//     accumulators in registers.  The block walks the query tiles the
//     mask leaves non-empty (from the diagonal on when causal, up to
//     window positions past the tile when windowed); per tile
//       sᵀ = k qᵀ, dpᵀ = v doᵀ                          (2 products)
//       pᵀ, dsᵀ in fp32 registers, split into hi + lo
//       dv += pᵀ_hi do + pᵀ_lo do, dk += dsᵀ_hi q + dsᵀ_lo q   (4)
//     The m16n8 accumulator of sᵀ is laid out as the m16k16 A operand,
//     so p and ds go from the accumulators into the next products
//     without shared memory.  Query tiles: 32 rows (64 at hd 32), so
//     that dk, dv, sᵀ and dpᵀ stay in registers without spills, at three
//     blocks an SM up to hd 64.  The first key tiles, which most queries
//     see, start first.
//   * dq: one block of 4 warps per (query tile of 64 rows, b * H + h);
//     q, do (shared memory, and A fragments at hd <= 64), lse_i and D_i
//     are held once; the block walks the 64-row key tiles (32 at hd
//     128) the forward walks; per tile s = q kᵀ, dp = do vᵀ,
//     dq += ds_hi k + ds_lo k (4 products).  The last query tiles, which
//     see most keys, start first.
//   The walked tiles (q and do, or k and v, with lse and D) are staged
//   by cp.async into two shared-memory buffers, the next tile's copy in
//   flight during this tile's products.  Shared rows are padded by 16
//   bytes, so the 8 rows an ldmatrix reads fall in 8 distinct bank
//   groups; operands are read with ldmatrix (A and the "col" B of
//   s = q kᵀ) and ldmatrix.trans (the B of dv, dk, dq, whose rows are the
//   summed index).  (B, S, H, hd) is read in place.
//
// fp32 (the label party's ad-hoc ∇Z pass): tensor cores too, at fp32
// accuracy.  A single TF32 or bf16 rounding of an operand would put
// elements hundreds of times past chip_smoke.py's fp32 limit (2^-17 |ref|
// + 2e-6), and a two-part bf16 split (lo lo dropped) 5-20 times past it
// (tests/test_torch_kernels.py::test_k10_f32_split_design).  So every
// fp32 operand is split into three bf16 parts, x = x1 + x2 + x3 with
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), which is exact
// (8 + 8 + 8 significand bits), and a b is taken as six bf16 products,
// a1 b2 + a2 b1 + a1 b3 + a2 b2 + a3 b1 then a1 b1 (attention_mma.cuh;
// the dropped a2 b3 + a3 b2 + a3 b3 lie below 2^-24 of |a| |b|).  The
// tensor cores' accumulation is not fp32's round to nearest (the terms
// are aligned to the accumulator and the bits below it dropped), so no
// long sum of big terms runs in one accumulator: s and dp are summed as
// a small part and a big one, each k-step's x1 y1 from zero and added in
// fp32, and the two added before the exp; each tile's share of dk, dv or
// dq is summed from zero and then added to the fp32 accumulator.  The
// layouts are the bf16 kernels', with three parts of every operand in
// shared memory; the walked tile arrives as fp32 by cp.async (the next
// one in flight during this tile's products) and is split into its parts
// there once per block, and the held rows are split from device memory
// at the start:
//   * dkv: held k, v (64 keys); walked q, do, lse, D in 32-row tiles (16
//     at hd 128) (sᵀ, then dpᵀ, then dv and dk), so that the
//     accumulators fit the registers; 24 bf16 products per pair.
//   * dq: held q, do (64 queries); walked k, v in 32-row tiles (16 at hd
//     128); 18 bf16 products per pair.
//   Both run the grid with b * H + h fastest, so the heaviest tiles of
//   every (b, h) start first; two blocks an SM up to hd 64 (shared
//   memory and registers), one at hd 128.  chip_variants.py times the
//   tile and register choices and shows what the two sums above prevent.
//
// Bound: operations.  The backward's work is five products of 2 * hd
// flops per visible pair (s, dp, dv, dk, dq): at (1, 4096, 15, 64)
// causal, 125,859,840 pairs and 80.55 GFLOP, so 81.45 us at the bf16
// tensor-core peak (989 TFLOP/s), against about 63 MB of q, k, v, o, do,
// dq, dk, dv, lse and D (19 us at 3.35 TB/s).  The bf16 kernels issue 10
// products, 161.1 GFLOP (dkv 6, dq 4): the split doubles the three
// products on p and ds, and s and dp are computed in both kernels, the
// price of dq without atomics.  The fp32 work at fp32 accuracy is bound
// by six bf16 products per product (about 165 TFLOP/s, 489 us) and the
// fp32 kernels issue 42 (dkv 24, dq 18).  What still holds them back:
// that recompute; mma.sync, which issues from each warp in turn where
// wgmma (a warpgroup's asynchronous 64-row products, B from shared
// memory) keeps the tensor cores fed; the fp32 work between the products
// (exp, the mask, the splits) in the same warps; few blocks of four warps
// an SM (three for bf16 up to hd 64, two for fp32, one for fp32 at hd
// 128), each waiting on its own loads and splits; the masked halves of
// the diagonal tiles, computed and thrown away.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// query rows per tile the dkv kernel walks: 32, so that dk, dv, sᵀ and
// dpᵀ fit 168 registers a thread (three blocks an SM) without spills at hd
// 64 and fit at all at hd 128; 64 at hd 32
template <int HD>
__host__ __device__ constexpr int dkv_tile() { return HD == 32 ? 64 : 32; }

// key rows per tile the dq kernel walks: 64, and 32 at hd 128 (measured
// faster there)
template <int HD>
__host__ __device__ constexpr int dq_tile() { return HD == 128 ? 32 : 64; }

template <int HD>
constexpr int dkv_smem() {
  // k, v; q, do x 2 buffers; lse, D x 2 buffers
  return 2 * kM * row_stride<HD>() * 2 +
         4 * dkv_tile<HD>() * row_stride<HD>() * 2 + 4 * dkv_tile<HD>() * 4;
}

template <int HD>
constexpr int dq_smem() {
  // q, do; k, v x 2 buffers
  return 2 * kM * row_stride<HD>() * 2 +
         4 * dq_tile<HD>() * row_stride<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, int H, int causal,
                  int window, float scale) {
  constexpr int kN = dkv_tile<HD>();   // query rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;         // k-steps of s over hd
  constexpr int kNT = kN / 8;          // n-tiles of s over the query tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kM * kStr;
  bf16* Qs = Vs + kM * kStr;           // 2 buffers
  bf16* Os = Qs + 2 * kN * kStr;       // do, 2 buffers
  float* Ls = reinterpret_cast<float*>(Os + 2 * kN * kStr);  // lse, 2
  float* Dl = Ls + 2 * kN;             // D, 2 buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const long long lrow = static_cast<long long>(bh) * S;  // lse, D of (b, h)

  const int n_qb = S / kN;
  const int lo = causal ? k0 / kN : 0;
  const int hi = window ? min((k0 + kM + window - 2) / kN + 1, n_qb)
                        : n_qb;
  auto stage = [=](int buf, int qt) {
    const long long off = base + static_cast<long long>(qt) * kN * pos_stride;
    stage_rows<HD>(Qs + buf * kN * kStr, q + off, pos_stride, kN, tid);
    stage_rows<HD>(Os + buf * kN * kStr, dout + off, pos_stride, kN, tid);
    for (int i = tid; i < kN; i += kThreads) {
      cp_async4(Ls + buf * kN + i, lse + lrow + qt * kN + i);
      cp_async4(Dl + buf * kN + i, delta + lrow + qt * kN + i);
    }
  };
  const long long koff = base + static_cast<long long>(k0) * pos_stride;
  stage_rows<HD>(Ks, k + koff, pos_stride, kM, tid);
  stage_rows<HD>(Vs, v + koff, pos_stride, kM, tid);
  if (lo < hi) stage(0, lo);
  cp_async_commit();

  // ldmatrix offsets: A (16 rows x 16 columns, row-major) and the
  // transposed B read the same way; the "col" B (n rows x k columns)
  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  const bf16* kw = Ks + warp * 16 * kStr;
  const bf16* vw = Vs + warp * 16 * kStr;

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const float sl2 = scale * kLog2e;
  const int key = k0 + warp * 16 + g;   // this thread's keys: key, key + 8
  for (int qt = lo; qt < hi; ++qt) {
    const int buf = (qt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile qt landed; every warp is done with buf ^ 1
    if (qt + 1 < hi) stage(buf ^ 1, qt + 1);
    cp_async_commit();
    const bf16* qs = Qs + buf * kN * kStr;
    const bf16* os = Os + buf * kN * kStr;
    const float* ls = Ls + buf * kN;
    const float* dl = Dl + buf * kN;

    // sᵀ = k qᵀ and dpᵀ = v doᵀ: 16 keys x kN queries
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, kw + a_off + 16 * ks);
      ldsm_x4(av, vw + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, qs + 16 * np * kStr + b_off + 16 * ks);
        ldsm_x4(bo, os + 16 * np * kStr + b_off + 16 * ks);
        mma(s[2 * np], ak, bq[0], bq[1]);
        mma(s[2 * np + 1], ak, bq[2], bq[3]);
        mma(dp[2 * np], av, bo[0], bo[1]);
        mma(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }

    // pᵀ into s, dsᵀ into dp (fp32)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);
        const int dist = qt * kN + qi - (key + 8 * (e >> 1));
        const float p = visible(dist, causal, window)
                            ? exp2f(s[n][e] * sl2 - ls[qi] * kLog2e)
                            : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[qi]) * scale;
        s[n][e] = p;
      }

    // dv += pᵀ do, dk += dsᵀ q, each operand split into hi + lo
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
      split_frag(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, os + 16 * kk * kStr + a_off + 16 * j);
        ldsm_x4_t(bq, qs + 16 * kk * kStr + a_off + 16 * j);
        mma_split(dva[2 * j], ph, pl, bo[0], bo[1]);
        mma_split(dva[2 * j + 1], ph, pl, bo[2], bo[3]);
        mma_split(dka[2 * j], sh, sl, bq[0], bq[1]);
        mma_split(dka[2 * j + 1], sh, sl, bq[2], bq[3]);
      }
    }
  }
  const long long out = base + static_cast<long long>(k0 + warp * 16) *
                                   pos_stride;
  store_rows<HD>(dk + out, pos_stride, dka, g, t);
  store_rows<HD>(dv + out, pos_stride, dva, g, t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int S, int H, int causal, int window, float scale) {
  constexpr int kN = dq_tile<HD>();    // key rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;
  constexpr int kNT = kN / 8;
  constexpr bool kHold = HD <= 64;     // q, do fragments in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kM * kStr;           // do
  bf16* Ks = Os + kM * kStr;           // 2 buffers
  bf16* Vs = Ks + 2 * kN * kStr;       // 2 buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest (last) query tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int row = q0 + warp * 16 + g;  // this thread's queries: row, row + 8
  const long long lrow = static_cast<long long>(bh) * S + row;
  const float l2[2] = {lse[lrow] * kLog2e, lse[lrow + 8] * kLog2e};
  const float dd[2] = {delta[lrow], delta[lrow + 8]};

  const int n_kb = S / kN;
  const int hi = causal ? min((q0 + kM + kN - 1) / kN, n_kb) : n_kb;
  const int lo = window ? max(q0 - window, 0) / kN : 0;
  auto stage = [=](int buf, int kt) {
    const long long off = base + static_cast<long long>(kt) * kN * pos_stride;
    stage_rows<HD>(Ks + buf * kN * kStr, k + off, pos_stride, kN, tid);
    stage_rows<HD>(Vs + buf * kN * kStr, v + off, pos_stride, kN, tid);
  };
  const long long qoff = base + static_cast<long long>(q0) * pos_stride;
  stage_rows<HD>(Qs, q + qoff, pos_stride, kM, tid);
  stage_rows<HD>(Os, dout + qoff, pos_stride, kM, tid);
  if (lo < hi) stage(0, lo);
  cp_async_commit();

  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  const bf16* qw = Qs + warp * 16 * kStr;
  const bf16* ow = Os + warp * 16 * kStr;
  uint32_t qf[kHold ? kKS : 1][4], of[kHold ? kKS : 1][4];
  if constexpr (kHold) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < (kHold ? kKS : 0); ++ks) {
      ldsm_x4(qf[ks], qw + a_off + 16 * ks);
      ldsm_x4(of[ks], ow + a_off + 16 * ks);
    }
  }

  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const float sl2 = scale * kLog2e;
  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with buf ^ 1
    if (kt + 1 < hi) stage(buf ^ 1, kt + 1);
    cp_async_commit();
    const bf16* kb = Ks + buf * kN * kStr;
    const bf16* vs = Vs + buf * kN * kStr;

    // s = q kᵀ and dp = do vᵀ: 16 queries x kN keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t aq[4], ao[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qf[kHold ? ks : 0][i];
          ao[i] = of[kHold ? ks : 0][i];
        }
      } else {
        ldsm_x4(aq, qw + a_off + 16 * ks);
        ldsm_x4(ao, ow + a_off + 16 * ks);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kb + 16 * np * kStr + b_off + 16 * ks);
        ldsm_x4(bv, vs + 16 * np * kStr + b_off + 16 * ks);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // ds into s (fp32)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int dist = row + 8 * r - (kt * kN + 8 * n + 2 * t + (e & 1));
        const float p = visible(dist, causal, window)
                            ? exp2f(s[n][e] * sl2 - l2[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - dd[r]) * scale;
      }

    // dq += ds k, ds split into hi + lo
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_frag(s[2 * kk], s[2 * kk + 1], sh, sl);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kb + 16 * kk * kStr + a_off + 16 * j);
        mma_split(dqa[2 * j], sh, sl, bk[0], bk[1]);
        mma_split(dqa[2 * j + 1], sh, sl, bk[2], bk[3]);
      }
    }
  }
  store_rows<HD>(dq + base + static_cast<long long>(q0 + warp * 16) *
                                 pos_stride,
                 pos_stride, dqa, g, t);
}

// ---------------------------------------------------------------------------
// fp32: tensor cores, every operand in three bf16 parts
// ---------------------------------------------------------------------------
template <int HD, bool kRowStats>
constexpr int f32_smem() {
  // the held operands' parts (2 x 3 x kM rows), the walked tile's (2 x 3
  // x f32_tile rows), the next walked tile in fp32 (2 x f32_tile rows);
  // with kRowStats lse, D x 2 buffers
  constexpr int n = f32_tile<HD>();
  return 2 * 3 * (kM + n) * row_stride<HD>() * 2 + 2 * n * HD * 4 +
         (kRowStats ? 4 * n * 4 : 0);
}

// declared for two blocks an SM (what its shared memory allows at hd
// 64): with no minimum ptxas caps hd 32 at 168 registers and spills
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_f32mma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int causal,
                     int window, float scale) {
  constexpr int kN = f32_tile<HD>();   // query rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;         // k-steps of s over hd
  constexpr int kNT = kN / 8;          // n-tiles of s over the query tile
  constexpr int kHeld = kM * kStr;     // one part of k or v
  constexpr int kWalk = kN * kStr;     // one part of the tile's q or do
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kp = reinterpret_cast<bf16*>(smem);   // k's three parts
  bf16* Vp = Kp + 3 * kHeld;
  bf16* Qp = Vp + 3 * kHeld;           // the tile's q, three parts
  bf16* Op = Qp + 3 * kWalk;           // the tile's do, three parts
  float* Qf = reinterpret_cast<float*>(Op + 3 * kWalk);  // next q, fp32
  float* Of = Qf + kN * HD;            // next do, fp32
  float* Ls = Of + kN * HD;            // lse, 2 buffers
  float* Dl = Ls + 2 * kN;             // D, 2 buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the first key tiles of every (b, h), which most queries see, start
  // first
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kM;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const float* lse_bh = lse + static_cast<long long>(bh) * S;
  const float* d_bh = delta + static_cast<long long>(bh) * S;

  const int n_qt = S / kN;
  const int qt0 = causal ? k0 / kN : 0;
  const int qt1 = window ? min((k0 + kM + window - 2) / kN + 1, n_qt)
                         : n_qt;
  auto stage = [=](int buf, int qt) {
    const long long off = base + static_cast<long long>(qt) * kN * pos_stride;
    stage_f32<HD>(Qf, q + off, pos_stride, kN, tid);
    stage_f32<HD>(Of, dout + off, pos_stride, kN, tid);
    for (int i = tid; i < kN; i += kThreads) {
      cp_async4(Ls + buf * kN + i, lse_bh + qt * kN + i);
      cp_async4(Dl + buf * kN + i, d_bh + qt * kN + i);
    }
  };
  if (qt0 < qt1) stage(0, qt0);
  cp_async_commit();
  const long long koff = base + static_cast<long long>(k0) * pos_stride;
  split_rows<HD>(Kp, kHeld, k + koff, pos_stride, kM, tid);
  split_rows<HD>(Vp, kHeld, v + koff, pos_stride, kM, tid);

  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  const bf16* kw = Kp + warp * 16 * kStr;
  const bf16* vw = Vp + warp * 16 * kStr;

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int kj = k0 + warp * 16 + g;   // this thread's keys: kj, kj + 8
  for (int qt = qt0; qt < qt1; ++qt) {
    const int buf = (qt - qt0) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile qt landed; every warp is done with qt - 1
    split_rows<HD>(Qp, kWalk, Qf, HD, kN, tid);
    split_rows<HD>(Op, kWalk, Of, HD, kN, tid);
    __syncthreads();   // the parts are in place; Qf and Of are free
    if (qt + 1 < qt1) stage(buf ^ 1, qt + 1);
    cp_async_commit();
    const float* ls = Ls + buf * kN;
    const float* dl = Dl + buf * kN;

    // sᵀ = k qᵀ, then dpᵀ = v doᵀ, 16 keys x kN queries, each as a big
    // (x1 y1) and a small sum
    float sb[kNT][4], ss[kNT][4], pb[kNT][4], ps[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sb[n][e] = ss[n][e] = pb[n][e] = ps[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ak[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(ak[i], kw + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bq[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bq[i], Qp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(sb[2 * np + half], ss[2 * np + half], ak, bq, half);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t av[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(av[i], vw + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bo[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bo[i], Op + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(pb[2 * np + half], ps[2 * np + half], av, bo, half);
      }
    }

    // pᵀ into sb, dsᵀ into pb (fp32)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);
        const int gap = qt * kN + qi - kj - 8 * (e >> 1);
        const float p = visible(gap, causal, window)
                            ? expf((sb[n][e] + ss[n][e]) * scale - ls[qi])
                            : 0.f;
        pb[n][e] = p * ((pb[n][e] + ps[n][e]) - dl[qi]) * scale;
        sb[n][e] = p;
      }

    // dv += pᵀ do, dk += dsᵀ q, p and ds in three parts; each 16 columns'
    // share of the tile is summed on its own and then added
    uint32_t pf[kN / 16][3][4], df[kN / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]);
      split3_frag(pb[2 * kk], pb[2 * kk + 1], df[kk]);
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      float lv[2][4] = {}, lk[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bo[3][4], bq[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ldsm_x4_t(bo[i], Op + i * kWalk + 16 * kk * kStr + a_off + 16 * j);
          ldsm_x4_t(bq[i], Qp + i * kWalk + 16 * kk * kStr + a_off + 16 * j);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mma6_sum(lv[half], pf[kk], bo, half);
          mma6_sum(lk[half], df[kk], bq, half);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[2 * j + half][e] += lv[half][e];
          dka[2 * j + half][e] += lk[half][e];
        }
    }
  }
  const long long out = base + static_cast<long long>(k0 + warp * 16) *
                                   pos_stride;
  store_rows_f32<HD>(dk + out, pos_stride, dka, g, t);
  store_rows_f32<HD>(dv + out, pos_stride, dva, g, t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32mma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int causal, int window, float scale) {
  constexpr int kN = f32_tile<HD>();   // key rows per tile
  constexpr int kStr = row_stride<HD>();
  constexpr int kKS = HD / 16;
  constexpr int kNT = kN / 8;
  constexpr int kHeld = kM * kStr;     // one part of q or do
  constexpr int kWalk = kN * kStr;     // one part of the tile's k or v
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qp = reinterpret_cast<bf16*>(smem);   // q's three parts
  bf16* Op = Qp + 3 * kHeld;           // do's
  bf16* Kp = Op + 3 * kHeld;           // the tile's k, three parts
  bf16* Vp = Kp + 3 * kWalk;           // the tile's v, three parts
  float* Kf = reinterpret_cast<float*>(Vp + 3 * kWalk);  // next k, fp32
  float* Vf = Kf + kN * HD;            // next v, fp32

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the heaviest (last) query tiles of every (b, h) start first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int b = bh / H, h = bh % H;
  const long long pos_stride = static_cast<long long>(H) * HD;
  const long long base = static_cast<long long>(b) * S * pos_stride +
                         static_cast<long long>(h) * HD;
  const int qi = q0 + warp * 16 + g;   // this thread's queries: qi, qi + 8
  const long long at = static_cast<long long>(bh) * S + qi;
  const float lse_q[2] = {lse[at], lse[at + 8]};
  const float d_q[2] = {delta[at], delta[at + 8]};

  const int n_kt = S / kN;
  const int kt1 = causal ? min((q0 + kM + kN - 1) / kN, n_kt) : n_kt;
  const int kt0 = window ? max(q0 - window, 0) / kN : 0;
  auto stage = [=](int kt) {
    const long long off = base + static_cast<long long>(kt) * kN * pos_stride;
    stage_f32<HD>(Kf, k + off, pos_stride, kN, tid);
    stage_f32<HD>(Vf, v + off, pos_stride, kN, tid);
  };
  if (kt0 < kt1) stage(kt0);
  cp_async_commit();
  const long long qoff = base + static_cast<long long>(q0) * pos_stride;
  split_rows<HD>(Qp, kHeld, q + qoff, pos_stride, kM, tid);
  split_rows<HD>(Op, kHeld, dout + qoff, pos_stride, kM, tid);

  const int a_off = (lane & 15) * kStr + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kStr +
                    ((lane >> 3) & 1) * 8;
  const bf16* qw = Qp + warp * 16 * kStr;
  const bf16* ow = Op + warp * 16 * kStr;

  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    split_rows<HD>(Kp, kWalk, Kf, HD, kN, tid);
    split_rows<HD>(Vp, kWalk, Vf, HD, kN, tid);
    __syncthreads();   // the parts are in place; Kf and Vf are free
    if (kt + 1 < kt1) stage(kt + 1);
    cp_async_commit();

    // s = q kᵀ, then dp = do vᵀ, 16 queries x kN keys, each as a big and
    // a small sum
    float sc[kNT][4], sc2[kNT][4], dc[kNT][4], dc2[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] = sc2[n][e] = dc[n][e] = dc2[n][e] = 0.f;
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
          mma6(sc[2 * np + half], sc2[2 * np + half], aq, bk, half);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ao[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(ao[i], ow + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bv[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bv[i], Vp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(dc[2 * np + half], dc2[2 * np + half], ao, bv, half);
      }
    }

    // ds into sc (fp32)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int gap = qi + 8 * r - kt * kN - 8 * n - 2 * t - (e & 1);
        const float p = visible(gap, causal, window)
                            ? expf((sc[n][e] + sc2[n][e]) * scale - lse_q[r])
                            : 0.f;
        sc[n][e] = p * ((dc[n][e] + dc2[n][e]) - d_q[r]) * scale;
      }

    // dq += ds k, ds in three parts; per 16 columns the tile's share is
    // summed on its own and then added
    uint32_t dsf[kN / 16][3][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      split3_frag(sc[2 * kk], sc[2 * kk + 1], dsf[kk]);
    }
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      float lq[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bk[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4_t(bk[i], Kp + i * kWalk + 16 * kk * kStr + a_off + 16 * j);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6_sum(lq[half], dsf[kk], bk, half);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[2 * j + half][e] += lq[half][e];
    }
  }
  store_rows_f32<HD>(dq + base + static_cast<long long>(q0 + warp * 16) *
                                     pos_stride,
                     pos_stride, dqa, g, t);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o1, *o2;   // dkv: dk, dv; dq: dq
  int B, S, H, causal, window;
  float scale;
};

template <int HD>
int launch_mma(bool dkv, const Args& a, cudaStream_t st) {
  static bool dkv_done[64] = {}, dq_done[64] = {};
  const dim3 grid(a.S / kM, a.B * a.H);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* d = static_cast<const bf16*>(a.dout);
  if (dkv) {
    constexpr int bytes = dkv_smem<HD>();
    const int e = allow_smem(flash_bwd_dkv_mma<HD>, bytes, dkv_done);
    if (e) return e;
    flash_bwd_dkv_mma<HD><<<grid, kThreads, bytes, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.o1),
        static_cast<bf16*>(a.o2), a.S, a.H, a.causal, a.window, a.scale);
  } else {
    constexpr int bytes = dq_smem<HD>();
    const int e = allow_smem(flash_bwd_dq_mma<HD>, bytes, dq_done);
    if (e) return e;
    flash_bwd_dq_mma<HD><<<grid, kThreads, bytes, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.o1), a.S, a.H,
        a.causal, a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32mma(bool dkv, const Args& a, cudaStream_t st) {
  static bool dkv_done[64] = {}, dq_done[64] = {};
  const dim3 grid(a.B * a.H, a.S / kM);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  if (dkv) {
    constexpr int bytes = f32_smem<HD, true>();
    const int e = allow_smem(flash_bwd_dkv_f32mma<HD>, bytes, dkv_done);
    if (e) return e;
    flash_bwd_dkv_f32mma<HD><<<grid, kThreads, bytes, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<float*>(a.o1),
        static_cast<float*>(a.o2), a.S, a.H, a.causal, a.window, a.scale);
  } else {
    constexpr int bytes = f32_smem<HD, false>();
    const int e = allow_smem(flash_bwd_dq_f32mma<HD>, bytes, dq_done);
    if (e) return e;
    flash_bwd_dq_f32mma<HD><<<grid, kThreads, bytes, st>>>(
        q, k, v, d, a.lse, a.delta, static_cast<float*>(a.o1), a.S, a.H,
        a.causal, a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(bool dkv, const Args& a, int hd, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.S % kM || a.window < 0 ||
      a.B * a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32) return launch_f32mma<32>(dkv, a, st);
  if (dtype == 0 && hd == 64) return launch_f32mma<64>(dkv, a, st);
  if (dtype == 0 && hd == 128) return launch_f32mma<128>(dkv, a, st);
  if (dtype == 1 && hd == 32) return launch_mma<32>(dkv, a, st);
  if (dtype == 1 && hd == 64) return launch_mma<64>(dkv, a, st);
  if (dtype == 1 && hd == 128) return launch_mma<128>(dkv, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K10 dkv.  q, k, v, dout, dk, dv: contiguous (B, S, H, hd) of one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; lse, delta: (B, H, S)
// float32; hd in {32, 64, 128}; S a multiple of 64; window >= 0 (0 =
// none).  Returns the cudaError_t of the launch.
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
