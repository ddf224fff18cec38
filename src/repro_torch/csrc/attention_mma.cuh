// Device helpers of the tensor-core attention kernels
// (flash_attention.cu: K9 / K9-LSE; flash_attention_bwd.cu: K10):
// cp.async staging into padded shared rows, ldmatrix, the
// m16n8k16 bf16 mma with fp32 accumulation, the bf16 hi + lo split of
// an fp32 operand that enters a product from the accumulators, and the
// three-part bf16 split with its six products, which the fp32 kernels
// (K9 / K9-LSE's and K10's) take for an fp32-accurate product, with the
// fp32 tiles they stage by cp.async and split into parts in shared memory.
//
// Every kernel that includes this runs blocks of kWarps warps, warp w
// owning rows 16w..16w+15 of the block's tile of kM rows.  Only the *.cu
// files are compiled; each includes this header, so the build's hash
// covers it too (kernels/_cuda.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kM = 16 * kWarps;     // rows a block owns, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory row of hd bf16 values, padded by 16 bytes
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each, row l / 4, columns 2 (l % 4) + {0, 1}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, transposed: lane l receives rows 2 (l % 4) + {0, 1}, column
// l / 4 of each matrix
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi), packed as a b32
// register of an A fragment (x in the low half)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// two m16n8 accumulators (columns 0-7, 8-15) -> the m16k16 A fragment
// of the same 16x16 values, as hi and lo halves
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// d += (hi + lo) b: the split operand's two products
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          uint32_t b0, uint32_t b1) {
  mma(d, hi, b0, b1);
  mma(d, lo, b0, b1);
}

// (x, y) -> three bf16 parts, x = x1 + x2 + x3 with x1 = bf16(x),
// x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), packed as b32 registers (x
// in the low half).  Both differences are exact in fp32 and the three
// parts' 8 + 8 + 8 significand bits hold fp32's 24, so the sum is x.
__device__ __forceinline__ void split3(float x, float y, uint32_t& p1,
                                       uint32_t& p2, uint32_t& p3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x, y);
  const float2 f1 = __bfloat1622float2(h1);
  const float rx = x - f1.x, ry = y - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(h2);
  p1 = bits(h1);
  p2 = bits(h2);
  p3 = bits(__floats2bfloat162_rn(rx - f2.x, ry - f2.y));
}

// two m16n8 accumulators (columns 0-7, 8-15) -> the m16k16 A fragment
// of the same 16x16 values, as three parts p[0] + p[1] + p[2]
__device__ __forceinline__ void split3_frag(const float (&c0)[4],
                                            const float (&c1)[4],
                                            uint32_t (&p)[3][4]) {
  split3(c0[0], c0[1], p[0][0], p[1][0], p[2][0]);
  split3(c0[2], c0[3], p[0][1], p[1][1], p[2][1]);
  split3(c1[0], c1[1], p[0][2], p[1][2], p[2][2]);
  split3(c1[2], c1[3], p[0][3], p[1][3], p[2][3]);
}

// The six products of a b with a and b in three parts (a2 b3, a3 b2 and
// a3 b3, below 2^-24 of |a| |b|, are dropped).  a: A fragments; b: the
// parts' B registers of an x4 ldmatrix, of which n-tile `half` (0 or 1)
// is taken.  The tensor cores align a product's terms to the accumulator
// and drop the bits below it, so the big term a1 b1 is kept out of long
// chains.
//   small += a1 b2 + a2 b1 + a1 b3 + a2 b2 + a3 b1
__device__ __forceinline__ void mma5_small(float (&small)[4],
                                           const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[3][4],
                                           int half) {
  const int i = 2 * half;
  mma(small, a[0], b[1][i], b[1][i + 1]);
  mma(small, a[1], b[0][i], b[0][i + 1]);
  mma(small, a[0], b[2][i], b[2][i + 1]);
  mma(small, a[1], b[1][i], b[1][i + 1]);
  mma(small, a[2], b[0][i], b[0][i + 1]);
}

//   small += the five small products; big += a1 b1, summed from zero and
//   added in fp32 (for sums over many k-steps)
__device__ __forceinline__ void mma6(float (&big)[4], float (&small)[4],
                                     const uint32_t (&a)[3][4],
                                     const uint32_t (&b)[3][4], int half) {
  mma5_small(small, a, b, half);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a[0], b[0][2 * half], b[0][2 * half + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += t[e];
}

//   acc += a b, all six products in acc, the small ones first (for a
//   tile's share of an output, summed from zero)
__device__ __forceinline__ void mma6_sum(float (&acc)[4],
                                         const uint32_t (&a)[3][4],
                                         const uint32_t (&b)[3][4],
                                         int half) {
  mma5_small(acc, a, b, half);
  mma(acc, a[0], b[0][2 * half], b[0][2 * half + 1]);
}

// the 16-byte chunks of `rows` rows of hd bf16 values from (B, S, H, hd)
// into padded shared rows
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long pos_stride, int rows,
                                           int tid) {
  constexpr int kChunks = HD / 8;
  for (int idx = tid; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(dst + r * row_stride<HD>() + 8 * c,
               src + r * pos_stride + 8 * c);
  }
}

// one accumulator tile (16 rows of this warp x hd) -> (B, S, H, hd) bf16
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long pos_stride,
                                           const float (&acc)[HD / 8][4],
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(
          dst + (g + 8 * half) * pos_stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
}

// key j visible to query i at dist = i - j: the causal mask (j <= i) and
// the window (i - j < window), each when set
__device__ __forceinline__ bool visible(int dist, int causal, int window) {
  bool vis = true;
  if (causal) vis = dist >= 0;
  if (window) vis = vis && dist < window;
  return vis;
}

// rows per tile the fp32 kernels walk (keys in the forward and in K10's
// dq, queries in its dkv): 32, and 16 at hd 128, so that the
// accumulators, s (and dp) as a big and a small sum and the parts of p
// (and ds) fit the registers without spills
template <int HD>
__host__ __device__ constexpr int f32_tile() { return HD == 128 ? 16 : 32; }

// the 16-byte chunks of `rows` fp32 rows of (B, S, H, hd) into shared
// rows of hd floats
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long pos_stride, int rows,
                                          int tid) {
  constexpr int kChunks = HD / 4;
  for (int idx = tid; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(dst + r * HD + 4 * c, src + r * pos_stride + 4 * c);
  }
}

// `rows` fp32 rows of hd values (global or shared, `stride` floats apart)
// -> their three bf16 parts in padded shared rows, part i at dst + i * part
template <int HD>
__device__ __forceinline__ void split_rows(bf16* dst, int part,
                                           const float* src, long long stride,
                                           int rows, int tid) {
  constexpr int kChunks = HD / 4;
  for (int idx = tid; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const float4 x = *reinterpret_cast<const float4*>(src + r * stride + 4 * c);
    uint32_t xy[3], zw[3];
    split3(x.x, x.y, xy[0], xy[1], xy[2]);
    split3(x.z, x.w, zw[0], zw[1], zw[2]);
    bf16* d = dst + r * row_stride<HD>() + 4 * c;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      *reinterpret_cast<uint2*>(d + i * part) = make_uint2(xy[i], zw[i]);
  }
}

// one accumulator tile (16 rows of this warp x hd) -> (B, S, H, hd) fp32
template <int HD>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               long long pos_stride,
                                               const float (&acc)[HD / 8][4],
                                               int g, int t) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(dst + (g + 8 * half) * pos_stride + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
}

// a kernel's dynamic shared memory above the default 48 KB: allowed once
// per device before its first launch there
template <typename K>
int allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

}  // namespace attn
