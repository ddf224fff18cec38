// Algorithm-2 cosine gate for Hopper (sm_90a): one kernel, templated on
// how a ring row is stored, for five of the TPU's Pallas entry points;
// and the ring-slot dequantiser over the same int8 / int4 row codecs for
// two more.
//
// Replaces
//   K1  src/repro/kernels/fused_sample.py  fused_sample_2d     (_kernel_f32)
//   K2a src/repro/kernels/cosine_weight.py cosine_weight_2d    (_kernel)
//   K2b src/repro/kernels/cosine_weight.py cosine_weights_2d   (_kernel_weights_only)
//   K4  src/repro/kernels/fused_sample.py  fused_sample_q8_2d  (_kernel_q8)
//   K5  src/repro/kernels/fused_sample.py  fused_sample_q4_2d  (_kernel_q4)
//   K6  src/repro/kernels/fused_sample.py  fused_dequant_q8_2d (_kernel_dq8)
//   K11 src/repro/kernels/fused_sample.py  fused_dequant_q4_2d (_kernel_dq4)
//
// For every row r of the (B, F) operands:
//   w[r]   = <a_r, z_r> / max(sqrt(|a_r|^2 * |z_r|^2), 1e-12), then 0 below thresh
//   cot[r] = w[r] * dz_r                                       (fp32 out)
// where z and dz are either materialised (B, F) rows (K2: slot == nullptr)
// or slot *slot of a (n_slots, B, F) ring (K1, K4, K5).  The slot is read
// from device memory by the kernel itself, so the caller never syncs to
// learn it (the TPU kernel took it as a scalar-prefetch operand).
// dz == nullptr selects weights only (K2b, and the ring kernels as Party B
// calls them).
//
// Ring codecs (the Codec template argument):
//   Dense<float>, Dense<bf16>  rows as they are (K1, K2);
//   Q8   int8 codes and one fp32 scale per row: z = q * s          (K4);
//   Q4   two int4 codes per byte, element 2j in the low nibble and
//        2j + 1 in the high, each stored as code + 8, and one fp32
//        scale per row: z = ((b & 0xF) - 8) * s, ((b >> 4) - 8) * s (K5).
// Dequantisation happens element by element in registers, in the
// reference's order (code to float, times the row scale), and feeds the
// same three dot products; no dequantised copy of the ring exists.
//
// Bound: bytes.  The gate does about 7 flops per element against 4-16
// bytes moved, far below the card's flop-per-byte ridge, so the least
// time is (bytes read once + bytes written once) / 3.35 TB/s.  The design
// reads each operand once with 16-byte loads (4 fp32, 8 bf16, 16 int8 or
// 32 int4 codes a thread) and keeps the three dot products in registers;
// an F or a pointer that does not allow 16-byte loads takes the
// one-element-a-lane variant.  Two paths:
//   * narrow (many rows, or narrow rows: the paper's B = F = 256): one
//     warp owns one row, sweeps F in chunks of 32 * kVec elements,
//     reduces with warp shuffles, then sweeps dz a second time for the
//     cotangent; ceil(B / 4) blocks of four warps.
//   * split-row (few rows of a wide F: the LLM cut tensor, B = 2 rows of
//     S * d = 3,932,160): ceil(B / 4) blocks would leave most of the
//     card's 132 SMs idle (two warps in all at B = 2), so each row is cut
//     into `chunks` chunks of whole vectors, one block of 256 threads a
//     (chunk, row), in two launches.  Pass 1 sums num, aa and zz over the
//     chunk (each thread as a lane of the narrow path, then the block)
//     and writes the (B, chunks, 3) fp32 partials into a workspace the
//     caller allocates; pass 2 reduces a row's partials in one fixed
//     order in every block of the row (the 256 threads, then the
//     block), so all find the same w, and
//     writes w (block 0) and its chunk of cot = w * dz (weights only:
//     the chunk-0 blocks, w alone).  Each operand byte is still read
//     once.  No atomics, so a run repeats bitwise.  The caller's rule
//     (kernels/cosine_weight.py::gate_chunks, chosen by measurement,
//     chip_variants.py) picks the split when ceil(B / 4) < 132 and F >=
//     2 * 4,096, with chunks of about 4,096 elements (at the LLM cut
//     tensor 960 a row, 1,920 blocks a pass: about 15 an SM, so the
//     SMs' shares differ by one block in fifteen).
// At the LLM cut tensor (W, B, F) = (2, 2, 3,932,160) over a bf16 ring
// the bytes are 94.4 MB: 28.2 us.
//
// The job axis (the fleet's vmap rule, kernels/jobs.py): one launch runs
// n_jobs gates, the grid's last axis over the jobs ((ceil(B / 4), n_jobs)
// narrow, (chunks, B, n_jobs) split-row).  Every operand, the slot and the
// threshold carry a job stride in elements; a stride of 0 is one operand
// that every job shares, read in place.  The outputs and the workspace
// are the jobs' own, contiguous.  A job's threshold is read through a
// pointer (the scalar call keeps its by-value float: no host-to-device
// copy a local step).  The per-job arithmetic is the one-job launch's,
// so job n of a batched launch is bitwise that job's one-job launch.
//
// K6 / K11 (ring_dequant) gather ring slot *slot of an int8 or packed
// int4 ring and write it dequantised, (B, F) fp32: the serving engine's
// read of the decode activation ring.  Each element is the codec's
// code * row scale, one multiply, so the kernel is bitwise its plain
// version.  Bound: bytes (the slot's codes and scales read, F fp32 per
// row written, no arithmetic to speak of), and the output is 4x to 8x
// the codes, so the stores are what to get right: each thread decodes
// four elements (4 int8 codes, 4 bytes, or 4 int4 codes, 2 bytes, in)
// and writes them as one float4, neighbouring lanes on neighbouring 16
// bytes, so a warp's store covers 512 contiguous bytes (a thread that
// wrote a whole codec vector, 64 or 128 bytes, made each warp store
// touch 32 lines).  At the serving shape (W = 4, C = 8, F = 960) that is
// 1,920 threads in 8 blocks; the slot is 38 KB, 11 ns of bytes, so the
// launch itself is the cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = p[i];
  }
}

template <int kVec>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (kVec % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kVec / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        out[8 * i + 2 * k] = f.x;
        out[8 * i + 2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = __bfloat162float(p[i]);
  }
}

template <int kVec>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = v[i];
  }
}

// A ring codec says how many storage units a row of F elements takes and
// how elements [j, j + kVec) of a row come back as fp32.
template <typename T>
struct Dense {
  using Elem = T;
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr bool kScaled = false;
  __host__ __device__ static long long units(int F) { return F; }
  template <int V>
  __device__ static void load(const Elem* row, int j, float, float* out) {
    load_f32<V>(row + j, out);
  }
};

struct Q8 {
  using Elem = int8_t;
  static constexpr int kVec = 16;
  static constexpr bool kScaled = true;
  __host__ __device__ static long long units(int F) { return F; }
  template <int V>
  __device__ static void load(const Elem* row, int j, float s, float* out) {
    if constexpr (V == 16) {
      const int4 v = *reinterpret_cast<const int4*>(row + j);
      const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) out[k] = static_cast<float>(c[k]) * s;
    } else if constexpr (V == 4) {
      const char4 c = *reinterpret_cast<const char4*>(row + j);
      out[0] = static_cast<float>(c.x) * s;
      out[1] = static_cast<float>(c.y) * s;
      out[2] = static_cast<float>(c.z) * s;
      out[3] = static_cast<float>(c.w) * s;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = static_cast<float>(row[j + k]) * s;
    }
  }
};

struct Q4 {
  using Elem = uint8_t;
  static constexpr int kVec = 32;
  static constexpr bool kScaled = true;
  __host__ __device__ static long long units(int F) { return F / 2; }
  __device__ static float code(uint8_t b, int hi) {
    return static_cast<float>(static_cast<int>(hi ? (b >> 4) : (b & 0xF)) - 8);
  }
  template <int V>
  __device__ static void load(const Elem* row, int j, float s, float* out) {
    if constexpr (V == 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j / 2);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        out[2 * k] = code(b[k], 0) * s;
        out[2 * k + 1] = code(b[k], 1) * s;
      }
    } else if constexpr (V == 4) {
      const uchar2 b = *reinterpret_cast<const uchar2*>(row + j / 2);
      out[0] = code(b.x, 0) * s;
      out[1] = code(b.x, 1) * s;
      out[2] = code(b.y, 0) * s;
      out[3] = code(b.y, 1) * s;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = j + k;
        out[k] = code(row[e >> 1], e & 1) * s;
      }
    }
  }
};

// The operands of one gate call: a job-batched call (the fleet's vmap
// rule) runs n_jobs jobs in one launch, the grid's last axis over the
// jobs.  Operand x of job n starts at x + n * js_x elements; a job stride
// of 0 is one operand that every job shares (vmap left it unbatched),
// read in place, never expanded or copied.  The outputs are the jobs'
// own: w (n_jobs, B), cot (n_jobs, B, F) and the workspace
// (n_jobs, B, chunks, 3), each contiguous.  thr, when not null, holds
// the jobs' thresholds (stride js_thr) and replaces the by-value thresh
// (the scalar call passes thresh by value: no host-to-device copy).
template <class C>
struct GateArgs {
  using Elem = typename C::Elem;
  const int* slot;
  int n_slots;
  const float* a;
  const Elem* z;
  const float* zs;
  const Elem* dz;
  const float* dzs;
  float* w;
  float* cot;
  float* part;
  int B, F, chunks;
  float thresh;
  const float* thr;
  long long js_slot, js_a, js_z, js_zs, js_dz, js_dzs, js_thr;
};

// the operands of job `job`: every pointer moved by its job stride (64-bit
// offsets), and the job's threshold
template <class C>
__device__ __forceinline__ GateArgs<C> for_job(GateArgs<C> g, long long job) {
  if (g.slot != nullptr) g.slot += job * g.js_slot;
  g.a += job * g.js_a;
  g.z += job * g.js_z;
  if (g.zs != nullptr) g.zs += job * g.js_zs;
  if (g.dz != nullptr) g.dz += job * g.js_dz;
  if (g.dzs != nullptr) g.dzs += job * g.js_dzs;
  g.w += job * g.B;
  if (g.cot != nullptr) g.cot += job * static_cast<long long>(g.B) * g.F;
  if (g.part != nullptr)
    g.part += job * static_cast<long long>(g.B) * g.chunks * 3;
  if (g.thr != nullptr) g.thresh = __ldg(g.thr + job * g.js_thr);
  return g;
}

// the ring row's index among the ring's (slot, row)s: row itself for
// materialised rows (slot == nullptr), else in slot *slot, read from
// device memory; a slot outside the ring traps
__device__ __forceinline__ long long ring_row(const int* __restrict__ slot,
                                              int n_slots, int row, int B) {
  long long srow = row;
  if (slot != nullptr) {
    const int s = __ldg(slot);
    if (s < 0 || s >= n_slots) __trap();  // a slot outside the ring
    srow += static_cast<long long>(s) * B;
  }
  return srow;
}

// num += <a, z>, aa += |a|^2, zz += |z|^2 over elements [j, j + kVec) of
// a row: the kVec products are summed apart before they join the running
// sums, so that at a wide F a thread's long sequential sums take one term
// per vector and do not drift from the plain version's
template <class C, int kVec>
__device__ __forceinline__ void gate_sums(const float* ar,
                                          const typename C::Elem* zr,
                                          float zscale, int j, float& num,
                                          float& aa, float& zz) {
  float av[kVec], zv[kVec];
  load_f32<kVec>(ar + j, av);
  C::template load<kVec>(zr, j, zscale, zv);
  float pn = 0.f, pa = 0.f, pz = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    pn += av[k] * zv[k];
    pa += av[k] * av[k];
    pz += zv[k] * zv[k];
  }
  num += pn;
  aa += pa;
  zz += pz;
}

// the product goes under the sqrt, as in the reference; 0 below thresh
__device__ __forceinline__ float gate_weight(float num, float aa, float zz,
                                             float thresh) {
  const float w = num / fmaxf(sqrtf(aa * zz), kEps);
  return (w < thresh) ? 0.f : w;
}

// cot[j, j + kVec) = w * dz[j, j + kVec)
template <class C, int kVec>
__device__ __forceinline__ void gate_scale(const typename C::Elem* dr,
                                           float dscale, float w, int j,
                                           float* cr) {
  float dv[kVec];
  C::template load<kVec>(dr, j, dscale, dv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) dv[k] *= w;
  store_f32<kVec>(cr + j, dv);
}

// The narrow path: one warp per row, grid (ceil(B / 4), n_jobs).  kVec
// elements per lane per chunk; the host picks kVec > 1 only when F, every
// base pointer and every job stride allow aligned 16-byte accesses.  zs /
// dzs are the per-row scales of a scaled codec (indexed like the ring's
// rows).
template <class C, int kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cosine_gate_kernel(const GateArgs<C> args) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= args.B) return;  // whole warp leaves together: shuffles stay full
  const GateArgs<C> g = for_job(args, blockIdx.y);
  const int B = g.B, F = g.F;
  const long long row_units = C::units(F);
  const long long srow = ring_row(g.slot, g.n_slots, row, B);
  const float* ar = g.a + static_cast<long long>(row) * F;
  const typename C::Elem* zr = g.z + srow * row_units;
  const float zscale = C::kScaled ? __ldg(g.zs + srow) : 1.f;

  float num = 0.f, aa = 0.f, zz = 0.f;
  for (int j = lane * kVec; j < F; j += 32 * kVec)
    gate_sums<C, kVec>(ar, zr, zscale, j, num, aa, zz);
  const float w = gate_weight(warp_sum(num), warp_sum(aa), warp_sum(zz),
                              g.thresh);
  if (lane == 0) g.w[row] = w;
  if (g.dz == nullptr) return;

  const typename C::Elem* dr = g.dz + srow * row_units;
  const float dscale = C::kScaled ? __ldg(g.dzs + srow) : 1.f;
  float* cr = g.cot + static_cast<long long>(row) * F;
  for (int j = lane * kVec; j < F; j += 32 * kVec)
    gate_scale<C, kVec>(dr, dscale, w, j, cr);
}

// The split-row path, for few rows of a wide F: each row is cut into
// `chunks` chunks of whole vectors, one block of kSplitThreads threads a
// (chunk, row, job).  Chunk c of a row of n vectors holds vectors
// [c * per, min(n, (c + 1) * per)), per = ceil(n / chunks).
constexpr int kSplitThreads = 256;

__device__ __forceinline__ void chunk_range(int F, int kVec, int chunks,
                                            int c, int& j0, int& j1) {
  const long long n = F / kVec;
  const long long per = (n + chunks - 1) / chunks;
  j0 = static_cast<int>(min(n, c * per) * kVec);
  j1 = static_cast<int>(min(n, (c + 1) * per) * kVec);
}

// num, aa and zz summed over the block, in every thread: each warp's by
// shuffles, then the warps' in order (the same order in every thread)
__device__ __forceinline__ void block_sums(float& num, float& aa,
                                           float& zz) {
  __shared__ float red[3][kSplitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  num = warp_sum(num);
  aa = warp_sum(aa);
  zz = warp_sum(zz);
  if (lane == 0) {
    red[0][warp] = num;
    red[1][warp] = aa;
    red[2][warp] = zz;
  }
  __syncthreads();
  num = aa = zz = 0.f;
#pragma unroll
  for (int w = 0; w < kSplitThreads / 32; ++w) {
    num += red[0][w];
    aa += red[1][w];
    zz += red[2][w];
  }
}

// Pass 1: block (c, row, job) sums num, aa and zz over its chunk (each
// thread as the narrow path's lanes do, then block_sums) and writes them
// to the job's part[(row * chunks + c) * 3 + {0, 1, 2}].
template <class C, int kVec>
__global__ void __launch_bounds__(kSplitThreads)
gate_partials_kernel(const GateArgs<C> args) {
  const GateArgs<C> g = for_job(args, blockIdx.z);
  const int c = blockIdx.x, row = blockIdx.y, F = g.F, chunks = g.chunks;
  const long long srow = ring_row(g.slot, g.n_slots, row, g.B);
  const float* ar = g.a + static_cast<long long>(row) * F;
  const typename C::Elem* zr = g.z + srow * C::units(F);
  const float zscale = C::kScaled ? __ldg(g.zs + srow) : 1.f;
  int j0, j1;
  chunk_range(F, kVec, chunks, c, j0, j1);

  float num = 0.f, aa = 0.f, zz = 0.f;
  for (int j = j0 + threadIdx.x * kVec; j < j1; j += kSplitThreads * kVec)
    gate_sums<C, kVec>(ar, zr, zscale, j, num, aa, zz);
  block_sums(num, aa, zz);
  if (threadIdx.x == 0) {
    float* out = g.part + (static_cast<long long>(row) * chunks + c) * 3;
    out[0] = num;
    out[1] = aa;
    out[2] = zz;
  }
}

// Pass 2: block (c, row, job) reduces the row's `chunks` partials in one
// fixed order (thread t takes chunks t, t + 256, ..., then block_sums), so
// every block of the row finds the same w; block (0, row) writes w, and
// with dz each block writes its chunk of cot = w * dz.  The weights-only
// call launches the chunk-0 blocks alone.
template <class C, int kVec>
__global__ void __launch_bounds__(kSplitThreads)
gate_apply_kernel(const GateArgs<C> args) {
  const GateArgs<C> g = for_job(args, blockIdx.z);
  const int c = blockIdx.x, row = blockIdx.y, F = g.F, chunks = g.chunks;
  const float* pr = g.part + static_cast<long long>(row) * chunks * 3;
  float num = 0.f, aa = 0.f, zz = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kSplitThreads) {
    num += pr[3 * i];
    aa += pr[3 * i + 1];
    zz += pr[3 * i + 2];
  }
  block_sums(num, aa, zz);
  const float w = gate_weight(num, aa, zz, g.thresh);
  if (c == 0 && threadIdx.x == 0) g.w[row] = w;
  if (g.dz == nullptr) return;
  const long long srow = ring_row(g.slot, g.n_slots, row, g.B);
  const typename C::Elem* dr = g.dz + srow * C::units(F);
  const float dscale = C::kScaled ? __ldg(g.dzs + srow) : 1.f;
  float* cr = g.cot + static_cast<long long>(row) * F;
  int j0, j1;
  chunk_range(F, kVec, chunks, c, j0, j1);
  for (int j = j0 + threadIdx.x * kVec; j < j1; j += kSplitThreads * kVec)
    gate_scale<C, kVec>(dr, dscale, w, j, cr);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// a job stride of `js` elements of `bytes` bytes keeps every job's base
// on a 16-byte boundary
bool stride16(long long js, int bytes) { return (js * bytes) % 16 == 0; }

// The narrow path with no workspace (chunks <= 1), the split-row path in
// two launches with one (chunks = its partials a row; the caller's rule,
// kernels/cosine_weight.py::gate_chunks, gives a workspace when
// ceil(B / 4) blocks of the narrow path cannot fill the card and F is
// wide).  Both grids take the jobs on their last axis.
template <class C, int kVec>
int launch(const GateArgs<C>& g, int n_jobs, cudaStream_t stream) {
  if (g.chunks <= 1) {
    const dim3 grid((g.B + kWarpsPerBlock - 1) / kWarpsPerBlock, n_jobs);
    cosine_gate_kernel<C, kVec><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  gate_partials_kernel<C, kVec><<<dim3(g.chunks, g.B, n_jobs), kSplitThreads,
                                  0, stream>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_apply_kernel<C, kVec><<<dim3(g.dz ? g.chunks : 1, g.B, n_jobs),
                               kSplitThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads need F to fill whole vectors (so every row, and every
// slot, starts on a 16-byte boundary), 16-byte aligned base pointers and
// job strides that keep each job's base aligned.  part: null, or the
// split-row path's workspace of part_floats = n_jobs * B * chunks * 3
// fp32 values.  js: the job strides {slot, a, z, zs, dz, dzs, thr}.
template <class C>
int dispatch(const int* slot, int n_slots, const float* a, const void* z,
             const float* zs, const void* dz, const float* dzs, float* w,
             float* cot, int B, int F, float thresh, float* part,
             long long part_floats, int n_jobs, const float* thr,
             const long long* js, cudaStream_t stream) {
  if (n_jobs <= 0 || n_jobs > 65535 || js == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_job = 3LL * B * n_jobs;
  const long long chunks_ll = part_floats / per_job;
  if ((part == nullptr) != (part_floats == 0) || part_floats < 0 ||
      part_floats % per_job || chunks_ll > F ||
      (chunks_ll > 1 && B > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  using Elem = typename C::Elem;
  GateArgs<C> g;
  g.slot = slot;
  g.n_slots = n_slots;
  g.a = a;
  g.z = static_cast<const Elem*>(z);
  g.zs = zs;
  g.dz = static_cast<const Elem*>(dz);
  g.dzs = dzs;
  g.w = w;
  g.cot = cot;
  g.part = part;
  g.B = B;
  g.F = F;
  g.chunks = static_cast<int>(chunks_ll);
  g.thresh = thresh;
  g.thr = thr;
  g.js_slot = js[0];
  g.js_a = js[1];
  g.js_z = js[2];
  g.js_zs = js[3];
  g.js_dz = js[4];
  g.js_dzs = js[5];
  g.js_thr = js[6];
  const int eb = static_cast<int>(sizeof(Elem));
  const bool vec = F % C::kVec == 0 && aligned16(a) && aligned16(z) &&
                   aligned16(dz) && aligned16(cot) && stride16(g.js_a, 4) &&
                   stride16(g.js_z, eb) && stride16(g.js_dz, eb);
  if (vec) return launch<C, C::kVec>(g, n_jobs, stream);
  return launch<C, 1>(g, n_jobs, stream);
}

}  // namespace

// K1 / K2.  ring_dtype: 0 = float32, 1 = bfloat16 (the z / dz operands;
// a, w and cot are float32).  slot_stride must be B * F (one ring slot).
// part: null (the narrow path, part_floats 0) or the split-row path's
// fp32 workspace of part_floats = n_jobs * B * chunks * 3 values,
// 2 <= chunks <= F (its partial sums; allocated by the caller).  n_jobs
// jobs run in one launch: js (host memory) holds the job strides {slot,
// a, z, zs, dz, dzs, thr} in elements (zs, dzs unused here), thr the
// jobs' thresholds or null (then thresh for every job); the scalar call
// is n_jobs = 1 with zero strides.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int cosine_gate(const int* slot, int n_slots, long long slot_stride,
                           const float* a, const void* z, const void* dz,
                           float* w, float* cot, int B, int F, float thresh,
                           int ring_dtype, float* part,
                           long long part_floats, int n_jobs,
                           const float* thr, const long long* js,
                           void* stream) {
  if (B <= 0 || F <= 0 || (dz == nullptr) != (cot == nullptr) ||
      (slot != nullptr && slot_stride != static_cast<long long>(B) * F))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring_dtype == 0)
    return dispatch<Dense<float>>(slot, n_slots, a, z, nullptr, dz, nullptr,
                                  w, cot, B, F, thresh, part, part_floats,
                                  n_jobs, thr, js, st);
  if (ring_dtype == 1)
    return dispatch<Dense<__nv_bfloat16>>(slot, n_slots, a, z, nullptr, dz,
                                          nullptr, w, cot, B, F, thresh,
                                          part, part_floats, n_jobs, thr, js,
                                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 (bits = 8: int8 codes (n_slots, B, F)) and K5 (bits = 4: packed
// uint8 (n_slots, B, F / 2), F even), each with fp32 row scales
// (n_slots, B).  a is (B, F) fp32; dzq == nullptr gives weights only.
// part, part_floats, n_jobs, thr, js: as for cosine_gate.
extern "C" int cosine_gate_quant(const int* slot, int n_slots,
                                 const float* a, const void* zq,
                                 const float* zs, const void* dzq,
                                 const float* dzs, float* w, float* cot,
                                 int B, int F, float thresh, int bits,
                                 float* part, long long part_floats,
                                 int n_jobs, const float* thr,
                                 const long long* js, void* stream) {
  if (slot == nullptr || B <= 0 || F <= 0 ||
      (dzq == nullptr) != (cot == nullptr) ||
      (dzq != nullptr) != (dzs != nullptr) || zs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return dispatch<Q8>(slot, n_slots, a, zq, zs, dzq, dzs, w, cot, B, F,
                        thresh, part, part_floats, n_jobs, thr, js, st);
  if (bits == 4 && F % 2 == 0)
    return dispatch<Q4>(slot, n_slots, a, zq, zs, dzq, dzs, w, cot, B, F,
                        thresh, part, part_floats, n_jobs, thr, js, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// K6 / K11: out[r, :] = decode(ring[*slot, r, :]) for the B rows, kVec
// elements a thread (thread e of the grid takes elements [kVec e,
// kVec (e + 1)) of the (B, F) output in row-major order).
template <class C, int kVec>
__global__ void __launch_bounds__(256)
ring_dequant_kernel(const int* __restrict__ slot, int n_slots,
                    const typename C::Elem* __restrict__ zq,
                    const float* __restrict__ zs, float* __restrict__ out,
                    int B, int F) {
  const long long vecs_per_row = F / kVec;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= vecs_per_row * B) return;
  const int s = __ldg(slot);
  if (s < 0 || s >= n_slots) __trap();  // a slot outside the ring
  const int row = static_cast<int>(e / vecs_per_row);
  const int j = static_cast<int>(e % vecs_per_row) * kVec;
  const long long srow = static_cast<long long>(s) * B + row;
  float x[kVec];
  C::template load<kVec>(zq + srow * C::units(F), j, __ldg(zs + srow), x);
  store_f32<kVec>(out + static_cast<long long>(row) * F + j, x);
}

template <class C, int kVec>
int launch_dequant(const int* slot, int n_slots, const void* zq,
                   const float* zs, float* out, int B, int F,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * (F / kVec);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ring_dequant_kernel<C, kVec><<<static_cast<unsigned>(blocks), threads, 0,
                                 stream>>>(
      slot, n_slots, static_cast<const typename C::Elem*>(zq), zs, out, B, F);
  return static_cast<int>(cudaGetLastError());
}

// Four outputs a thread need F % 4 == 0 (every row, and every slot,
// then starts on a whole vector), the codes aligned to their 4 or 2 bytes
// and the output to 16.
template <class C>
int dispatch_dequant(const int* slot, int n_slots, const void* zq,
                     const float* zs, float* out, int B, int F,
                     cudaStream_t stream) {
  if (F % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(zq) & (C::units(4) - 1)) == 0 &&
      aligned16(out))
    return launch_dequant<C, 4>(slot, n_slots, zq, zs, out, B, F, stream);
  return launch_dequant<C, 1>(slot, n_slots, zq, zs, out, B, F, stream);
}

}  // namespace

// K6 (bits = 8: int8 codes (n_slots, B, F)) and K11 (bits = 4: packed
// uint8 (n_slots, B, F / 2), F even), each with fp32 row scales
// (n_slots, B): out (B, F) fp32 = ring slot *slot dequantised.
extern "C" int ring_dequant(const int* slot, int n_slots, const void* zq,
                            const float* zs, float* out, int B, int F,
                            int bits, void* stream) {
  if (slot == nullptr || zs == nullptr || B <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return dispatch_dequant<Q8>(slot, n_slots, zq, zs, out, B, F, st);
  if (bits == 4 && F % 2 == 0)
    return dispatch_dequant<Q4>(slot, n_slots, zq, zs, out, B, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
