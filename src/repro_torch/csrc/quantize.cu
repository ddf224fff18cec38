// Stochastic-rounding quantiser with one absmax scale per tile row, for
// Hopper (sm_90a).
//
// Replaces
//   K3  src/repro/kernels/quantize.py  quantize_sr_2d  (_kernel)
//
// For every tile row t of the (T, L) values x and uniforms u in [0, 1):
//   scale[t] = max(max_j |x[t, j]|, 1e-12) / levels
//   q[t, j]  = int8(clip(floor(x[t, j] / scale[t] + u[t, j]), -levels, levels))
// levels is 127 (int8 codes) or 7 (int4 codes, packed by the caller).
// x is fp32 or bf16; a bf16 row is read as it is and widened to fp32 in
// registers, as the TPU kernel widens its block (widening is exact, so
// the codes are those of the row's fp32 copy).  u is fp32.
// The uniforms are an operand, as on the TPU: the kernel is a
// deterministic function of (x, u), so its codes equal the plain
// version's bit for bit.  That needs the reference's expression order and
// IEEE division, which is why the library is built without
// --use_fast_math (x / scale is a division, not a multiplication by the
// reciprocal).
//
// Bound: bytes.  Each element costs x's 4 or 2 bytes, u's 4 and one code
// (9 or 7 bytes) and about 5 flops, far below the card's flop-per-byte
// ridge: the least time is (T * L * (x's bytes + 5) + 4 * T) bytes over
// 3.35 TB/s, 0.176 us at the inserts' (256, 256) fp32 and 21.1 us (fp32)
// or 16.4 us (bf16) at the LLM cut tensor of one 4,096-token sequence a
// row, (2, 3,932,160).  Two paths:
//   * narrow (many rows: the wire's (T, 128) tiles, the WDL inserts'
//     (256, 256)): one warp a row, four warps a block.  A row of at most
//     kRegCols = 512 elements is loaded whole in one sweep, x and u
//     together, into registers (at most four vectors of each a lane); the
//     warp takes its max by shuffles and quantises from the registers, so
//     the row costs one dependent round trip to memory.  A wider row takes
//     two sweeps: |x|'s max, then x again (from L1 / L2) with u.
//   * split-row (few wide rows: the LLM ring's (2, 61,440) and
//     (2, 3,932,160), where the narrow path's ceil(T / 4) blocks would
//     leave all but one of the card's 132 SMs idle, with two warps
//     sweeping a row twice): each row is cut into `chunks` chunks of whole
//     vectors, one block of 256 threads a (chunk, row), in two launches.
//     Pass 1 takes the chunk's |x| max (kUnroll independent loads in
//     flight a thread, then warp shuffles and shared memory) into a
//     (T, chunks) fp32 workspace that the caller allocates.  Pass 2 issues
//     its chunk's first loads of x and u, then reduces the row's chunk
//     maxima in one fixed order in every block of the row (a max is exact
//     and order-free, so every block finds the same scale bits); block 0
//     of the row writes the scale and each block writes its chunk's codes.
//     x is read twice, u once.  No atomics: a run repeats bitwise, and the
//     codes and scales equal the plain version's whatever the chunking.
//     The caller's rule (kernels/quantize.py::quant_chunks, set by
//     measurement in chip_variants.py) splits when ceil(T / 4) < 132 and
//     L >= 2 * 4,096, in chunks of about 4,096 elements (960 a row at
//     3,932,160: 1,920 blocks a pass).
// Loads are 16 bytes of fp32 (8 of bf16) and 16 of u a thread, stores 4
// codes; an L or a pointer that does not allow them takes the
// one-element-a-thread variant on either path.  Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRegCols = 512;       // narrow rows held whole in registers
constexpr int kSplitThreads = 256;
constexpr int kUnroll = 4;          // split path: vectors in flight a thread
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t code(float x, float u, float scale,
                                       float levels) {
  float q = floorf(x / scale + u);
  q = fminf(fmaxf(q, -levels), levels);
  return static_cast<int8_t>(static_cast<int>(q));
}

// kVec elements at p as fp32
template <int kVec>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 4) {
    const uint2 b = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&b);
    const float2 lo = __bfloat1622float2(h[0]);
    const float2 hi = __bfloat1622float2(h[1]);
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int kVec>
__device__ __forceinline__ float abs_max(float m, const float* v) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) m = fmaxf(m, fabsf(v[k]));
  return m;
}

// the codes of kVec elements, stored at q (four as one 32-bit store)
template <int kVec>
__device__ __forceinline__ void store_codes(int8_t* q, const float* x,
                                            const float* u, float s,
                                            float levels) {
  if constexpr (kVec == 4) {
    char4 c;
    c.x = code(x[0], u[0], s, levels);
    c.y = code(x[1], u[1], s, levels);
    c.z = code(x[2], u[2], s, levels);
    c.w = code(x[3], u[3], s, levels);
    *reinterpret_cast<char4*>(q) = c;
  } else {
    q[0] = code(x[0], u[0], s, levels);
  }
}

// The narrow path: warp w of block b owns row 4 b + w.  kRegs: the row
// (L <= kRegCols) is held in registers between the max and the codes.
template <typename T, int kVec, bool kRegs>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
quantize_sr_kernel(const T* __restrict__ x, const float* __restrict__ u,
                   int8_t* __restrict__ q, float* __restrict__ scale,
                   int n_rows, int L, float levels) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together: shuffles stay full
  const long long off = static_cast<long long>(row) * L;
  const T* xr = x + off;
  const float* ur = u + off;
  int8_t* qr = q + off;

  if constexpr (kRegs) {
    constexpr int kN = kRegCols / (32 * kVec);
    float xv[kN][kVec], uv[kN][kVec];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int j = (i * 32 + lane) * kVec;
      if (j < L) {
        load<kVec>(xr + j, xv[i]);
        load<kVec>(ur + j, uv[i]);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if ((i * 32 + lane) * kVec < L) amax = abs_max<kVec>(amax, xv[i]);
    const float s = fmaxf(warp_max(amax), kEps) / levels;
    if (lane == 0) scale[row] = s;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int j = (i * 32 + lane) * kVec;
      if (j < L) store_codes<kVec>(qr + j, xv[i], uv[i], s, levels);
    }
  } else {
    float amax = 0.f;
    for (int j = lane * kVec; j < L; j += 32 * kVec) {
      float v[kVec];
      load<kVec>(xr + j, v);
      amax = abs_max<kVec>(amax, v);
    }
    const float s = fmaxf(warp_max(amax), kEps) / levels;
    if (lane == 0) scale[row] = s;
    for (int j = lane * kVec; j < L; j += 32 * kVec) {
      float v[kVec], r[kVec];
      load<kVec>(xr + j, v);
      load<kVec>(ur + j, r);
      store_codes<kVec>(qr + j, v, r, s, levels);
    }
  }
}

// The split-row path: chunk c of a row of n vectors holds vectors
// [c * per, min(n, (c + 1) * per)), per = ceil(n / chunks).
__device__ __forceinline__ void chunk_range(int L, int kVec, int chunks,
                                            int c, int& j0, int& j1) {
  const long long n = L / kVec;
  const long long per = (n + chunks - 1) / chunks;
  j0 = static_cast<int>(min(n, c * per) * kVec);
  j1 = static_cast<int>(min(n, (c + 1) * per) * kVec);
}

// the block's max of v, in every thread: each warp's by shuffles, then
// the warps' through shared memory
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[kSplitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kSplitThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// kUnroll vectors of a thread from j on, a block's width apart (those at
// or past j1 are not read)
template <typename T, int kVec>
__device__ __forceinline__ void load_group(const T* row, int j, int j1,
                                           float (*v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int k = j + i * kSplitThreads * kVec;
    if (k < j1) load<kVec>(row + k, v[i]);
  }
}

// Pass 1: block (c, row) writes its chunk's |x| max to
// part[row * chunks + c].
template <typename T, int kVec>
__global__ void __launch_bounds__(kSplitThreads)
quantize_partials_kernel(const T* __restrict__ x, float* __restrict__ part,
                         int L, int chunks) {
  const int c = blockIdx.x, row = blockIdx.y;
  const T* xr = x + static_cast<long long>(row) * L;
  int j0, j1;
  chunk_range(L, kVec, chunks, c, j0, j1);
  float amax = 0.f;
  for (int j = j0 + threadIdx.x * kVec; j < j1;
       j += kUnroll * kSplitThreads * kVec) {
    float v[kUnroll][kVec];
    load_group<T, kVec>(xr, j, j1, v);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      if (j + i * kSplitThreads * kVec < j1) amax = abs_max<kVec>(amax, v[i]);
  }
  amax = block_max(amax);
  if (threadIdx.x == 0) part[static_cast<long long>(row) * chunks + c] = amax;
}

// Pass 2: block (c, row) reduces the row's chunk maxima (thread t takes
// chunks t, t + 256, ..., then block_max), so every block of the row
// finds the same scale; block (0, row) writes it, and each block writes
// its chunk's codes.
template <typename T, int kVec>
__global__ void __launch_bounds__(kSplitThreads)
quantize_apply_kernel(const T* __restrict__ x, const float* __restrict__ u,
                      int8_t* __restrict__ q, float* __restrict__ scale,
                      const float* __restrict__ part, int L, int chunks,
                      float levels) {
  const int c = blockIdx.x, row = blockIdx.y;
  const long long off = static_cast<long long>(row) * L;
  const T* xr = x + off;
  const float* ur = u + off;
  int8_t* qr = q + off;
  int j0, j1;
  chunk_range(L, kVec, chunks, c, j0, j1);
  // the first loads go out before the reduction, so their latency and
  // the maxima's overlap
  int j = j0 + threadIdx.x * kVec;
  float xv[kUnroll][kVec], uv[kUnroll][kVec];
  load_group<T, kVec>(xr, j, j1, xv);
  load_group<float, kVec>(ur, j, j1, uv);

  const float* pr = part + static_cast<long long>(row) * chunks;
  float amax = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kSplitThreads)
    amax = fmaxf(amax, pr[i]);
  const float s = fmaxf(block_max(amax), kEps) / levels;
  if (c == 0 && threadIdx.x == 0) scale[row] = s;

  while (true) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int k = j + i * kSplitThreads * kVec;
      if (k < j1) store_codes<kVec>(qr + k, xv[i], uv[i], s, levels);
    }
    j += kUnroll * kSplitThreads * kVec;
    if (j >= j1) break;
    load_group<T, kVec>(xr, j, j1, xv);
    load_group<float, kVec>(ur, j, j1, uv);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The narrow path with no workspace (chunks <= 1), the split-row path in
// two launches with one.
template <typename T, int kVec>
int launch(const T* x, const float* u, int8_t* q, float* scale, int n_rows,
           int L, float levels, float* part, int chunks,
           cudaStream_t stream) {
  if (chunks <= 1) {
    const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (L <= kRegCols)
      quantize_sr_kernel<T, kVec, true><<<grid, 32 * kWarpsPerBlock, 0,
                                          stream>>>(x, u, q, scale, n_rows, L,
                                                    levels);
    else
      quantize_sr_kernel<T, kVec, false><<<grid, 32 * kWarpsPerBlock, 0,
                                           stream>>>(x, u, q, scale, n_rows,
                                                     L, levels);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(chunks, n_rows);
  quantize_partials_kernel<T, kVec><<<grid, kSplitThreads, 0, stream>>>(
      x, part, L, chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  quantize_apply_kernel<T, kVec><<<grid, kSplitThreads, 0, stream>>>(
      x, u, q, scale, part, L, chunks, levels);
  return static_cast<int>(cudaGetLastError());
}

// Vector loads need L to fill whole vectors (so every row starts on a
// vector boundary) and aligned base pointers.
template <typename T>
int dispatch(const void* xp, const float* u, int8_t* q, float* scale,
             int n_rows, int L, float levels, float* part,
             long long part_floats, cudaStream_t stream) {
  const long long chunks = part_floats / n_rows;
  if ((part == nullptr) != (part_floats == 0) || part_floats < 0 ||
      part_floats % n_rows || chunks > L || (chunks > 1 && n_rows > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xp);
  if (L % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(u, 16) &&
      aligned(q, 4))
    return launch<T, 4>(x, u, q, scale, n_rows, L, levels, part,
                        static_cast<int>(chunks), stream);
  return launch<T, 1>(x, u, q, scale, n_rows, L, levels, part,
                      static_cast<int>(chunks), stream);
}

}  // namespace

// x: (T, L) fp32 (x_dtype 0) or bf16 (x_dtype 1); u: (T, L) fp32;
// q: (T, L) int8; scale: (T,) fp32.  part: null (the narrow path,
// part_floats 0) or the split-row path's fp32 workspace of
// part_floats = T * chunks values, chunks <= L (each row's chunk maxima;
// allocated by the caller).  Returns the cudaError_t of the launches (0
// on success).
extern "C" int quantize_sr(const void* x, const float* u, int8_t* q,
                           float* scale, int T, int L, float levels,
                           int x_dtype, float* part, long long part_floats,
                           void* stream) {
  // L's headroom keeps a thread's offsets, a few block widths past the
  // row's end, within int
  if (T <= 0 || L <= 0 || L > 0x7fff0000 || !(levels >= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch<float>(x, u, q, scale, T, L, levels, part, part_floats,
                           st);
  if (x_dtype == 1)
    return dispatch<__nv_bfloat16>(x, u, q, scale, T, L, levels, part,
                                   part_floats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
