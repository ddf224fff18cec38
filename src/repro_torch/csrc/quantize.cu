// Stochastic-rounding quantiser with one absmax scale per tile, for
// Hopper (sm_90a).
//
// Replaces
//   K3  src/repro/kernels/quantize.py  quantize_sr_2d  (_kernel)
//
// For every tile row t of the (T, L) values x and uniforms u in [0, 1):
//   scale[t] = max(max_j |x[t, j]|, 1e-12) / levels
//   q[t, j]  = int8(clip(floor(x[t, j] / scale[t] + u[t, j]), -levels, levels))
// levels is 127 (int8 codes) or 7 (int4 codes, packed by the caller).
// The uniforms are an operand, as on the TPU: the kernel is a
// deterministic function of (x, u), so its codes equal the plain
// version's bit for bit.  That needs the reference's expression order and
// IEEE division, which is why the library is built without
// --use_fast_math (x / scale is a division, not a multiplication by the
// reciprocal).
//
// Bound: bytes.  Each element costs 9 bytes (x and u read, one code
// written) and about 5 flops, far below the card's flop-per-byte ridge.
// The design gives one warp to one tile row: the first sweep takes |x|'s
// max with 16-byte loads and a warp shuffle reduction, the second re-reads
// x (now in L1/L2) with u and writes four codes a lane as one 32-bit
// store.  Any T is taken (the TPU's grid needed T % 128 == 0) and any L
// (a length or pointer that does not allow the vector loads takes the
// one-element-a-lane variant).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
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

template <int kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
quantize_sr_kernel(const float* __restrict__ x, const float* __restrict__ u,
                   int8_t* __restrict__ q, float* __restrict__ scale, int T,
                   int L, float levels) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;  // whole warp leaves together: shuffles stay full
  const long long off = static_cast<long long>(row) * L;
  const float* xr = x + off;
  const float* ur = u + off;
  int8_t* qr = q + off;

  float amax = 0.f;
  for (int j = lane * kVec; j < L; j += 32 * kVec) {
    if constexpr (kVec == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    } else {
      amax = fmaxf(amax, fabsf(xr[j]));
    }
  }
  amax = warp_max(amax);
  const float s = fmaxf(amax, kEps) / levels;
  if (lane == 0) scale[row] = s;

  for (int j = lane * kVec; j < L; j += 32 * kVec) {
    if constexpr (kVec == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      const float4 r = *reinterpret_cast<const float4*>(ur + j);
      char4 c;
      c.x = code(v.x, r.x, s, levels);
      c.y = code(v.y, r.y, s, levels);
      c.z = code(v.z, r.z, s, levels);
      c.w = code(v.w, r.w, s, levels);
      *reinterpret_cast<char4*>(qr + j) = c;
    } else {
      qr[j] = code(xr[j], ur[j], s, levels);
    }
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

// x, u: (T, L) fp32; q: (T, L) int8; scale: (T,) fp32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int quantize_sr(const float* x, const float* u, int8_t* q,
                           float* scale, int T, int L, float levels,
                           void* stream) {
  if (T <= 0 || L <= 0 || !(levels >= 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  if (L % 4 == 0 && aligned(x, 16) && aligned(u, 16) && aligned(q, 4))
    quantize_sr_kernel<4><<<grid, block, 0, st>>>(x, u, q, scale, T, L,
                                                   levels);
  else
    quantize_sr_kernel<1><<<grid, block, 0, st>>>(x, u, q, scale, T, L,
                                                   levels);
  return static_cast<int>(cudaGetLastError());
}
