// Algorithm-2 cosine gate for Hopper (sm_90a): one kernel for the TPU's
// K1 and K2 Pallas kernels.
//
// Replaces
//   K1  src/repro/kernels/fused_sample.py  fused_sample_2d   (_kernel_f32)
//   K2a src/repro/kernels/cosine_weight.py cosine_weight_2d  (_kernel)
//   K2b src/repro/kernels/cosine_weight.py cosine_weights_2d (_kernel_weights_only)
//
// For every row r of the (B, F) operands:
//   w[r]   = <a_r, z_r> / max(sqrt(|a_r|^2 * |z_r|^2), 1e-12), then 0 below thresh
//   cot[r] = w[r] * dz_r                                       (fp32 out)
// where z and dz are either materialised (B, F) rows (K2: slot == nullptr)
// or slot *slot of a (n_slots, B, F) ring (K1).  The slot is read from
// device memory by the kernel itself, so the caller never syncs to learn
// it (the TPU kernel took it as a scalar-prefetch operand).  dz == nullptr
// selects weights only (K2b, and K1 as Party B calls it).
//
// Bound: bytes.  The gate does about 7 flops per element against 12-16
// bytes moved, far below the card's flop-per-byte ridge, so the least
// time is (bytes read once + bytes written once) / 3.35 TB/s.  The design
// reads each operand once with 16-byte loads (4 fp32 or 8 bf16 a lane)
// and keeps the three dot products in registers: one warp owns one row,
// sweeps F in chunks of 32 * kVec elements, reduces with warp shuffles,
// then sweeps dz a second time for the cotangent.  The chunked loop serves
// any F (256 on the paper's models, S * d at LLM geometry).
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

// kVec elements per lane per chunk; the host picks kVec > 1 only when F
// and every base pointer allow aligned 16-byte accesses.
template <typename T, int kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cosine_gate_kernel(const int* __restrict__ slot, int n_slots,
                   long long slot_stride, const float* __restrict__ a,
                   const T* __restrict__ z, const T* __restrict__ dz,
                   float* __restrict__ w_out, float* __restrict__ cot, int B,
                   int F, float thresh) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves together: shuffles stay full
  long long base = 0;
  if (slot != nullptr) {
    const int s = __ldg(slot);
    if (s < 0 || s >= n_slots) __trap();  // a slot outside the ring
    base = static_cast<long long>(s) * slot_stride;
  }
  const long long roff = static_cast<long long>(row) * F;
  const float* ar = a + roff;
  const T* zr = z + base + roff;

  float num = 0.f, aa = 0.f, zz = 0.f;
  for (int j = lane * kVec; j < F; j += 32 * kVec) {
    float av[kVec], zv[kVec];
    load_f32<kVec>(ar + j, av);
    load_f32<kVec>(zr + j, zv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      num += av[k] * zv[k];
      aa += av[k] * av[k];
      zz += zv[k] * zv[k];
    }
  }
  num = warp_sum(num);
  aa = warp_sum(aa);
  zz = warp_sum(zz);
  // the product goes under the sqrt, as in the reference
  float w = num / fmaxf(sqrtf(aa * zz), kEps);
  w = (w < thresh) ? 0.f : w;
  if (lane == 0) w_out[row] = w;
  if (dz == nullptr) return;

  const T* dr = dz + base + roff;
  float* cr = cot + roff;
  for (int j = lane * kVec; j < F; j += 32 * kVec) {
    float dv[kVec];
    load_f32<kVec>(dr + j, dv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) dv[k] *= w;
    store_f32<kVec>(cr + j, dv);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int kVec>
void launch(const int* slot, int n_slots, long long slot_stride,
            const float* a, const void* z, const void* dz, float* w,
            float* cot, int B, int F, float thresh, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cosine_gate_kernel<T, kVec><<<grid, block, 0, stream>>>(
      slot, n_slots, slot_stride, a, static_cast<const T*>(z),
      static_cast<const T*>(dz), w, cot, B, F, thresh);
}

template <typename T>
void dispatch(const int* slot, int n_slots, long long slot_stride,
              const float* a, const void* z, const void* dz, float* w,
              float* cot, int B, int F, float thresh, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = F % kVec == 0 && slot_stride % kVec == 0 &&
                   aligned16(a) && aligned16(z) && aligned16(dz) &&
                   aligned16(cot);
  if (vec)
    launch<T, kVec>(slot, n_slots, slot_stride, a, z, dz, w, cot, B, F,
                    thresh, stream);
  else
    launch<T, 1>(slot, n_slots, slot_stride, a, z, dz, w, cot, B, F, thresh,
                 stream);
}

}  // namespace

// ring_dtype: 0 = float32, 1 = bfloat16 (the z / dz operands; a, w and cot
// are float32).  Returns the cudaError_t of the launch (0 on success).
extern "C" int cosine_gate(const int* slot, int n_slots, long long slot_stride,
                           const float* a, const void* z, const void* dz,
                           float* w, float* cot, int B, int F, float thresh,
                           int ring_dtype, void* stream) {
  if (B <= 0 || F <= 0 || (dz == nullptr) != (cot == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring_dtype == 0)
    dispatch<float>(slot, n_slots, slot_stride, a, z, dz, w, cot, B, F,
                    thresh, st);
  else if (ring_dtype == 1)
    dispatch<__nv_bfloat16>(slot, n_slots, slot_stride, a, z, dz, w, cot, B,
                            F, thresh, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cosine_gate_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
