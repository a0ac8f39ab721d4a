// Shared pieces of the WaveNet training kernels (wavenet_gate.cu,
// wavenet_block.cu): 16-byte vectors of 8 bf16 values, their float32
// unpacking and round-to-nearest packing, and bf16 rounding of a float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace idt {

constexpr int VEC = 8;          // bf16 a 16-byte vector
constexpr int EW_THREADS = 256;

struct alignas(16) Vec8 {
  __nv_bfloat162 v[4];
};

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack(const Vec8& p, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p.v[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ Vec8 pack(const float* f) {
  Vec8 p;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p.v[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return p;
}

// 8 float32 as two 16-byte loads and stores.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// A grid-stride launch over `work` items: a few waves of resident blocks.
inline int ew_grid(int64_t work) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + EW_THREADS - 1) / EW_THREADS;
  const int64_t cap = (int64_t)(sms > 0 ? sms : 132) * 8;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace idt
