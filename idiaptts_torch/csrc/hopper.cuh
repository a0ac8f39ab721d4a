// Shared Hopper (sm_90a) pieces of the wgmma kernels (bilstm_proj.cu,
// bilstm_recurrence.cu): shared-memory addresses, the global timer that
// bounds their spin waits, the wgmma shared-memory descriptor and the
// wgmma fences.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace idt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A spin wait longer than this can only be a broken hand-over: the
// kernels trap, so the launch fails with an error instead of holding the
// card.
constexpr uint64_t SPIN_LIMIT_NS = 4000000000ull;

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; N-major: the next 64-column atom) and
// stride byte offset (the next 8-row / 8-k group of 1024 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace idt
