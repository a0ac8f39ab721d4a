// Shared pieces of the persistent cooperative BiLSTM kernels
// (bilstm_recurrence.cu, bilstm_bwd.cu): bf16 unpacking, the grid-wide
// barrier, the barrier of a group of blocks and the checked cooperative
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace idt {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& v, float4& lo,
                                              float4& hi) {
  // bf16 -> f32 is a 16-bit left shift of the bit pattern.
  lo.x = __uint_as_float(v.x << 16);
  lo.y = __uint_as_float(v.x & 0xffff0000u);
  lo.z = __uint_as_float(v.y << 16);
  lo.w = __uint_as_float(v.y & 0xffff0000u);
  hi.x = __uint_as_float(v.z << 16);
  hi.y = __uint_as_float(v.z & 0xffff0000u);
  hi.z = __uint_as_float(v.w << 16);
  hi.w = __uint_as_float(v.w & 0xffff0000u);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Grid-wide barrier on a monotonically increasing arrival counter: the
// n-th barrier (n = 1, 2, ...) waits for n * gridDim.x arrivals.  Every
// block must be resident, so the kernels using it launch cooperatively.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) {
      __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

// Barrier of a group of blocks (the blocks of one BiLSTM direction) on
// their own arrival counter, split in two so that work that does not
// depend on the other blocks (the next step's loads) runs between them.
// group_arrive: after every thread's stores, one release-ordered
// increment (fence.acq_rel.gpu, then a relaxed reduction).
// group_wait: thread 0 polls with acquire loads until the n-th barrier's
// n * (group size) arrivals are in; no sleep between polls.  A wait
// longer than SPIN_LIMIT_NS traps.  As for grid_barrier, every block
// must be resident.
__device__ __forceinline__ void group_arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile(
        "fence.acq_rel.gpu;\n\t"
        "red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(counter)
        : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(
    const unsigned int* counter) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(counter)
               : "memory");
  return v;
}

__device__ __forceinline__ void group_wait(const unsigned int* counter,
                                           unsigned int target) {
  if (threadIdx.x == 0 && load_acquire(counter) < target) {
    const uint64_t t0 = global_ns();
    while (load_acquire(counter) < target)
      if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
  __syncthreads();
}

// Cooperative launch of `kernel` on `blocks` x `threads` with `smem`
// bytes of dynamic shared memory, after checking that every block can be
// resident at once (a spinning grid barrier over blocks that are not all
// resident hangs).  Zeroes the `bar_bytes` of barrier counters first.
// Returns a cudaError_t; a failed call leaves no error behind for the
// next launch's cudaGetLastError.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, int blocks, int threads,
                              size_t smem, void** args, unsigned int* bar,
                              cudaStream_t stream,
                              size_t bar_bytes = sizeof(unsigned int)) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, max_smem = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  if (smem > static_cast<size_t>(max_smem))
    return cudaErrorInvalidConfiguration;
  int per_sm = 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && per_sm * sms < blocks)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err == cudaSuccess) err = cudaMemsetAsync(bar, 0, bar_bytes, stream);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                      dim3(blocks), dim3(threads), args,
                                      smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace idt
