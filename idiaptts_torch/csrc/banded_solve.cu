// MLPG banded substitution: solve L L^T x = b for a bandwidth-2 Cholesky
// factor, independently in every lane.
//
// Replaces idiaptts_tpu/ops/pallas_mlpg.py:_solve_kernel (wrapper
// solve_banded_pallas).  Same recurrences and zero-carry boundary:
//   forward   y_t = (b_t - l1_{t-1} y_{t-1} - l2_{t-2} y_{t-2}) / l0_t
//   backward  x_t = (y_t - l1_t x_{t+1}     - l2_t x_{t+2})     / l0_t
// with y_{-1} = y_{-2} = x_T = x_{T+1} = 0.
//
// Layout: every array is (T, L) float32, row-major, so lane l of step t
// is element t*L + l.  One thread owns one lane and walks T forward, then
// backward, carrying the two previous values in registers; neighbouring
// threads read neighbouring addresses, so each step's loads coalesce.  y
// goes to a scratch array the wrapper allocates.  The TPU's padding to 8
// rows and 128 lanes is not needed.
//
// What bounds it: each lane is a chain of 2T dependent divide-and-FMA
// steps; the work per step is 4 loads and 1 store per lane.  At the
// serving shapes (L = B*22 = 132 or 1056 lanes, T = 512) that is a handful
// of warps, so the kernel is latency-bound, not bandwidth-bound: its time
// is about 2T times one step's dependent latency.  The loads of a step do
// not depend on the carry, so the unrolled loop lets the compiler issue
// them ahead of the dependent arithmetic.
#include <cuda_runtime.h>

namespace {

__global__ void banded_solve_kernel(const float* __restrict__ b,
                                    const float* __restrict__ l0,
                                    const float* __restrict__ l1,
                                    const float* __restrict__ l2,
                                    float* __restrict__ y,
                                    float* __restrict__ x, int T, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const size_t stride = static_cast<size_t>(L);

  // Forward substitution L y = b.
  float ym1 = 0.f, ym2 = 0.f;      // y_{t-1}, y_{t-2}
  float l1m1 = 0.f, l2m1 = 0.f, l2m2 = 0.f;  // l1_{t-1}, l2_{t-1}, l2_{t-2}
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const size_t i = t * stride + lane;
    const float yt = (b[i] - l1m1 * ym1 - l2m2 * ym2) / l0[i];
    y[i] = yt;
    ym2 = ym1;
    ym1 = yt;
    l2m2 = l2m1;
    l1m1 = l1[i];
    l2m1 = l2[i];
  }

  // Backward substitution L^T x = y.
  float xp1 = 0.f, xp2 = 0.f;      // x_{t+1}, x_{t+2}
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = t * stride + lane;
    const float xt = (y[i] - l1[i] * xp1 - l2[i] * xp2) / l0[i];
    x[i] = xt;
    xp2 = xp1;
    xp1 = xt;
  }
}

}  // namespace

extern "C" int idt_banded_solve(const void* b, const void* l0,
                                const void* l1, const void* l2, void* y,
                                void* x, int T, int L,
                                cudaStream_t stream) {
  if (T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  banded_solve_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(b), static_cast<const float*>(l0),
      static_cast<const float*>(l1), static_cast<const float*>(l2),
      static_cast<float*>(y), static_cast<float*>(x), T, L);
  return static_cast<int>(cudaGetLastError());
}
