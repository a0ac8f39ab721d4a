// One-shot MLPG solve: factor the pentadiagonal MLPG precision and solve
// L L^T x = b in one launch, independently in every lane.
//
// Replaces idiaptts_tpu/ops/pallas_mlpg.py:_mlpg_kernel (wrapper
// mlpg_pallas).  Same float32 recurrences:
//   l0_t = sqrt(max(a0_t - l1_{t-1}^2 - l2_{t-2}^2, 1e-20))
//   l1_t = (a1_t - l1_{t-1} l2_{t-1}) / l0_t
//   l2_t = a2_t / l0_t
//   y_t  = (b_t - l1_{t-1} y_{t-1} - l2_{t-2} y_{t-2}) / l0_t
//   x_t  = (y_t - l1_t x_{t+1} - l2_t x_{t+2}) / l0_t
// with zero carries before row 0 and after row T-1, so every row takes
// the same code path and T = 1 and T = 2 need no special case (the TPU
// kernel writes rows 0, 1 and T-2 unconditionally and so needs T >= 3).
//
// Layout: every array is (T, L) float32, row-major, lane l of step t at
// t*L + l; no padding of the lane axis.  One thread owns one lane.  The
// factorisation is folded into the forward substitution: at step t the
// factor row t and y_t need only the carries of rows t-1 and t-2, so one
// forward sweep replaces the TPU kernel's Cholesky and forward loops.  It
// stores l0, l1, l2 and y in a (4, T, L) scratch the wrapper allocates;
// the backward sweep reads them in reverse.
//
// What bounds it: each lane is a chain of 2T dependent steps (a sqrt and
// a divide a step forward, a divide a step backward).  On the WORLD
// post-processing path L is 1 to 60 lanes, less than two warps, so the
// kernel is latency-bound: its time is about 2T times one step's
// dependent latency, far above the bytes it moves.  Each step's loads do
// not depend on the carries; the unrolled loops let the compiler issue
// them ahead of the dependent arithmetic.
#include <cuda_runtime.h>

namespace {

__global__ void mlpg_oneshot_kernel(const float* __restrict__ b,
                                    const float* __restrict__ a0,
                                    const float* __restrict__ a1,
                                    const float* __restrict__ a2,
                                    float* __restrict__ scratch,
                                    float* __restrict__ x, int T, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const size_t stride = static_cast<size_t>(L);
  const size_t plane = static_cast<size_t>(T) * stride;
  float* __restrict__ s0 = scratch;              // l0
  float* __restrict__ s1 = scratch + plane;      // l1
  float* __restrict__ s2 = scratch + 2 * plane;  // l2
  float* __restrict__ sy = scratch + 3 * plane;  // y

  // Forward: factor row t, then y_t.
  float l1m1 = 0.f, l2m1 = 0.f, l2m2 = 0.f;  // l1_{t-1}, l2_{t-1}, l2_{t-2}
  float ym1 = 0.f, ym2 = 0.f;                // y_{t-1}, y_{t-2}
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const size_t i = t * stride + lane;
    const float l0t =
        sqrtf(fmaxf(a0[i] - l1m1 * l1m1 - l2m2 * l2m2, 1e-20f));
    const float l1t = (a1[i] - l1m1 * l2m1) / l0t;
    const float l2t = a2[i] / l0t;
    const float yt = (b[i] - l1m1 * ym1 - l2m2 * ym2) / l0t;
    s0[i] = l0t;
    s1[i] = l1t;
    s2[i] = l2t;
    sy[i] = yt;
    ym2 = ym1;
    ym1 = yt;
    l2m2 = l2m1;
    l1m1 = l1t;
    l2m1 = l2t;
  }

  // Backward substitution L^T x = y.
  float xp1 = 0.f, xp2 = 0.f;  // x_{t+1}, x_{t+2}
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = t * stride + lane;
    const float xt = (sy[i] - s1[i] * xp1 - s2[i] * xp2) / s0[i];
    x[i] = xt;
    xp2 = xp1;
    xp1 = xt;
  }
}

}  // namespace

extern "C" int idt_mlpg_oneshot(const void* b, const void* a0,
                                const void* a1, const void* a2,
                                void* scratch, void* x, int T, int L,
                                cudaStream_t stream) {
  if (T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  const int blocks = (L + threads - 1) / threads;
  mlpg_oneshot_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(b), static_cast<const float*>(a0),
      static_cast<const float*>(a1), static_cast<const float*>(a2),
      static_cast<float*>(scratch), static_cast<float*>(x), T, L);
  return static_cast<int>(cudaGetLastError());
}
