// The elementwise passes of a WaveNet residual block's bf16 training path
// around its cuBLAS products, forward and backward, with the plain path's
// rounding chain (models/wavenet.py, ResidualBlock.forward; the plain
// versions are in ops/wavenet_block.py).
//
// Replaces no TPU kernel: XLA fused these into the convolutions and the
// Dense layers of the teacher-forced network.  On the card PyTorch ran
// them as casts, a pad, a concatenation, bias adds, the residual update,
// the skip sum, and in the backward zero-filled slice gradients and their
// sums: the largest share of the step's device time, at well under the
// card's bandwidth.  Four kernels, each one pass:
//
// - taps (forward): the dilated convolution's operand,
//     taps[b, t, j R + r] = bf(x[b, t - (k - 1 - j) d, r]), 0 before t = 0,
//   from the float32 residual stream x (B, T, R);
// - taps_bwd: the stream's gradient from both of its uses,
//     dx = dx' c + bf(sum_j dtaps[b, t + (k - 1 - j) d, j R + r]),
//   c = 1 / sqrt(2), the sum over the taps that read t in float32;
// - residual (forward): from P = bf(z . [Ws | Wr]) (S + R columns),
//     skip = bf(P[:S] + bs), res = bf(P[S:] + br),
//     x' = (x + res) c, skips' = bf(skips + skip) (or skip, first block);
// - residual_bwd: dP = [dskips' | bf(dx' c)] (bf16).
//
// What bounds them: bytes (a few operations a value).  Each thread moves
// 16-byte vectors: 8 bf16 or 8 float32 as two float4; R and S must be
// multiples of 8 and every pointer 16-byte aligned.
#include "bf16_vec.cuh"

namespace {

using idt::Vec8;
using idt::VEC;
using idt::bf;
using idt::unpack;
using idt::pack;
using idt::load8;
using idt::store8;
constexpr int THREADS = idt::EW_THREADS;
constexpr float INV_SQRT2 = 0.70710678118654752f;

struct Shape {
  int64_t B, T;
  int R, k, d;
};

// One thread: 8 channels of one tap of one (b, t).
__global__ void __launch_bounds__(THREADS)
taps_kernel(const float* __restrict__ x, Vec8* __restrict__ taps, Shape s) {
  const int rv = s.R / VEC;
  const int64_t total = s.B * s.T * s.k * rv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bt = i / (s.k * rv);
    const int rest = (int)(i - bt * (s.k * rv));
    const int j = rest / rv;
    const int c = rest - j * rv;
    const int64_t t = bt % s.T;
    const int64_t shift = (int64_t)(s.k - 1 - j) * s.d;
    float f[VEC];
    if (t >= shift) {
      load8(x + (bt - shift) * s.R + c * VEC, f);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) f[q] = 0.0f;
    }
    taps[i] = pack(f);
  }
}

// One thread: 8 channels of one (b, t).
__global__ void __launch_bounds__(THREADS)
taps_bwd_kernel(const Vec8* __restrict__ dtaps, const float* __restrict__ dxo,
                float* __restrict__ dx, Shape s) {
  const int rv = s.R / VEC;
  const int64_t total = s.B * s.T * rv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bt = i / rv;
    const int c = (int)(i - bt * rv);
    const int64_t t = bt % s.T;
    float acc[VEC], g[VEC], out[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    for (int j = 0; j < s.k; ++j) {
      const int64_t shift = (int64_t)(s.k - 1 - j) * s.d;
      if (t + shift < s.T) {
        unpack(dtaps[((bt + shift) * s.k + j) * rv + c], g);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], g[q]);
      }
    }
    load8(dxo + bt * s.R + c * VEC, g);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      out[q] = __fadd_rn(__fmul_rn(g[q], INV_SQRT2), bf(acc[q]));
    store8(dx + bt * s.R + c * VEC, out);
  }
}

// One thread: 8 columns of P of one row (skip or residual part).
__global__ void __launch_bounds__(THREADS)
residual_kernel(const Vec8* __restrict__ p,
                const __nv_bfloat16* __restrict__ bias,
                const float* __restrict__ x, const Vec8* __restrict__ skips,
                float* __restrict__ x_out, Vec8* __restrict__ skips_out,
                int64_t rows, int S, int R) {
  const int sv = S / VEC, wv = (S + R) / VEC;
  const int64_t total = rows * wv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / wv;
    const int c = (int)(i - r * wv);
    float v[VEC], o[VEC];
    unpack(p[i], v);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      v[q] = bf(__fadd_rn(v[q], __bfloat162float(bias[c * VEC + q])));
    if (c < sv) {
      if (skips != nullptr) {
        float old[VEC];
        unpack(skips[r * sv + c], old);
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = __fadd_rn(old[q], v[q]);
      }
      skips_out[r * sv + c] = pack(v);
    } else {
      const int64_t at = r * R + (c - sv) * VEC;
      load8(x + at, o);
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        o[q] = __fmul_rn(__fadd_rn(o[q], v[q]), INV_SQRT2);
      store8(x_out + at, o);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
residual_bwd_kernel(const float* __restrict__ dxo,
                    const Vec8* __restrict__ dskips, Vec8* __restrict__ dp,
                    int64_t rows, int S, int R) {
  const int sv = S / VEC, wv = (S + R) / VEC;
  const int64_t total = rows * wv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / wv;
    const int c = (int)(i - r * wv);
    if (c < sv) {
      dp[i] = dskips[r * sv + c];
    } else {
      float g[VEC];
      load8(dxo + r * R + (c - sv) * VEC, g);
#pragma unroll
      for (int q = 0; q < VEC; ++q) g[q] = __fmul_rn(g[q], INV_SQRT2);
      dp[i] = pack(g);
    }
  }
}

bool bad_shape(long long B, long long T, int R, int k, int d) {
  return B <= 0 || T <= 0 || R <= 0 || R % VEC != 0 || k <= 0 || d <= 0;
}

}  // namespace

// x: (B, T, R) float32; taps: (B, T, k R) bf16 out.
extern "C" int idt_wavenet_taps(const void* x, void* taps, long long B,
                                long long T, int R, int k, int d,
                                cudaStream_t stream) {
  if (bad_shape(B, T, R, k, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(x) || !idt::aligned16(taps))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Shape s{B, T, R, k, d};
  const int64_t work = (int64_t)B * T * k * (R / VEC);
  taps_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<Vec8*>(taps), s);
  return static_cast<int>(cudaGetLastError());
}

// dtaps: (B, T, k R) bf16; dxo: (B, T, R) float32, the block output's
// gradient; dx: (B, T, R) float32 out.
extern "C" int idt_wavenet_taps_bwd(const void* dtaps, const void* dxo,
                                    void* dx, long long B, long long T, int R,
                                    int k, int d, cudaStream_t stream) {
  if (bad_shape(B, T, R, k, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(dtaps) || !idt::aligned16(dxo) || !idt::aligned16(dx))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Shape s{B, T, R, k, d};
  const int64_t work = (int64_t)B * T * (R / VEC);
  taps_bwd_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const Vec8*>(dtaps), static_cast<const float*>(dxo),
      static_cast<float*>(dx), s);
  return static_cast<int>(cudaGetLastError());
}

// p: (rows, S + R) bf16; bias: (S + R,) bf16; x: (rows, R) float32;
// skips: (rows, S) bf16 or null (the first block); x_out: (rows, R)
// float32 out; skips_out: (rows, S) bf16 out.
extern "C" int idt_wavenet_residual(const void* p, const void* bias,
                                    const void* x, const void* skips,
                                    void* x_out, void* skips_out,
                                    long long rows, int S, int R,
                                    cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || R <= 0 || S % VEC != 0 || R % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(p) || !idt::aligned16(x) || !idt::aligned16(x_out) ||
      !idt::aligned16(skips_out) ||
      (skips != nullptr && !idt::aligned16(skips)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t work = rows * ((S + R) / VEC);
  residual_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const Vec8*>(p), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const float*>(x), static_cast<const Vec8*>(skips),
      static_cast<float*>(x_out), static_cast<Vec8*>(skips_out), rows, S, R);
  return static_cast<int>(cudaGetLastError());
}

// dxo: (rows, R) float32; dskips: (rows, S) bf16; dp: (rows, S + R) bf16
// out.
extern "C" int idt_wavenet_residual_bwd(const void* dxo, const void* dskips,
                                        void* dp, long long rows, int S,
                                        int R, cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || R <= 0 || S % VEC != 0 || R % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(dxo) || !idt::aligned16(dskips) || !idt::aligned16(dp))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t work = rows * ((S + R) / VEC);
  residual_bwd_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const float*>(dxo), static_cast<const Vec8*>(dskips),
      static_cast<Vec8*>(dp), rows, S, R);
  return static_cast<int>(cudaGetLastError());
}
