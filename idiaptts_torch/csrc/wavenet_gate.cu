// WaveNet gated activation for teacher-forced training, forward and
// backward, in bf16 with the plain path's rounding chain.
//
// Replaces no TPU kernel: the JAX package left the teacher-forced
// network to XLA, which fuses the bias adds and the gate into the
// convolutions' epilogues.  On the card the dilated convolution, the
// conditioning, skip and residual products are cuBLAS bf16 products
// (ops/wavenet_block.py, the residual block's autograd function); this
// kernel is the elementwise work between the first two and the last,
// which PyTorch would run as about a dozen passes over (rows, gate)
// tensors, each saved for autograd.
//
// Forward, per row and gate column pair (c, c + H), H = G / 2, from the
// bf16 products P1 = bf(taps . W) and P2 = bf(cond . Wc):
//   h = bf(bf(P1 + b1) + bf(P2 + b2))          (b1, b2 bf16)
//   z = bf(bf(tanh(h_a)) * bf(sigmoid(h_b)))  (a = h[:, :H], b = h[:, H:])
// h is written for the backward, which recomputes tanh and sigmoid from
// it.  Backward, from dz = dL/dz (bf16):
//   dh_a = bf(bf(dz * bf(sigmoid(h_b))) * (1 - t * t)),   t = tanh(h_a)
//   dh_b = bf(bf(dz * bf(t)) * ((1 - s) * s)),            s = sigmoid(h_b)
// which is what autograd gives through the plain path's roundings
// (models/wavenet.py, ResidualBlock.forward; ops/wavenet_gate.py
// holds the same chain as gate_plain / gate_backward_plain).  Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn), so no
// fused multiply-add moves a rounding.
//
// What bounds it: bytes.  A row moves 2G bf16 in and G + H out forward,
// G + H in and G out backward, against ~30 operations a column: far
// below the card's ~295 operations a byte.  So each thread moves 16
// bytes (8 bf16) per load and store, a warp covers contiguous 512-byte
// spans, and a grid-stride loop keeps a few waves of blocks resident.
#include "bf16_vec.cuh"

namespace {

using idt::Vec8;
using idt::VEC;
using idt::bf;
using idt::unpack;
using idt::pack;
constexpr int THREADS = idt::EW_THREADS;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// One thread: VEC columns of the a half and the same columns of the b
// half of one row.
__global__ void __launch_bounds__(THREADS)
wavenet_gate_fwd_kernel(const Vec8* __restrict__ p1,
                        const Vec8* __restrict__ p2,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ b2,
                        Vec8* __restrict__ h, Vec8* __restrict__ z,
                        int64_t rows, int G) {
  const int hv = G / 2 / VEC;     // vectors in a half row
  const int64_t total = rows * hv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / hv;
    const int c = (int)(i - r * hv);
    const int64_t ia = r * (2 * hv) + c;   // vector index of the a half
    const int64_t ib = ia + hv;            // and of the b half
    float pa1[VEC], pb1[VEC], pa2[VEC], pb2[VEC];
    unpack(p1[ia], pa1);
    unpack(p1[ib], pb1);
    unpack(p2[ia], pa2);
    unpack(p2[ib], pb2);
    float ha[VEC], hb[VEC], zz[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ca = c * VEC + j;
      const int cb = ca + G / 2;
      ha[j] = bf(__fadd_rn(bf(__fadd_rn(pa1[j], __bfloat162float(b1[ca]))),
                           bf(__fadd_rn(pa2[j], __bfloat162float(b2[ca])))));
      hb[j] = bf(__fadd_rn(bf(__fadd_rn(pb1[j], __bfloat162float(b1[cb]))),
                           bf(__fadd_rn(pb2[j], __bfloat162float(b2[cb])))));
      zz[j] = __fmul_rn(bf(tanhf(ha[j])), bf(sigmoid(hb[j])));
    }
    h[ia] = pack(ha);
    h[ib] = pack(hb);
    z[r * hv + c] = pack(zz);
  }
}

__global__ void __launch_bounds__(THREADS)
wavenet_gate_bwd_kernel(const Vec8* __restrict__ h,
                        const Vec8* __restrict__ dz,
                        Vec8* __restrict__ dh, int64_t rows, int G) {
  const int hv = G / 2 / VEC;
  const int64_t total = rows * hv;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / hv;
    const int c = (int)(i - r * hv);
    const int64_t ia = r * (2 * hv) + c;
    const int64_t ib = ia + hv;
    float ha[VEC], hb[VEC], g[VEC], da[VEC], db[VEC];
    unpack(h[ia], ha);
    unpack(h[ib], hb);
    unpack(dz[r * hv + c], g);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = tanhf(ha[j]);
      const float s = sigmoid(hb[j]);
      const float dt = bf(__fmul_rn(g[j], bf(s)));
      const float ds = bf(__fmul_rn(g[j], bf(t)));
      da[j] = __fmul_rn(dt, __fsub_rn(1.0f, __fmul_rn(t, t)));
      db[j] = __fmul_rn(__fmul_rn(ds, __fsub_rn(1.0f, s)), s);
    }
    dh[ia] = pack(da);
    dh[ib] = pack(db);
  }
}

}  // namespace

// p_conv, p_cond: (rows, G) bf16; b_conv, b_cond: (G,) bf16; h: (rows, G)
// bf16 out; z: (rows, G / 2) bf16 out.  G / 2 must be a multiple of 8 and
// every row pointer 16-byte aligned.
extern "C" int idt_wavenet_gate_fwd(const void* p_conv, const void* p_cond,
                                    const void* b_conv, const void* b_cond,
                                    void* h, void* z, long long rows, int G,
                                    cudaStream_t stream) {
  if (rows <= 0 || G <= 0 || (G / 2) % VEC != 0 || G % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(p_conv) || !idt::aligned16(p_cond) ||
      !idt::aligned16(h) || !idt::aligned16(z))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t work = rows * (G / 2 / VEC);
  wavenet_gate_fwd_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const Vec8*>(p_conv), static_cast<const Vec8*>(p_cond),
      static_cast<const __nv_bfloat16*>(b_conv),
      static_cast<const __nv_bfloat16*>(b_cond), static_cast<Vec8*>(h),
      static_cast<Vec8*>(z), rows, G);
  return static_cast<int>(cudaGetLastError());
}

// h: (rows, G) bf16 from the forward; dz: (rows, G / 2) bf16; dh: (rows, G)
// bf16 out.
extern "C" int idt_wavenet_gate_bwd(const void* h, const void* dz, void* dh,
                                    long long rows, int G,
                                    cudaStream_t stream) {
  if (rows <= 0 || G <= 0 || (G / 2) % VEC != 0 || G % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!idt::aligned16(h) || !idt::aligned16(dz) || !idt::aligned16(dh))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t work = rows * (G / 2 / VEC);
  wavenet_gate_bwd_kernel<<<idt::ew_grid(work), THREADS, 0, stream>>>(
      static_cast<const Vec8*>(h), static_cast<const Vec8*>(dz),
      static_cast<Vec8*>(dh), rows, G);
  return static_cast<int>(cudaGetLastError());
}
