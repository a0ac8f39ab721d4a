// Reverse-time BiLSTM backward (the sequential part), both directions,
// all T steps, in one persistent launch.
//
// Replaces idiaptts_tpu/ops/pallas_lstm.py:_bilstm_bwd_kernel (wrapper
// _dz_bwd_tmajor).  Walking t = T-1 ... 0 with float32 carries dh and
// dc (pallas_lstm.py:297-325):
//   dh_tot = dL/dh_t + dh
//   dc    += dh_tot * o * (1 - tanh(c_t)^2)
//   dz_i = dc * g * i(1-i)        dz_f = dc * c_{t-1} * f(1-f)
//   dz_g = dc * i * (1 - g^2)     dz_o = dh_tot * tanh(c_t) * o(1-o)
//   dc   *= f
//   dh    = bf16(dz) . Wh_d^T     (float32 accumulation, per direction)
// from the training-mode forward's residuals (post-activation gates
// a = [i, f, g, o], with f = sigmoid(f_pre + 1), and cells c), which
// arrive in float32 or bf16.  dz leaves in float32; the weight and
// input gradients are GEMMs outside this kernel.
//
// Layout (the JAX package's time-major layout, R = 2*Bp rows
// [fwd Bp | bwd Bp]):
//   a      (T, R, 4F) float32 or bf16
//   c      (T, R, F) same type; c_{t-1} is read from it (zero at t = 0)
//   gout   (T, R, F) same type, the upstream cotangent dL/dh
//   wh     (2F, 4F) bf16 = vstack(Wh_fwd, Wh_bwd)
//   dz     (T, R, 4F) float32 out
//   dzbuf  (2, R, 4F) bf16 scratch: dz_{t+1} / dz_t, double-buffered
//   bar    one zeroed uint32: the grid barrier's arrival counter
//
// Design: the mirror of bilstm_recurrence.cu.  Block (d, unit group) owns
// 8 hidden units u0..u0+7 of direction d and keeps the matching 8 rows
// of Wh_d (8 x 4F bf16) in REGISTERS for the whole sequence: F threads,
// lane = (unit uu = lane % 8, k-part kp = lane / 8), warp w owns gate
// columns [128w, 128w + 128), so each thread holds 32 weights.  Per step
// each block
//   1. reads dz_{t+1} of its direction's rows (bf16, all 4F columns) from
//      the L2 exchange buffer with __ldcg (L1 is not coherent across SMs),
//   2. forms its units' dh with float32 FMAs, reduced over the 4 k-parts
//      by warp shuffles and over the warps through shared memory,
//   3. adds dL/dh_t, updates dc (kept in shared memory) and emits dz_t for
//      its 32 gate columns: float32 to dz, bf16 to the exchange buffer,
// and meets one grid-wide barrier.  The launch is cooperative, after an
// occupancy check (128 blocks of 512 threads at F = 512).  Padding rows
// carry zero residuals and zero cotangent, so their dz stays zero.
//
// What bounds it: the T sequential steps, as the forward.  A step is the
// same (2*Bp x 4F x F) product as the forward's, but each block reads
// its rows' whole dz (4F columns) from L2 where the forward reads F
// columns of h, so L2 traffic per step is 4x the forward's.  CUDA-core
// FMAs only; tensor-core steps are later work.
#include "persistent.cuh"

namespace {

constexpr int UNITS = 8;          // hidden units per block
constexpr int KS = 32;            // gate columns per lane
constexpr int KPARTS = 32 / UNITS;
constexpr int MAX_THREADS = 512;  // F <= 512

// One (row, unit) pair's residuals at step t.
struct Res {
  float i, f, g, o, c, cprev, gout;
};

template <typename ResT>
__device__ __forceinline__ Res load_res(const ResT* __restrict__ a,
                                        const ResT* __restrict__ c,
                                        const ResT* __restrict__ gout,
                                        int t, int row, int u, int R, int F) {
  const size_t ta = (static_cast<size_t>(t) * R + row) * 4 * F + u;
  const size_t tc = (static_cast<size_t>(t) * R + row) * F + u;
  Res r;
  r.i = idt::to_float(a[ta]);
  r.f = idt::to_float(a[ta + F]);
  r.g = idt::to_float(a[ta + 2 * F]);
  r.o = idt::to_float(a[ta + 3 * F]);
  r.c = idt::to_float(c[tc]);
  r.cprev = t > 0 ? idt::to_float(c[tc - static_cast<size_t>(R) * F]) : 0.f;
  r.gout = idt::to_float(gout[tc]);
  return r;
}

__device__ __forceinline__ float dot8(const uint4& v, const float* w,
                                      float acc) {
  float4 lo, hi;
  idt::unpack_bf16x8(v, lo, hi);
  acc = fmaf(lo.x, w[0], acc);
  acc = fmaf(lo.y, w[1], acc);
  acc = fmaf(lo.z, w[2], acc);
  acc = fmaf(lo.w, w[3], acc);
  acc = fmaf(hi.x, w[4], acc);
  acc = fmaf(hi.y, w[5], acc);
  acc = fmaf(hi.z, w[6], acc);
  acc = fmaf(hi.w, w[7], acc);
  return acc;
}

template <typename ResT>
__global__ void __launch_bounds__(MAX_THREADS)
bilstm_bwd_kernel(const ResT* __restrict__ a, const ResT* __restrict__ c,
                  const ResT* __restrict__ gout,
                  const __nv_bfloat16* __restrict__ wh,
                  float* __restrict__ dz, __nv_bfloat16* dzbuf,
                  unsigned int* bar, int T, int Bp, int F) {
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x / 32;   // warps = F / 32
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = F / UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * UNITS;
  const int R = 2 * Bp;
  const int G = 4 * F;
  const int pairs = Bp * UNITS;

  float* part = smem;                  // NW x Bp x UNITS
  float* dc_s = part + NW * Bp * UNITS;  // Bp x UNITS

  // This lane's unit and gate-column slice of Wh_d, resident in registers.
  const int uu_l = lane % UNITS;
  const int kbase = warp * (KPARTS * KS) + (lane / UNITS) * KS;
  float w[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k)
    w[k] = __bfloat162float(
        wh[static_cast<size_t>(d * F + u0 + uu_l) * G + kbase + k]);

  for (int i = tid; i < pairs; i += blockDim.x) dc_s[i] = 0.f;

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const __nv_bfloat16* dzprev =
        dzbuf + static_cast<size_t>((s + 1) & 1) * R * G;
    __nv_bfloat16* dznext = dzbuf + static_cast<size_t>(s & 1) * R * G;
    // Start this thread's first pair's residual loads; they are consumed
    // after the recurrent product.
    Res pre = {};
    if (tid < pairs)
      pre = load_res(a, c, gout, t, d * Bp + tid / UNITS, u0 + tid % UNITS,
                     R, F);
    // dh partials from dz_{t+1}, two rows at a time.
    if (s > 0) {
      for (int r = 0; r < Bp; r += 2) {
        const bool two = r + 1 < Bp;
        const uint4* p0 = reinterpret_cast<const uint4*>(
            dzprev + static_cast<size_t>(d * Bp + r) * G + kbase);
        const uint4* p1 = p0 + G / 8;
        uint4 v0[KS / 8], v1[KS / 8];
#pragma unroll
        for (int q = 0; q < KS / 8; ++q) {
          v0[q] = __ldcg(p0 + q);
          v1[q] = two ? __ldcg(p1 + q) : make_uint4(0u, 0u, 0u, 0u);
        }
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int q = 0; q < KS / 8; ++q) {
          a0 = dot8(v0[q], w + 8 * q, a0);
          a1 = dot8(v1[q], w + 8 * q, a1);
        }
        // Sum the 4 k-parts of each unit (lanes uu, uu+8, uu+16, uu+24).
        a0 += __shfl_xor_sync(0xffffffffu, a0, 8);
        a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 8);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
        if (lane < UNITS) {
          part[(warp * Bp + r) * UNITS + lane] = a0;
          if (two) part[(warp * Bp + r + 1) * UNITS + lane] = a1;
        }
      }
    }
    __syncthreads();
    for (int p = tid; p < pairs; p += blockDim.x) {
      const int rl = p / UNITS;
      const int uu = p % UNITS;
      const int row = d * Bp + rl;
      const int u = u0 + uu;
      const Res r = p == tid ? pre : load_res(a, c, gout, t, row, u, R, F);
      float dh = 0.f;
      if (s > 0)
        for (int ww = 0; ww < NW; ++ww) dh += part[(ww * Bp + rl) * UNITS + uu];
      const float dh_tot = r.gout + dh;
      const float tc = tanhf(r.c);
      const float dc = dc_s[p] + dh_tot * r.o * (1.f - tc * tc);
      const float dzi = dc * r.g * (r.i * (1.f - r.i));
      const float dzf = dc * r.cprev * (r.f * (1.f - r.f));
      const float dzg = dc * r.i * (1.f - r.g * r.g);
      const float dzo = dh_tot * tc * (r.o * (1.f - r.o));
      dc_s[p] = dc * r.f;
      const size_t base = (static_cast<size_t>(t) * R + row) * G + u;
      dz[base] = dzi;
      dz[base + F] = dzf;
      dz[base + 2 * F] = dzg;
      dz[base + 3 * F] = dzo;
      __nv_bfloat16* x = dznext + static_cast<size_t>(row) * G + u;
      x[0] = __float2bfloat16_rn(dzi);
      x[F] = __float2bfloat16_rn(dzf);
      x[2 * F] = __float2bfloat16_rn(dzg);
      x[3 * F] = __float2bfloat16_rn(dzo);
    }
    idt::grid_barrier(bar, static_cast<unsigned int>(s + 1) * gridDim.x);
  }
}

template <typename ResT>
int launch(const void* a, const void* c, const void* gout, const void* wh,
           void* dz, void* dzbuf, void* bar, int T, int Bp, int F,
           cudaStream_t stream) {
  // F a multiple of 128 (as the forward) and <= 512 keeps F threads, 4F
  // gate columns split 128 per warp, and the block within MAX_THREADS.
  if (T <= 0 || Bp <= 0 || F <= 0 || F % 128 != 0 || F > MAX_THREADS ||
      reinterpret_cast<uintptr_t>(dzbuf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ResT* a_ = static_cast<const ResT*>(a);
  const ResT* c_ = static_cast<const ResT*>(c);
  const ResT* g_ = static_cast<const ResT*>(gout);
  const __nv_bfloat16* wh_ = static_cast<const __nv_bfloat16*>(wh);
  float* dz_ = static_cast<float*>(dz);
  __nv_bfloat16* dzbuf_ = static_cast<__nv_bfloat16*>(dzbuf);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&a_, &c_, &g_, &wh_, &dz_, &dzbuf_, &bar_, &T, &Bp, &F};
  const size_t smem = sizeof(float) * static_cast<size_t>(F / 32 + 1) * Bp *
                      UNITS;
  return static_cast<int>(idt::launch_persistent(
      bilstm_bwd_kernel<ResT>, 2 * (F / UNITS), F, smem, args, bar_,
      stream));
}

}  // namespace

extern "C" int idt_bilstm_bwd(const void* a, const void* c, const void* gout,
                              const void* wh, void* dz, void* dzbuf,
                              void* bar, int T, int Bp, int F, int res_bf16,
                              cudaStream_t stream) {
  if (res_bf16)
    return launch<__nv_bfloat16>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 stream);
  return launch<float>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F, stream);
}
