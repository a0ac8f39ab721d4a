// BiLSTM recurrence over precomputed input projections, both directions,
// all T steps, in one persistent launch; inference and training mode.
//
// Replaces idiaptts_tpu/ops/pallas_lstm.py:_bilstm_kernel (wrapper
// _recurrence_tmajor) and the recurrence half of _bilstm_layer_kernel
// (entry point idt_bilstm_recurrence), and _bilstm_kernel_train (wrapper
// _recurrence_train_tmajor) and the recurrence half of
// _bilstm_layer_kernel_train (entry point idt_bilstm_recurrence_train).
// Per step, for every row (one sequence of one direction):
//   gates = xp_t + bf16(h_{t-1}) . bf16(Wh_d)     (float32 accumulation)
//   c = sigmoid(f + 1) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
// gate order [i, f, g, o]; h and c carried in float32, h rounded to bf16
// only as the next step's matmul operand (pallas_lstm.py:101).
//
// Training mode additionally streams out the backward kernel's residuals
// (pallas_lstm.py:182-195): the post-activation gates
// a[t, row, q*F + u] = [sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o)]
// and the cells c[t, row, u], in float32 or bf16.  The carries stay
// float32 and both modes are one template body, so training-mode h is
// bit-identical to inference-mode h on the same inputs.
//
// Layout (the JAX package's time-major layout):
//   xp     (T, R, 4F) float32, R = 2*Bp rows: [fwd Bp | bwd Bp]
//   wh     (2F, 4F) bf16 = vstack(Wh_fwd, Wh_bwd)
//   out    (T, R, F) float32 hidden states
//   a      (T, R, 4F) float32 or bf16 gates (training mode only)
//   c      (T, R, F) float32 or bf16 cells (training mode only)
//   hbuf   (2, R, F) bf16 scratch: h_{t-1} / h_t, double-buffered
//   bar    one zeroed uint32: the grid barrier's arrival counter
//
// Design.  The TPU kernel keeps all of Wh (4 MiB of bf16 at F = 512) in
// one core's VMEM; one SM holds at most 227 KB, so that does not carry
// over.  Here Wh is spread over the SMs and held in REGISTERS for the
// whole sequence: block (d, unit group) owns 8 hidden units of direction
// d, i.e. the 32 gate columns {q*F + u0 + u : q < 4, u < 8} of Wh_d.  It
// runs F threads (F/32 warps); lane j owns column j and warp w owns the
// k-slice [32w, 32w+32), so each thread keeps 32 weights in registers.
// At F = 512 that is 64 blocks per direction, 128 in all, one per SM.
// Per step each block reads h_{t-1} of its direction (bf16, from L2),
// forms partial dot products per warp, reduces them through shared
// memory, updates its units' c (kept in shared memory) and h, writes
// h_t, and meets one grid-wide barrier.  Padding rows need no lengths:
// masked_flip keeps padding at the tail for both directions, so every
// row runs all T steps, as on the TPU.
//
// The barrier spins on a global counter, so every block must be resident
// at once: the launch is cooperative (the CUDA runtime refuses a grid
// that cannot be co-resident) and the occupancy is checked first.
//
// What bounds it: the T sequential steps.  Each step is a small GEMM
// (2*Bp x F x 4F: 25 MFLOP at Bp = 6, 201 MFLOP at Bp = 48) spread over
// 128 SMs.  At small batch a step costs the grid barrier, the L2 round
// trip of h and the dependent FMA chain, not bandwidth; at Bp = 48 the
// CUDA-core FMAs themselves.  This first version keeps to CUDA-core FMAs
// (no mma) for simplicity; tensor-core steps are later work.  Training
// mode adds 5F residual writes per row and step (T*R*5F elements per
// layer, 0.67 GB of float32 at Bp = 32, T = 1024, F = 512), which the
// card's bandwidth absorbs beside the sequential steps.
#include "persistent.cuh"

namespace {

using idt::sigmoidf_;

constexpr int UNITS = 8;            // hidden units per block
constexpr int COLS = 4 * UNITS;     // gate columns per block, one per lane
constexpr int KS = 32;              // k-slice per warp
constexpr int MAX_THREADS = 512;    // F <= 512

template <bool TRAIN, typename ResT>
__global__ void __launch_bounds__(MAX_THREADS)
bilstm_recurrence_kernel(const float* __restrict__ xp,
                         const __nv_bfloat16* __restrict__ wh,
                         float* __restrict__ out, ResT* __restrict__ a_out,
                         ResT* __restrict__ c_out, __nv_bfloat16* hbuf,
                         unsigned int* bar, int T, int Bp, int F) {
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x / 32;   // warps = F / 32
  const int RC = NW;                // rows per chunk (RC * 32 == threads)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = F / UNITS;
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x % groups) * UNITS;
  const int R = 2 * Bp;
  const int G = 4 * F;

  float* h_s = smem;                        // RC x F
  float* part = h_s + RC * F;               // NW x RC x COLS
  float* g_s = part + NW * RC * COLS;       // RC x COLS
  float* c_s = g_s + RC * COLS;             // Bp x UNITS

  // This lane's gate column and this warp's k-slice of Wh_d, resident in
  // registers for all T steps.
  const int col = (lane / UNITS) * F + u0 + (lane % UNITS);
  float w[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k)
    w[k] = __bfloat162float(
        wh[static_cast<size_t>(d * F + warp * KS + k) * G + col]);

  for (int i = tid; i < Bp * UNITS; i += blockDim.x) c_s[i] = 0.f;

  // One xp entry per thread per chunk: row e_r, column e_j.
  const int e_r = tid / COLS;
  const int e_j = tid % COLS;
  const int e_col = (e_j / UNITS) * F + u0 + (e_j % UNITS);

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hprev =
        hbuf + static_cast<size_t>((t + 1) & 1) * R * F;
    __nv_bfloat16* hnext = hbuf + static_cast<size_t>(t & 1) * R * F;
    for (int r0 = 0; r0 < Bp; r0 += RC) {
      const int nrows = min(RC, Bp - r0);
      const int nrows4 = (nrows + 3) & ~3;
      // Start this chunk's projection load early; it is consumed after
      // the dot products.
      float xval = 0.f;
      if (e_r < nrows)
        xval = xp[(static_cast<size_t>(t) * R + d * Bp + r0 + e_r) * G +
                  e_col];
      // h_{t-1} rows of this chunk -> shared memory as float; zero rows
      // beyond the batch and at t = 0.  __ldcg reads L2, never a stale
      // L1 line left from two steps ago.
      const int chunks_per_row = F / 8;
      for (int c = tid; c < nrows4 * chunks_per_row; c += blockDim.x) {
        const int rl = c / chunks_per_row;
        const int k8 = (c - rl * chunks_per_row) * 8;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 hi = lo;
        if (t > 0 && rl < nrows) {
          const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
              hprev + static_cast<size_t>(d * Bp + r0 + rl) * F + k8));
          idt::unpack_bf16x8(v, lo, hi);
        }
        *reinterpret_cast<float4*>(&h_s[rl * F + k8]) = lo;
        *reinterpret_cast<float4*>(&h_s[rl * F + k8 + 4]) = hi;
      }
      __syncthreads();
      // Partial dot products over this warp's k-slice, 4 rows at a time
      // (4 independent FMA chains).
      for (int rg = 0; rg < nrows4; rg += 4) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const float* hr = h_s + rg * F + warp * KS;
#pragma unroll
        for (int k = 0; k < KS; k += 4) {
          const float4 h0 = *reinterpret_cast<const float4*>(hr + k);
          const float4 h1 = *reinterpret_cast<const float4*>(hr + F + k);
          const float4 h2 = *reinterpret_cast<const float4*>(hr + 2 * F + k);
          const float4 h3 = *reinterpret_cast<const float4*>(hr + 3 * F + k);
          a0 = fmaf(h0.x, w[k], a0); a0 = fmaf(h0.y, w[k + 1], a0);
          a0 = fmaf(h0.z, w[k + 2], a0); a0 = fmaf(h0.w, w[k + 3], a0);
          a1 = fmaf(h1.x, w[k], a1); a1 = fmaf(h1.y, w[k + 1], a1);
          a1 = fmaf(h1.z, w[k + 2], a1); a1 = fmaf(h1.w, w[k + 3], a1);
          a2 = fmaf(h2.x, w[k], a2); a2 = fmaf(h2.y, w[k + 1], a2);
          a2 = fmaf(h2.z, w[k + 2], a2); a2 = fmaf(h2.w, w[k + 3], a2);
          a3 = fmaf(h3.x, w[k], a3); a3 = fmaf(h3.y, w[k + 1], a3);
          a3 = fmaf(h3.z, w[k + 2], a3); a3 = fmaf(h3.w, w[k + 3], a3);
        }
        float* p = part + (warp * RC + rg) * COLS + lane;
        p[0] = a0;
        p[COLS] = a1;
        p[2 * COLS] = a2;
        p[3 * COLS] = a3;
      }
      __syncthreads();
      // Reduce over warps: gates = xp + rec.
      if (e_r < nrows) {
        float rec = 0.f;
        for (int ww = 0; ww < NW; ++ww)
          rec += part[(ww * RC + e_r) * COLS + e_j];
        g_s[e_r * COLS + e_j] = xval + rec;
      }
      __syncthreads();
      // Cell update for (row, unit) pairs of this chunk.  Explicit fmaf
      // and separate activations keep the arithmetic identical in both
      // modes.
      if (tid < nrows * UNITS) {
        const int rl = tid / UNITS;
        const int uu = tid % UNITS;
        const float* g = g_s + rl * COLS;
        const float si = sigmoidf_(g[uu]);
        const float sf = sigmoidf_(g[UNITS + uu] + 1.f);
        const float tg = tanhf(g[2 * UNITS + uu]);
        const float so = sigmoidf_(g[3 * UNITS + uu]);
        float* cp = c_s + (r0 + rl) * UNITS + uu;
        const float c = fmaf(sf, *cp, si * tg);
        const float h = so * tanhf(c);
        *cp = c;
        const size_t row = static_cast<size_t>(d * Bp + r0 + rl);
        const size_t trow = static_cast<size_t>(t) * R + row;
        out[trow * F + u0 + uu] = h;
        hnext[row * F + u0 + uu] = __float2bfloat16_rn(h);
        if constexpr (TRAIN) {
          ResT* ar = a_out + trow * G + u0 + uu;
          ar[0] = idt::from_float<ResT>(si);
          ar[F] = idt::from_float<ResT>(sf);
          ar[2 * F] = idt::from_float<ResT>(tg);
          ar[3 * F] = idt::from_float<ResT>(so);
          c_out[trow * F + u0 + uu] = idt::from_float<ResT>(c);
        }
      }
      __syncthreads();
    }
    idt::grid_barrier(bar, static_cast<unsigned int>(t + 1) * gridDim.x);
  }
}

size_t smem_bytes(int Bp, int F) {
  const int RC = F / 32;
  const int NW = F / 32;
  return sizeof(float) *
         (static_cast<size_t>(RC) * F + static_cast<size_t>(NW) * RC * COLS +
          static_cast<size_t>(RC) * COLS + static_cast<size_t>(Bp) * UNITS);
}

template <bool TRAIN, typename ResT>
int launch(const void* xp, const void* wh, void* out, void* a, void* c,
           void* hbuf, void* bar, int T, int Bp, int F,
           cudaStream_t stream) {
  // F a multiple of 128 keeps the chunk height (F/32 rows) a multiple of
  // the 4-row FMA group; F <= 512 keeps the block within MAX_THREADS.
  if (T <= 0 || Bp <= 0 || F <= 0 || F % 128 != 0 || F > MAX_THREADS ||
      reinterpret_cast<uintptr_t>(hbuf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp_ = static_cast<const float*>(xp);
  const __nv_bfloat16* wh_ = static_cast<const __nv_bfloat16*>(wh);
  float* out_ = static_cast<float*>(out);
  ResT* a_ = static_cast<ResT*>(a);
  ResT* c_ = static_cast<ResT*>(c);
  __nv_bfloat16* hbuf_ = static_cast<__nv_bfloat16*>(hbuf);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&xp_, &wh_, &out_, &a_, &c_, &hbuf_, &bar_, &T, &Bp, &F};
  return static_cast<int>(idt::launch_persistent(
      bilstm_recurrence_kernel<TRAIN, ResT>, 2 * (F / UNITS), F,
      smem_bytes(Bp, F), args, bar_, stream));
}

}  // namespace

extern "C" int idt_bilstm_recurrence(const void* xp, const void* wh,
                                     void* out, void* hbuf, void* bar, int T,
                                     int Bp, int F, cudaStream_t stream) {
  return launch<false, float>(xp, wh, out, nullptr, nullptr, hbuf, bar, T,
                              Bp, F, stream);
}

extern "C" int idt_bilstm_recurrence_train(const void* xp, const void* wh,
                                           void* out, void* a, void* c,
                                           void* hbuf, void* bar, int T,
                                           int Bp, int F, int res_bf16,
                                           cudaStream_t stream) {
  if (res_bf16)
    return launch<true, __nv_bfloat16>(xp, wh, out, a, c, hbuf, bar, T, Bp,
                                       F, stream);
  return launch<true, float>(xp, wh, out, a, c, hbuf, bar, T, Bp, F, stream);
}
