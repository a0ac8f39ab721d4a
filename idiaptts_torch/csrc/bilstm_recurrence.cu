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
//   xp     (T, R, 4F) float32, R = ndir*Bp rows: [fwd Bp | bwd Bp]
//   wh     (ndir*F, 4F) bf16 = vstack(Wh_fwd, Wh_bwd)
//   out    (T, R, F) float32 hidden states
//   a      (T, R, 4F) float32 or bf16 gates (training mode only)
//   c      (T, R, F) float32 or bf16 cells (training mode only)
//   hbuf   (2, R, F) bf16 scratch: h_{t-1} / h_t, double-buffered
//   bar    ndir zeroed uint32 arrival counters, 128 bytes apart (one per
//          direction)
// ndir is 2 (both directions), or 1: one direction's instance (ndir*F/8
// blocks), which a tensor-parallel rank launches on its direction's rows
// and Wh.  Its blocks do the arithmetic of that direction's blocks in the
// two-direction launch, so its outputs are that half bit for bit.
//
// What bounds it: the T sequential steps, not bytes or operations.  A
// step is a small GEMM (2*Bp x F x 4F: 25 MFLOP at Bp = 6, 201 MFLOP at
// Bp = 48) spread over 2F/8 SMs, whose h_t every block of the direction
// needs before step t+1 can start.  So a step costs a synchronisation
// across SMs, the L2 round trip of h and the dependent chain of one
// block's product and cell update.  The TPU kernel keeps all of Wh (4 MiB
// of bf16 at F = 512) in one core's VMEM; one SM holds at most 227 KB, so
// here Wh is spread over the SMs.  On an H100 at F = 512
// (probe_bilstm_recurrence.py, PERF.md) the barrier alone costs ~1 us a
// step, the h copies ~0.45 us at Bp = 6 and ~1.2 us at Bp = 48 (every
// block reads its direction's whole h from L2), the wgmma ~0.8 us (the
// 64-row A tile and the B slice come from shared memory at every k step,
// whatever Bp is), and the update, the stores and the release the rest.
//
// Design.  Block (d, unit group) owns 8 hidden units of direction d, i.e.
// the 32 gate columns {q*F + u0 + u : q < 4, u < 8} of Wh_d, and is one
// warpgroup of 128 threads.  At F = 512 that is 64 blocks a direction,
// 128 in all, at most one per SM.
// - Its F x 32 slice of Wh_d is gathered once into shared memory (32 KB
//   at F = 512), K-major in the 128-byte swizzle, in the column order
//   [i u0..u0+7 | f | g | o], and is wgmma's B operand for all T steps.
// - Per step, h_{t-1} of the direction (Bp x F bf16) comes from the
//   L2-resident hbuf by 16-byte cp.async.cg copies into swizzled A tiles
//   of 64 rows (rows past Bp stay zero; Bp > 64 takes more m-tiles, up
//   to MT_MAX), and wgmma m64n32k16 (bf16 in, float32 accumulate), four a
//   64-deep k-block and m-tile, form the recurrent product on the tensor
//   cores.  Both operands are zero past F, so F needs only be a multiple
//   of 16.
// - With that column order a thread's accumulator fragment holds, for
//   rows {16 warp + lane/4, +8} and units u0 + 2(lane % 4) + {0, 1}, all
//   four gates: xp is added, the activations and the cell update run in
//   registers, and c stays in registers for the whole sequence.  h goes
//   out as float2 and bf16x2, the residuals likewise.  xp_{t+1} is loaded
//   into registers a step ahead, and xp_{t+2} prefetched into L2.
// - The two directions never read each other's h, so each direction's
//   blocks meet on their own counter: one release-ordered arrival after
//   the block's bf16 h stores to hbuf, then the step's outputs are stored
//   and xp_{t+1} is loaded (the release waits for neither), then an
//   acquire poll.  The launch is cooperative (the CUDA runtime refuses a
//   grid that cannot be co-resident) and the occupancy is checked first,
//   which makes the spin safe; a wait over 4 s traps.
// Padding rows need no lengths: masked_flip keeps padding at the tail for
// both directions, so every row runs all T steps, as on the TPU.
// Training mode adds 5F residual writes per row and step (0.67 GB of
// float32 at Bp = 32, T = 1024, F = 512), which the card's bandwidth
// absorbs beside the sequential steps.
#include "hopper.cuh"
#include "persistent.cuh"

namespace {

using idt::smem_desc;

constexpr int UNITS = 8;             // hidden units a block
constexpr int COLS = 4 * UNITS;      // its gate columns: the wgmma's N
constexpr int THREADS = 128;         // one warpgroup
constexpr int MT_MAX = 4;            // m-tiles of 64 rows: Bp <= 256
constexpr int A_BLOCK = 64 * 128;    // one m-tile's 64-deep k-block of h
constexpr int B_BLOCK = COLS * 128;  // one 64-deep k-block of the Wh slice
constexpr int BAR_STRIDE = 32;       // uint32 counters 128 bytes apart

// Byte offset of 16-byte chunk `chunk` of row `row` in a block of 128-byte
// rows in the 128-byte swizzle that the descriptors name (chunk XOR row %
// 8; blocks are 1024-byte aligned).
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// D (64 x 32, float32) += A (64 x 16, K-major) . B (16 x 32, K-major).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The activations from ex2.approx (__expf, 2 + 1.16|x| float32 ulps) and
// an approximate reciprocal (__fdividef), far below the bf16 rounding of
// h; they saturate to 0 / +-1 where __expf overflows.  libm's expf, IEEE
// division and tanhf cost ~0.3 us a step more.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int MT, bool TRAIN, typename ResT>
__global__ void __launch_bounds__(THREADS, 1)
bilstm_recurrence_kernel(const float* __restrict__ xp,
                         const __nv_bfloat16* __restrict__ wh,
                         float* __restrict__ out, ResT* __restrict__ a_out,
                         ResT* __restrict__ c_out, __nv_bfloat16* hbuf,
                         unsigned int* bar, int T, int Bp, int F,
                         int ndir) {
  extern __shared__ uint8_t smem_raw[];
  // The Wh slice, then MT m-tiles of h, each as KB k-blocks; 1024-byte
  // aligned, as the swizzle repeats every 8 rows.
  const uint32_t raw = idt::smem_u32(smem_raw);
  const uint32_t b_base = (raw + 1023u) & ~1023u;
  uint8_t* const b_ptr = smem_raw + (b_base - raw);
  const int KB = (F + 63) / 64;
  const uint32_t a_base = b_base + KB * B_BLOCK;
  const int tid = threadIdx.x;
  const int groups = F / UNITS;      // blocks a direction
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x - d * groups) * UNITS;
  const int R = ndir * Bp;
  const int G = 4 * F;
  unsigned int* const counter = bar + d * BAR_STRIDE;

  // Zero the operands: h_{-1} = 0; A rows past Bp are never written and
  // stay 0, and so do both operands' k past F up to the 64-deep k-blocks.
  for (int i = tid; i < KB * (B_BLOCK + MT * A_BLOCK) / 16; i += THREADS)
    reinterpret_cast<uint4*>(b_ptr)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // B row n = 8q + u is gate column q*F + u0 + u of Wh_d, its F k values
  // along the row; one 16-byte load brings one k of a gate's 8 units.
  for (int i = tid; i < 4 * F; i += THREADS) {
    const int k = i >> 2;
    const int q = i & 3;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        wh + static_cast<size_t>(d * F + k) * G + q * F + u0));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint8_t* const blk = b_ptr + (k >> 6) * B_BLOCK + 2 * (k & 7);
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
      *reinterpret_cast<__nv_bfloat16*>(
          blk + swizzled(8 * q + u, (k & 63) >> 3)) = e[u];
  }
  // Generic-proxy writes, read next by wgmma through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // This thread's accumulator fragment: rows r0 and r0 + 8 of each m-tile,
  // units uc and uc + 1, gate q in registers 4q + 2h + e (h: row half, e:
  // unit).
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);
  const int uc = u0 + 2 * (lane & 3);
  float acc[MT][16];
  float2 x[MT][2][4];                 // xp_t: [m-tile][row half][gate]
  float cell[MT][4] = {};             // c: [m-tile][2 * row half + unit]
  float hv[MT][4];                    // h, likewise
  float act[MT][4][4];                // activated gates: [.][gate][.]

  // This thread's xp_t entries; prefetch=true only asks L2 for them, a
  // step ahead of the load.
  auto load_xp = [&](int t, bool prefetch) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * m + r0 + 8 * h;
        if (row < Bp) {
          const float* src =
              xp + (static_cast<size_t>(t) * R + d * Bp + row) * G + uc;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (prefetch)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(src + q * F));
            else
              x[m][h][q] =
                  __ldg(reinterpret_cast<const float2*>(src + q * F));
          }
        }
      }
  };

  // h_{t-1} of this direction into the A tiles: chunk j of row r is 16
  // bytes of hprev's row; __ldcg-like .cg copies read L2, never a stale
  // L1 line.
  const int per_row = F >> 3;
  const int dr = THREADS / per_row;
  const int dj = THREADS - dr * per_row;
  auto load_h = [&](const __nv_bfloat16* hprev) {
    const __nv_bfloat16* src = hprev + static_cast<size_t>(d) * Bp * F;
    int r = tid / per_row;
    int j = tid - r * per_row;
    while (r < Bp) {
      cp_async16(a_base + ((r >> 6) * KB + (j >> 3)) * A_BLOCK +
                     swizzled(r & 63, j & 7),
                 src + (static_cast<size_t>(r) * per_row + j) * 8);
      r += dr;
      j += dj;
      if (j >= per_row) {
        j -= per_row;
        ++r;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  };

  // gates_rec = bf16(h_{t-1}) . Wh slice: four wgmma a 64-deep k-block
  // and m-tile (the zero k past F adds nothing).  A descriptor's address
  // field counts 16 bytes: a k step of 16 (32 bytes along a swizzled row)
  // adds 2, a k-block of A 512, one of B 256.
  const uint64_t a_desc = smem_desc(a_base, 16, 1024);
  const uint64_t b_desc = smem_desc(b_base, 16, 1024);
  auto product = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
      idt::fence_acc(acc[m]);
    }
    for (int kb = 0; kb < KB; ++kb) {
      idt::wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n32k16(acc[m],
                          a_desc + ((m * KB + kb) * A_BLOCK + kk * 32) / 16,
                          b_desc + (kb * B_BLOCK + kk * 32) / 16);
    }
    idt::wgmma_commit();
    idt::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) idt::fence_acc(acc[m]);
  };

  // The cell update in the accumulators, and h_t out to hnext for the
  // other blocks.  Explicit fmaf and separate activations keep the
  // arithmetic identical in both modes.
  auto update = [&](__nv_bfloat16* hnext) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * m + r0 + 8 * h;
        if (row >= Bp) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            g[q] = (e ? x[m][h][q].y : x[m][h][q].x) + acc[m][4 * q + i];
          act[m][0][i] = sigmoid_fast(g[0]);
          act[m][1][i] = sigmoid_fast(g[1] + 1.f);
          act[m][2][i] = tanh_fast(g[2]);
          act[m][3][i] = sigmoid_fast(g[3]);
          cell[m][i] = fmaf(act[m][1][i], cell[m][i],
                            act[m][0][i] * act[m][2][i]);
          hv[m][i] = act[m][3][i] * tanh_fast(cell[m][i]);
        }
        store2(hnext + (static_cast<size_t>(d) * Bp + row) * F + uc,
               hv[m][2 * h], hv[m][2 * h + 1]);
      }
  };

  // The step's outputs, stored after the arrival: the barrier's release
  // waits for hnext's stores only.
  auto store_outputs = [&](int t) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * m + r0 + 8 * h;
        if (row >= Bp) continue;
        const int i = 2 * h;
        const size_t trow = static_cast<size_t>(t) * R + d * Bp + row;
        store2(out + trow * F + uc, hv[m][i], hv[m][i + 1]);
        if constexpr (TRAIN) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            store2(a_out + trow * G + q * F + uc, act[m][q][i],
                   act[m][q][i + 1]);
          store2(c_out + trow * F + uc, cell[m][i], cell[m][i + 1]);
        }
      }
  };

  load_xp(0, false);
  if (T > 1) load_xp(1, true);
  for (int t = 0; t < T; ++t) {
    if (t > 0) load_h(hbuf + static_cast<size_t>((t + 1) & 1) * R * F);
    product();
    update(hbuf + static_cast<size_t>(t & 1) * R * F);
    const bool last = t + 1 == T;
    if (!last) idt::group_arrive(counter);
    store_outputs(t);
    if (last) break;
    load_xp(t + 1, false);
    if (t + 2 < T) load_xp(t + 2, true);
    idt::group_wait(counter, static_cast<unsigned int>(t + 1) * groups);
  }
}

template <int MT, bool TRAIN, typename ResT>
int launch_tiles(const void* xp, const void* wh, void* out, void* a,
                 void* c, void* hbuf, void* bar, int T, int Bp, int F,
                 int ndir, cudaStream_t stream) {
  const float* xp_ = static_cast<const float*>(xp);
  const __nv_bfloat16* wh_ = static_cast<const __nv_bfloat16*>(wh);
  float* out_ = static_cast<float*>(out);
  ResT* a_ = static_cast<ResT*>(a);
  ResT* c_ = static_cast<ResT*>(c);
  __nv_bfloat16* hbuf_ = static_cast<__nv_bfloat16*>(hbuf);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&xp_, &wh_, &out_, &a_,  &c_, &hbuf_,
                  &bar_, &T,  &Bp,   &F, &ndir};
  const size_t kb = static_cast<size_t>((F + 63) / 64);
  const size_t smem = 1024 + kb * (B_BLOCK + MT * A_BLOCK);
  return static_cast<int>(idt::launch_persistent(
      bilstm_recurrence_kernel<MT, TRAIN, ResT>, ndir * (F / UNITS),
      THREADS, smem, args, bar_, stream,
      ndir * BAR_STRIDE * sizeof(unsigned int)));
}

template <bool TRAIN, typename ResT>
int launch(const void* xp, const void* wh, void* out, void* a, void* c,
           void* hbuf, void* bar, int T, int Bp, int F, int ndir,
           cudaStream_t stream) {
  // F a multiple of 16: whole wgmma k steps, 16-byte rows of h and of a
  // gate's 8 units.  Beyond that, what the shared memory (Wh slice + m
  // tiles) and co-residency (ndir*F/8 blocks) admit; launch_persistent
  // refuses the rest.
  const uintptr_t align = reinterpret_cast<uintptr_t>(xp) |
                          reinterpret_cast<uintptr_t>(wh) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(c) |
                          reinterpret_cast<uintptr_t>(hbuf) |
                          reinterpret_cast<uintptr_t>(bar);
  if (T <= 0 || Bp <= 0 || F <= 0 || F % 16 != 0 || Bp > 64 * MT_MAX ||
      (ndir != 1 && ndir != 2) || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((Bp + 63) / 64) {
    case 1:
      return launch_tiles<1, TRAIN, ResT>(xp, wh, out, a, c, hbuf, bar, T,
                                          Bp, F, ndir, stream);
    case 2:
      return launch_tiles<2, TRAIN, ResT>(xp, wh, out, a, c, hbuf, bar, T,
                                          Bp, F, ndir, stream);
    case 3:
      return launch_tiles<3, TRAIN, ResT>(xp, wh, out, a, c, hbuf, bar, T,
                                          Bp, F, ndir, stream);
    default:
      return launch_tiles<4, TRAIN, ResT>(xp, wh, out, a, c, hbuf, bar, T,
                                          Bp, F, ndir, stream);
  }
}

}  // namespace

extern "C" int idt_bilstm_recurrence(const void* xp, const void* wh,
                                     void* out, void* hbuf, void* bar, int T,
                                     int Bp, int F, int ndir,
                                     cudaStream_t stream) {
  return launch<false, float>(xp, wh, out, nullptr, nullptr, hbuf, bar, T,
                              Bp, F, ndir, stream);
}

extern "C" int idt_bilstm_recurrence_train(const void* xp, const void* wh,
                                           void* out, void* a, void* c,
                                           void* hbuf, void* bar, int T,
                                           int Bp, int F, int ndir,
                                           int res_bf16, cudaStream_t stream) {
  if (res_bf16)
    return launch<true, __nv_bfloat16>(xp, wh, out, a, c, hbuf, bar, T, Bp,
                                       F, ndir, stream);
  return launch<true, float>(xp, wh, out, a, c, hbuf, bar, T, Bp, F, ndir,
                             stream);
}
