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
// Layout (the JAX package's time-major layout, R = ndir*Bp rows
// [fwd Bp | bwd Bp]):
//   a      (T, R, 4F) float32 or bf16
//   c      (T, R, F) same type; c_{t-1} is read from it (zero at t = 0)
//   gout   (T, R, F) same type, the upstream cotangent dL/dh
//   wh     (ndir*F, 4F) bf16 = vstack(Wh_fwd, Wh_bwd)
//   dz     (T, R, 4F) float32 out
//   dzbuf  bf16 scratch of at least 2 x R x 6F: dz_{t+1} / dz_t,
//          double-buffered, chunk-major (below)
//   bar    ndir zeroed uint32 arrival counters, 128 bytes apart (one per
//          direction)
// ndir is 2 (both directions), or 1: one direction's instance (ndir*F/8
// blocks), which a tensor-parallel rank launches on its direction's rows
// and Wh; its dz is that half of the two-direction launch's bit for bit.
//
// What bounds it: the T sequential steps, not bytes or operations.  A
// step's product is small (2*Bp x 4F x F), but every block of a
// direction needs that direction's whole dz_{t+1} (Bp x 4F bf16: 32 KB
// at Bp = 8, 128 KB at Bp = 32 for F = 512) before it can start.  So a
// step costs a synchronisation across SMs, the L2 broadcast of dz (each
// of the 2F/8 blocks reads all of its direction's dz: 16.8 MB a step at
// Bp = 32, F = 512), the dependent chain of one block's product, and the
// gate update.  On an H100 at F = 512 (probe_bilstm_bwd.py, PERF.md) the
// barrier costs ~0.95 us a step, the copies ~0.8 / ~1.2 / ~2.6 us at
// Bp = 8 / 32 / 64, the product ~1.2 / ~1.3 / ~2.7 us (its mma.sync
// chains, not its shared-memory reads), and the gate update, residual
// loads and stores ~0.2-2 us more.
//
// Design.  Block (d, unit group) owns UNITS = 8 hidden units of direction
// d and is four warps.  At F = 512 that is 64 blocks a direction.
// - Its UNITS rows of Wh_d (UNITS x 4F bf16, 32 KB at F = 512) are loaded
//   once into shared memory and stay there for the whole sequence.
// - dzbuf holds dz chunk-major: chunk ch (columns [ch*KC, ch*KC + KC)) of
//   a direction's Bp rows is one contiguous block of Bp rows of KC + 8
//   bf16, the layout of a shared-memory ring slot (the 16 bytes of row
//   padding keep ldmatrix free of bank conflicts).  Per step every
//   thread copies its 16-byte pieces of a chunk with cp.async.cg (L2,
//   never a stale L1 line), all STAGES = 4 chunks issued at once: where
//   the whole dz fits (4 chunks of F columns: Bp <= 46 at F = 512) that
//   is the whole step's copy; beyond, a slot is refilled as soon as its
//   chunk is multiplied.  A chunk's product starts when it has landed.
// - dh (Bp x UNITS) = dz (Bp x 4F) . Wh_rows^T runs on the tensor cores
//   as mma.sync m16n8k16 (bf16 in, float32 accumulate): rows in m16
//   tiles (Bp <= 256: up to 16), the k-steps dealt round-robin to the
//   four warps, fragments by ldmatrix.  With one m-tile a warp loads
//   eight k-steps' fragments, then multiplies them into four
//   accumulator chains; with more, the m-tiles are the chains.  The
//   warps' partial sums meet in shared memory and are added in a fixed
//   order (deterministic).  N is only 8: mma.sync pads nothing, where
//   wgmma would take a 64-row A tile from shared memory at every k step.
// - The gate cotangents run in registers, one thread per (row, unit)
//   pair, with dc in registers for the whole sequence; the residuals of
//   step t-1 are loaded into registers while the block waits at the
//   barrier of step t (up to 64 rows; more rows load after the product),
//   and those of t-2 are prefetched into L2.  dz_t goes to shared memory
//   once, then out to dzbuf as 16-byte bf16 stores before the arrival and
//   as float32 after it (the release waits for the bf16 stores only).
// - The two directions never read each other's dz, so each direction's
//   blocks meet on their own counter (persistent.cuh:group_arrive /
//   group_wait).  A block's copies of dz_{t+1} have all completed before
//   its arrival, so no block overwrites that buffer with dz_{t-1} while
//   another still reads it.  The launch is cooperative after an
//   occupancy check, which makes the spin safe; a wait over 4 s traps.
// Tried and measured slower (probe_bilstm_bwd.py): 16 units a block (half
// the L2 bytes, twice a block's product), thread block clusters whose
// blocks each bulk-copy 1/C of a chunk multicast to the cluster (32
// clusters of 4 one-block SMs cannot all be resident; C = 2 halves the
// L2 bytes but each bulk copy's latency costs more), deeper fragment
// batches at 2-4 m-tiles, and one wait for a whole in-flight dz.
// Padding rows carry zero residuals and zero cotangent, so their dz stays
// zero.  F needs only be a multiple of 16 (whole k-steps); Bp <= 256 as
// far as shared memory admits (UNITS rows of Wh, the partial sums and a
// ring of at least 16-column chunks).
#include "persistent.cuh"

namespace {

constexpr int UNITS = 8;              // hidden units a block
constexpr int NT = UNITS / 8;         // its n8 tiles of the mma
constexpr int THREADS = 128;          // four warps
constexpr int WARPS = THREADS / 32;
constexpr int XS = WARPS < 4 ? 4 : WARPS;   // floats a pair in `xs`
constexpr int MT_MAX = 16;            // m16 tiles: Bp <= 256
constexpr int STAGES = 4;             // dz chunks in flight
constexpr int PRE_MAX = 4;            // pairs a thread loads a step ahead
constexpr int BAR_STRIDE = 32;        // uint32 counters 128 bytes apart

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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename ResT>
__device__ __forceinline__ void prefetch_res(const ResT* a, const ResT* c,
                                             const ResT* gout, int t,
                                             int row, int u, int R, int F) {
  const size_t ta = (static_cast<size_t>(t) * R + row) * 4 * F + u;
  const size_t tc = (static_cast<size_t>(t) * R + row) * F + u;
#pragma unroll
  for (int q = 0; q < 4; ++q) prefetch_l2(a + ta + q * F);
  prefetch_l2(c + tc);
  if (t > 0) prefetch_l2(c + tc - static_cast<size_t>(R) * F);
  prefetch_l2(gout + tc);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// D (16 x 8, float32) += A (16 x 16, row-major) . B (16 x 8, column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory: the Wh rows, the per-pair exchange (the warps' partial
// sums, then dz_t) and the ring of dz_{t+1} chunks.
constexpr size_t smem_bytes(int Bp, int F, int KC) {
  return static_cast<size_t>(UNITS) * (8 * F + 16) +
         static_cast<size_t>(Bp) * UNITS * XS * 4 +
         static_cast<size_t>(STAGES) * Bp * (2 * KC + 16);
}

template <int MT, typename ResT>
__global__ void __launch_bounds__(THREADS, 1)
bilstm_bwd_kernel(const ResT* __restrict__ a, const ResT* __restrict__ c,
                  const ResT* __restrict__ gout,
                  const __nv_bfloat16* __restrict__ wh,
                  float* __restrict__ dz, __nv_bfloat16* dzbuf,
                  unsigned int* bar, int T, int Bp, int F, int KC,
                  int ndir) {
  // (row, unit) pairs a thread updates; the first PRE of them have their
  // residuals loaded a step ahead.
  constexpr int PAIRS = (MT * 16 * UNITS + THREADS - 1) / THREADS;
  constexpr int PRE = PAIRS < PRE_MAX ? PAIRS : PRE_MAX;
  // k-steps a warp loads before it multiplies them, and its chains of
  // accumulators: with one m-tile, eight k-steps in four chains; with
  // more, the m-tiles are the independent chains.
  constexpr int U = MT == 1 ? 8 : 1;
  constexpr int KACC = MT == 1 ? 4 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int groups = F / UNITS;       // blocks a direction
  const int d = blockIdx.x / groups;
  const int u0 = (blockIdx.x - d * groups) * UNITS;
  const int uu = tid % UNITS;         // this thread's unit in every pair
  const int R = ndir * Bp;
  const int G = 4 * F;
  unsigned int* const counter = bar + d * BAR_STRIDE;
  const int w_pitch = 2 * G + 16;     // bytes a Wh row
  const int a_pitch = 2 * KC + 16;    // bytes a dz row of a chunk
  const int stage_bytes = Bp * a_pitch;
  uint8_t* const w_s = smem;
  float* const xs = reinterpret_cast<float*>(w_s + UNITS * w_pitch);
  const uint32_t w_u32 = idt::smem_u32(w_s);
  const uint32_t ring = idt::smem_u32(xs + Bp * UNITS * XS);

  // Row n of the Wh tile is hidden unit u0 + n of Wh_d: 4F contiguous k.
  const int per_g = G / 8;
  for (int i = tid; i < UNITS * per_g; i += THREADS) {
    const int n = i / per_g;
    const int j = i - n * per_g;
    *reinterpret_cast<uint4*>(w_s + n * w_pitch + 16 * j) =
        __ldg(reinterpret_cast<const uint4*>(
                  wh + static_cast<size_t>(d * F + u0 + n) * G) + j);
  }
  __syncthreads();

  float dc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) dc[i] = 0.f;
  Res pre[PRE];

  // The first PRE pairs' residuals of step t into registers;
  // prefetch=true only asks L2 for every pair's, a step ahead.
  auto load_res_ahead = [&](int t, bool prefetch) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int row = (tid + THREADS * i) / UNITS;
      if (row < Bp) {
        if (prefetch)
          prefetch_res(a, c, gout, t, d * Bp + row, u0 + uu, R, F);
        else if (i < PRE)
          pre[i] = load_res(a, c, gout, t, d * Bp + row, u0 + uu, R, F);
      }
    }
  };

  // dh = dz_{t+1} . Wh_rows^T into this warp's accumulators.  dzbuf holds
  // dz chunk-major: chunk ch (columns [ch*KC, ch*KC + KC)) of direction
  // d's Bp rows is one contiguous block of Bp padded rows (KC + 8 bf16),
  // laid out as a ring slot, and goes to slot ch % STAGES by 16-byte
  // copies of every thread.  One copy group is committed per issue, empty
  // ones included, so that waiting for all but STAGES - 1 groups waits
  // for chunk ch.
  const int nc = G / KC;
  const int nks = KC / 16;
  const int xpitch = KC + 8;            // bf16 a row of an exchange chunk
  const size_t chunk_elems = static_cast<size_t>(Bp) * xpitch;
  float acc[KACC][MT][NT][4];
  auto issue = [&](const __nv_bfloat16* src, int ch) {
    if (ch < nc) {
      const uint32_t st = ring + (ch % STAGES) * stage_bytes;
      const __nv_bfloat16* chunk = src + ch * chunk_elems;
      for (int i = tid; i < stage_bytes / 16; i += THREADS)
        cp_async16(st + 16 * i, chunk + 8 * i);
    }
    cp_async_commit();
  };
  // U k-steps (16 columns each, from column k0 of the chunk in slot st)
  // of every m-tile: all fragments first, then the mma.  Rows past Bp
  // repeat row Bp - 1: their sums are never read.
  auto multiply = [&](int ch) {
    const uint32_t st = ring + (ch % STAGES) * stage_bytes;
    for (int k0 = warp; k0 < nks; k0 += U * WARPS) {
      uint32_t b[U][NT][2];
      uint32_t af[U][MT][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = 16 * (k0 + u * WARPS);
        if (k0 + u * WARPS < nks) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            ldmatrix_x2(b[u][nt],
                        w_u32 + (8 * nt + (lane & 7)) * w_pitch +
                            2 * (ch * KC + k + 8 * ((lane >> 3) & 1)));
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (16 * m < Bp)
              ldmatrix_x4(af[u][m],
                          st + min(16 * m + (lane & 15), Bp - 1) * a_pitch +
                              2 * (k + 8 * (lane >> 4)));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u * WARPS < nks)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (16 * m < Bp)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[u % KACC][m][nt], af[u][m], b[u][nt]);
    }
  };
  auto product = [&](const __nv_bfloat16* dzprev) {
    const __nv_bfloat16* src = dzprev + d * nc * chunk_elems;
#pragma unroll
    for (int k = 0; k < KACC; ++k)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][m][nt][e] = 0.f;
    for (int ch = 0; ch < STAGES; ++ch) issue(src, ch);
    for (int ch = 0; ch < nc; ++ch) {
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      multiply(ch);
      if (ch + STAGES < nc) __syncthreads();   // every warp read slot ch
      issue(src, ch + STAGES);
    }
    // This warp's partial sums: pair (row, unit) gets slot `warp`.
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * m + (lane >> 2) + 8 * h;
        if (row < Bp)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = acc[0][m][nt][2 * h + e];
#pragma unroll
              for (int k = 1; k < KACC; ++k) v += acc[k][m][nt][2 * h + e];
              xs[(row * UNITS + 8 * nt + 2 * (lane & 3) + e) * XS + warp] =
                  v;
            }
      }
    __syncthreads();
  };

  // The gate cotangents of every pair; dz_t replaces the pair's partial
  // sums in shared memory.
  auto gates = [&](bool carry, int t) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + THREADS * i;
      const int row = p / UNITS;
      if (row >= Bp) break;
      const Res r = i < PRE ? pre[i]
                            : load_res(a, c, gout, t, d * Bp + row, u0 + uu,
                                       R, F);
      float* const x = xs + p * XS;
      float dh = 0.f;
      if (carry)
#pragma unroll
        for (int w = 0; w < WARPS; ++w) dh += x[w];
      const float dh_tot = r.gout + dh;
      const float tc = tanhf(r.c);
      const float dcv = dc[i] + dh_tot * r.o * (1.f - tc * tc);
      const float dzi = dcv * r.g * (r.i * (1.f - r.i));
      const float dzf = dcv * r.cprev * (r.f * (1.f - r.f));
      const float dzg = dcv * r.i * (1.f - r.g * r.g);
      const float dzo = dh_tot * tc * (r.o * (1.f - r.o));
      dc[i] = dcv * r.f;
      *reinterpret_cast<float4*>(x) = make_float4(dzi, dzf, dzg, dzo);
    }
    __syncthreads();
  };

  // dz_t in bf16 to dznext's chunk-major layout: 8 units of one gate and
  // row, 16 bytes, never split by a chunk edge (KC is a multiple of 16).
  auto store_exchange = [&](__nv_bfloat16* dznext) {
    for (int j = tid; j < Bp * 4 * NT; j += THREADS) {
      const int row = j / (4 * NT);
      const int rem = j - row * 4 * NT;
      const int q = rem / NT;
      const int n8 = rem - q * NT;
      const float* x = xs + (row * UNITS + 8 * n8) * XS + q;
      const uint4 v = make_uint4(pack_bf16x2(x[0], x[XS]),
                                 pack_bf16x2(x[2 * XS], x[3 * XS]),
                                 pack_bf16x2(x[4 * XS], x[5 * XS]),
                                 pack_bf16x2(x[6 * XS], x[7 * XS]));
      const int col = q * F + u0 + 8 * n8;
      const int ch = col / KC;
      *reinterpret_cast<uint4*>(dznext + (d * nc + ch) * chunk_elems +
                                row * xpitch + col - ch * KC) = v;
    }
  };

  // dz_t in float32, after the arrival: 4 units of one gate and row.
  auto store_dz = [&](int t) {
    constexpr int QUADS = UNITS / 4;
    for (int j = tid; j < Bp * UNITS; j += THREADS) {
      const int row = j / UNITS;
      const int rem = j - row * UNITS;
      const int q = rem / QUADS;
      const int h = rem - q * QUADS;
      const float* x = xs + (row * UNITS + 4 * h) * XS + q;
      *reinterpret_cast<float4*>(
          dz + (static_cast<size_t>(t) * R + d * Bp + row) * G + q * F +
          u0 + 4 * h) = make_float4(x[0], x[XS], x[2 * XS], x[3 * XS]);
    }
  };

  load_res_ahead(T - 1, false);
  if (T > 1) load_res_ahead(T - 2, true);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    if (s > 0) product(dzbuf + ((s + 1) & 1) * ndir * nc * chunk_elems);
    gates(s > 0, t);
    const bool last = s + 1 == T;
    if (!last) store_exchange(dzbuf + (s & 1) * ndir * nc * chunk_elems);
    if (!last) idt::group_arrive(counter);
    store_dz(t);
    if (last) break;
    load_res_ahead(t - 1, false);
    if (t >= 2) load_res_ahead(t - 2, true);
    idt::group_wait(counter, static_cast<unsigned int>(s + 1) * groups);
  }
}

template <int MT, typename ResT>
int launch_tiles(const void* a, const void* c, const void* gout,
                 const void* wh, void* dz, void* dzbuf, void* bar, int T,
                 int Bp, int F, int KC, int ndir, cudaStream_t stream) {
  const ResT* a_ = static_cast<const ResT*>(a);
  const ResT* c_ = static_cast<const ResT*>(c);
  const ResT* g_ = static_cast<const ResT*>(gout);
  const __nv_bfloat16* wh_ = static_cast<const __nv_bfloat16*>(wh);
  float* dz_ = static_cast<float*>(dz);
  __nv_bfloat16* dzbuf_ = static_cast<__nv_bfloat16*>(dzbuf);
  unsigned int* bar_ = static_cast<unsigned int*>(bar);
  void* args[] = {&a_, &c_, &g_, &wh_, &dz_, &dzbuf_, &bar_,
                  &T,  &Bp, &F,  &KC,    &ndir};
  return static_cast<int>(idt::launch_persistent(
      bilstm_bwd_kernel<MT, ResT>, ndir * (F / UNITS), THREADS,
      smem_bytes(Bp, F, KC), args, bar_, stream,
      ndir * BAR_STRIDE * sizeof(unsigned int)));
}

template <typename ResT>
int launch(const void* a, const void* c, const void* gout, const void* wh,
           void* dz, void* dzbuf, void* bar, int T, int Bp, int F, int ndir,
           cudaStream_t stream) {
  // F a multiple of 16: whole k-steps, 16-byte rows of a gate's 8 units.
  // ndir*F at most 8 x the SMs (F = 528 on 132 SMs with both
  // directions): the widths whose recurrence (bilstm_recurrence.cu,
  // ndir*F/8 blocks of one SM each) can be co-resident,
  // so that the backward takes what the training forward takes.  Beyond
  // that, what shared memory admits; launch_persistent refuses the rest.
  const uintptr_t align = reinterpret_cast<uintptr_t>(wh) |
                          reinterpret_cast<uintptr_t>(dz) |
                          reinterpret_cast<uintptr_t>(dzbuf) |
                          reinterpret_cast<uintptr_t>(bar);
  if (T <= 0 || Bp <= 0 || F <= 0 || F % 16 != 0 || F % UNITS != 0 ||
      Bp > 16 * MT_MAX || (ndir != 1 && ndir != 2) || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ndir * F > 8 * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // The fewest chunks (at least STAGES, so that a whole dz that fits is
  // one round of copies) whose ring fits: KC = 4F / n, a multiple of 16.
  const int G = 4 * F;
  int KC = 0;
  for (int n = STAGES; n <= G / 16 && !KC; ++n)
    if ((G / 16) % n == 0 &&
        smem_bytes(Bp, F, G / n) <= static_cast<size_t>(max_smem))
      KC = G / n;
  if (!KC) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int mt = (Bp + 15) / 16;
  if (mt <= 1)
    return launch_tiles<1, ResT>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 KC, ndir, stream);
  if (mt <= 2)
    return launch_tiles<2, ResT>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 KC, ndir, stream);
  if (mt <= 4)
    return launch_tiles<4, ResT>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 KC, ndir, stream);
  if (mt <= 8)
    return launch_tiles<8, ResT>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 KC, ndir, stream);
  return launch_tiles<16, ResT>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                KC, ndir, stream);
}

}  // namespace

extern "C" int idt_bilstm_bwd(const void* a, const void* c, const void* gout,
                              const void* wh, void* dz, void* dzbuf,
                              void* bar, int T, int Bp, int F, int ndir,
                              int res_bf16, cudaStream_t stream) {
  if (res_bf16)
    return launch<__nv_bfloat16>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F,
                                 ndir, stream);
  return launch<float>(a, c, gout, wh, dz, dzbuf, bar, T, Bp, F, ndir,
                       stream);
}
