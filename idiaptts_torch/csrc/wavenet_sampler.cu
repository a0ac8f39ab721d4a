// WaveNet autoregressive sampler: the whole sampling loop over T audio
// samples in one launch.
//
// Replaces idiaptts_tpu/ops/pallas_wavenet.py:_make_kernel (launched by
// _generate_pallas, front door PackedSampler).  Per sample t and batch row:
//   x = embed[prev]                                  (bf16 table)
//   per layer j, dilation d:
//     past = ring_j[(t+1) mod (d+1)]  (read before the write below)
//     ring_j[t mod (d+1)] = bf16(x)
//     pre  = [past | bf16(x) | bf16(cond_t)] . [K0; K1; Wc] + b1
//     z    = bf16(tanh(pre[:64]) * sigmoid(pre[64:]))
//     skip += z . Wskip + bskip;   x = (x + (z . Wres + bres)) / sqrt(2)
//   logits = relu(bf16(relu(skip)) . P1 + p1b) . P2 + p2b   (P2 float32)
//   sample = #(c < U * c[255]) with c = cumsum(exp(logits / temp - max)),
//            first-index argmax at temp 0, or the teacher's sample.
// bf16 operands, float32 sums; x and skip carried in float32.  This is the
// unlifted layer (the gate operand holds the layer's own input), the form
// of the training forward (idiaptts_tpu/models/wavenet.py:44-50); the TPU
// kernel lifts the previous layer's residual update into the gate weights
// to hide matmul latency, which moves the bf16 rounding.  The plain
// version, idiaptts_torch/ops/cuda_wavenet.py:sample_plain, computes this
// same form.
//
// Layout (all row-major):
//   cond    (T, Bp, Cp) bf16, zero beyond the C channels (Cp = C rounded
//           up to 16, Cp <= 64)
//   uniforms (T, Bp) f32;  forced (T, Bp) int32 (forced mode only)
//   embed   (256, 64) bf16
//   layers  (L, WL) bytes: per layer the gate weight [K0; K1; Wc]
//           ((128 + Cp) x 128) and [Wskip | Wres] (64 x 128) in mma
//           B-fragment order, then b1 (128 f32) and b2 (128 f32)
//   post    P1 (64 x 64), P2hi, P2lo (64 x 256 each, P2 = P2hi + P2lo
//           split into two bf16 parts) in fragment order, then p1b (64
//           f32) and p2b (256 f32)
//   dil, offs (L) int32: dilations and ring slot offsets
//   ring    (sum(d+1), Bp, 64) bf16 scratch, zeroed by the caller
//   samples (T, Bp) int32;  logits (T, Bp, 256) f32 when requested
// Fragment order of a (K x N) weight: [n-tile][k-tile][lane][4 bf16],
// lane = 4 * (n % 8) + (k % 8) / 2, element 2 * ((k % 16) / 8) + k % 2,
// so a warp loads one m16n8k16 B fragment with one 8-byte load a lane.
//
// What bounds it: the sequential chain.  A step is 20 dependent layers
// (at the production widths), each two 16-row products with an
// activation between, then the output layers and the draw.  The bound
// from the card's peak rates (the products' operations over 989 TFLOP/s
// bf16 and 67 TFLOP/s float32, the weights read once) is ~18 ns a step
// at B=1 and ~4.6 us for 1 s of audio at B=256 (chip_smoke.py,
// wavenet_bound); no schedule reaches it, because each step waits for
// the last.  So the design cuts the chain and keeps everything else off
// it:
//
// - The weights stay on chip for the whole launch.  They do not fit one
//   SM's 227 KB (1.27 MB at Cp=32, 1.44 MB at Cp=64), so a thread-block
//   cluster of NC = 2, 4, 8 or 16 CTAs (16: non-portable) shares them:
//   CTAs 0..NC-2 hold a contiguous run of at most MAX_LPC layers each
//   (the partition comes from the wrapper), copied into shared memory
//   once at launch; CTA NC-1 holds the output layers and the embedding
//   table.  No weight moves after that, and the B fragments the chain
//   multiplies by (K1, Wres, Wskip) sit in registers.
// - A CTA of 8 warps runs one group of 16 rows (one m16 tile) through
//   its layers: warp w owns columns 8w..8w+7 of x, z and skip, which
//   stay in registers.  Of each layer's gate product, past·K0 + cond·Wc
//   does not depend on x: it is computed for all the CTA's layers
//   before x arrives.  What is left on the chain per layer is
//   bf16(x)·K1 (8 mma.sync a warp, two k-halves), tanh.approx and a
//   sigmoid from it, bf16(z)·Wres (4 mma.sync) and two block barriers.
//   After x has left for the next CTA, and off the chain: the skip
//   products, from each layer's z tile, and the ring writes of bf16(x),
//   from each layer's x tile; then the ring rows the layers read next are
//   copied (cp.async) into shared memory.
// - CTAs hand off through distributed shared memory: the sender stores
//   x (float32, 16 x 64, one 16-byte st.async a thread) into the next
//   CTA's inbox, whose bytes complete on the receiver's x mbarrier; the
//   skip sum (float32) follows on its own mbarrier, which the receiver
//   waits for only once its layers are done.  The receiver copies the
//   inbox to registers and returns the slot with a remote arrive on the
//   sender's empty mbarrier.  The output CTA draws the 16 samples and
//   sends the next step's x = embed[sample] to CTA 0, which starts skip
//   at zero.  Only the batch's rows travel: a last group padded to 16
//   rows sends and awaits fewer bytes (at B=1, 256 of 4096), and its
//   receivers read zeros for the padding rows (garbage there would send
//   the float division of the draw down its slow path).
// - G row groups circulate around the ring of CTAs (G <= NC, so the ring
//   of one-slot inboxes cannot fill and deadlock): while CTA k runs
//   group g, CTA k+1 runs group g-1.  The wrapper picks G from
//   cudaOccupancyMaxActiveClusters so that a batch of up to 16 *
//   G * (active clusters) rows runs in one wave of clusters.
// - post2 (float32, 64 x 256) runs on the tensor cores as three bf16
//   products lo·P2hi + hi·P2lo + hi·P2hi of the split operands with
//   float32 sums (lo·lo, ~2^-16 relative, is dropped); the draw is one
//   warp per row.
// Every wait spins on an mbarrier and traps after SPIN_LIMIT_NS, so a
// broken hand-off fails the launch instead of holding the card; every
// CTA meets a last cluster barrier so that no CTA leaves while another
// may still write into its shared memory.  On an H100 SXM (700 W) a step
// at L=20 takes ~12.9 us at B=1 and ~14.4 us at B=16-256
// (probe_wavenet_sampler.py): ~4.0-4.8 us the eight hand-offs, ~2.1-2.3
// us the output stage, ~0.37 us a layer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using idt::global_ns;
using idt::SPIN_LIMIT_NS;
using idt::smem_u32;

constexpr int R = 64;             // residual channels
constexpr int CA = 64;            // gate half (z) channels
constexpr int S = 64;             // skip channels
constexpr int G2 = 2 * CA;        // gate pre-activation width
constexpr int SR = S + R;         // [skip | res] columns
constexpr int CLASSES = 256;
constexpr int ROWS = 16;          // batch rows per group: one m16 tile
constexpr int THREADS = 256;      // 8 warps
constexpr int NW = THREADS / 32;
constexpr int PAD = 8;            // bf16 row padding in shared memory
constexpr int XS = R + PAD;       // row stride of the x, past and z tiles
constexpr int FS = R + PAD;       // float row stride of the inbox
constexpr int LS = CLASSES + 8;   // float row stride of the logits tile
constexpr int MAX_CP = 64;
constexpr int MAX_LPC = 3;        // layers per CTA
constexpr int MAX_NC = 16;        // CTAs per cluster
static_assert(R / 8 == NW && CA / 8 == NW && S / 8 == NW,
              "warp w owns column tile w of x, z and skip");
static_assert(2 * NW == ROWS, "the draw gives each warp two rows");

constexpr int MODE_SAMPLE = 0, MODE_GREEDY = 1, MODE_FORCED = 2;
constexpr float INV_SQRT2 = 0.7071067811865475f;  // float32(1 / sqrt 2)

constexpr int SR_FRAG_BYTES = CA * SR * 2;
constexpr int P1_FRAG_BYTES = S * S * 2;
constexpr int P2_FRAG_BYTES = S * CLASSES * 2;
constexpr int POST_BYTES = P1_FRAG_BYTES + 2 * P2_FRAG_BYTES + S * 4 +
                           CLASSES * 4;
constexpr int EMBED_BYTES = CLASSES * R * 2;
constexpr int TILE_BYTES = ROWS * XS * 2;          // one padded bf16 tile
constexpr int HALF_INBOX = ROWS * FS * 4;          // x or skip, float32
constexpr int INBOX_BYTES = 2 * HALF_INBOX;

__host__ __device__ constexpr int gate_frag_bytes(int Cp) {
  return (2 * R + Cp) * G2 * 2;
}
__host__ __device__ constexpr int layer_bytes(int Cp) {
  return gate_frag_bytes(Cp) + SR_FRAG_BYTES + G2 * 4 + SR * 4;
}
// Shared memory of a layer CTA with nl layers: the weights, the inbox,
// a past, an x and a z tile a layer, and the cond tile.
__host__ __device__ constexpr int layer_cta_bytes(int Cp, int nl) {
  return nl * (layer_bytes(Cp) + 3 * TILE_BYTES) + INBOX_BYTES +
         ROWS * (Cp + PAD) * 2;
}
// The output CTA: post weights, embedding, inbox, the relu(skip) tile
// and the hi/lo tiles of post1's output, the logits tile and the rows'
// samples.
__host__ __device__ constexpr int output_cta_bytes() {
  return POST_BYTES + EMBED_BYTES + INBOX_BYTES + 3 * TILE_BYTES +
         ROWS * LS * 4 + ROWS * 4;
}
constexpr int BARRIER_BYTES = 32;  // two full and one empty mbarrier
size_t smem_bytes(int Cp, int max_nl) {
  const int a = layer_cta_bytes(Cp, max_nl), b = output_cta_bytes();
  return static_cast<size_t>(a > b ? a : b) + BARRIER_BYTES;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The mma A fragment (rows 0..15, columns k0..k0+15) of a bf16 tile with
// row stride ld, by one ldmatrix.x4: lane l gives the address of row
// l % 16, column k0 + 8 (l / 16).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int k0, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(tile + (lane % 16) * ld + k0 + (lane / 16) * 8))
      : "memory");
}

// B fragment (n-tile nt, k-tile kt) of a fragment-ordered weight with KT
// k-tiles.
__device__ __forceinline__ uint2 load_b(const unsigned char* frags, int KT,
                                        int nt, int kt, int lane) {
  return *reinterpret_cast<const uint2*>(frags + ((nt * KT + kt) * 32 + lane) *
                                                     8);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a,
                                             float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// tanh on the special function unit (max error ~2^-11, below the bf16
// step that z is rounded to), and sigmoid(x) = (1 + tanh(x / 2)) / 2.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float gate(float a, float b) {
  return tanh_approx(a) * fmaf(0.5f, tanh_approx(0.5f * b), 0.5f);
}

// -- mbarriers and distributed shared memory ---------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed; a wait
// longer than SPIN_LIMIT_NS traps.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
}

// The shared::cluster address of this CTA's shared address `addr` in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_to(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void remote_arrive(uint32_t cluster_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          cluster_bar)
      : "memory");
}

// Four floats into another CTA's shared memory; their 16 bytes complete
// on that CTA's mbarrier `cluster_bar`.
__device__ __forceinline__ void st_async4(uint32_t cluster_addr, float a,
                                          float b, float c, float d,
                                          uint32_t cluster_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(cluster_addr),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(cluster_bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

constexpr unsigned FULL = 0xffffffffu;

// Inverse-CDF draw for one row: v holds this lane's classes 8*lane..+7.
// The logits are scaled by 1 / temperature (exact at temperature 1):
// the IEEE division took its slow path on some rows and cost ~0.6-2.6
// us a step (probe_wavenet_sampler.py).
__device__ __forceinline__ int draw_row(const float (&v)[8], float U,
                                        float inv_temperature, int lane,
                                        int out_channels) {
  float z[8];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    z[i] = v[i] * inv_temperature;
    m = fmaxf(m, z[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float c[8];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run += expf(z[i] - m);
    c[i] = run;
  }
  // Exclusive warp scan of the lane totals.
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  // The total is the scan's last entry, c[255] itself.
  const float total = __shfl_sync(FULL, excl + c[7], 31);
  const float u = U * total;
  int count = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) count += (excl + c[i]) < u ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(FULL, count, off);
  return min(count, out_channels - 1);
}

// First-index argmax for one row.
__device__ __forceinline__ int argmax_row(const float (&v)[8], int lane) {
  float best = v[0];
  int idx = 8 * lane;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    if (v[i] > best) {
      best = v[i];
      idx = 8 * lane + i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

struct Args {
  const __nv_bfloat16* cond;
  const float* uniforms;
  const int* forced;
  const __nv_bfloat16* embed;
  const unsigned char* layers;
  const unsigned char* post;
  const int* dil;
  const int* offs;
  __nv_bfloat16* ring;
  int* samples;
  float* logits;
  // B: the batch's rows; rows B..Bp-1 pad the last group: they are not
  // sent, and their receivers read zeros.
  int T, B, Bp, Cp, NC, G, out_channels, mode, want_logits;
  float temperature;
  // part[k]: the first layer of CTA k (k < NC - 1); part[NC - 1] = L.
  int part[MAX_NC];
};

// What every role shares: its place in the cluster, the row groups of
// its cluster, its mbarriers and the inbox (at the same offset in every
// CTA, so that mapa finds a neighbour's).  The inbox has two halves, x
// and skip, each with its own full barrier, so that a CTA can start its
// layers on x while the skip sum is still on its way; one empty barrier
// returns the whole slot.
struct Ring {
  int tid, warp, lane, g, q, c0;
  unsigned rank;
  int first_group, ng;
  uint32_t full[2], empty_bar;
  float* inbox;
  // The next CTA's inbox and full barriers; the previous CTA's empty
  // barrier.
  uint32_t next_inbox, next_full[2], prev_empty;
  unsigned recv, sent;
  // This group's rows of the batch (16 but in a last, padded group):
  // only they travel.
  int rows;

  __device__ __forceinline__ void set_group(int row0, int B) {
    rows = min(ROWS, B - row0);
  }

  // Wait for this item's half `half` (16 x 64 float32) of the inbox.
  __device__ __forceinline__ void receive(int half) {
    if (tid == 0) bar_expect_tx(full[half], rows * R * 4);
    bar_wait(full[half], recv & 1);
  }
  // Every thread has read the inbox: give the slot back.
  __device__ __forceinline__ void release() {
    __syncthreads();
    if (tid == 0) remote_arrive(prev_empty);
    ++recv;
  }
  // Half `half` of the next CTA's inbox from this thread's accumulator
  // values (rows g and g + 8, columns c0 and c0 + 1), as one 16-byte
  // st.async a thread: lanes q and q ^ 1 swap a pair, so that the even
  // lane sends row g's four columns and the odd lane row g + 8's.
  __device__ __forceinline__ void put(int half, const float (&v)[4]) {
    const bool odd = q & 1;
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
    const int row = odd ? g + 8 : g;
    const int col = odd ? c0 - 2 : c0;
    if (row < rows)
      st_async4(next_inbox + half * HALF_INBOX + (row * FS + col) * 4,
                odd ? s0 : v[0], odd ? s1 : v[1], odd ? v[2] : s0,
                odd ? v[3] : s1, next_full[half]);
  }
  __device__ __forceinline__ void wait_slot() {
    bar_wait(empty_bar, (sent & 1) ^ 1);
  }
  // This thread's values of half `half` of the inbox; zeros in the rows
  // that pad the last group, which no CTA sends.
  __device__ __forceinline__ void get(int half, float (&v)[4]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 p = make_float2(0.f, 0.f);
      if (g + 8 * h < rows)
        p = *reinterpret_cast<const float2*>(
            inbox + half * (HALF_INBOX / 4) + (g + 8 * h) * FS + c0);
      v[2 * h] = p.x;
      v[2 * h + 1] = p.y;
    }
  }
};

// CTAs 0..NC-2: layers part[rank]..part[rank+1]-1 for each row group.
__device__ __forceinline__ void layer_role(const Args& a, Ring& rg,
                                           unsigned char* base) {
  const int tid = rg.tid, warp = rg.warp, lane = rg.lane, g = rg.g,
            c0 = rg.c0;
  const int Cp = a.Cp, Bp = a.Bp;
  const int WL = layer_bytes(Cp);
  const int KT1 = (2 * R + Cp) / 16;
  const int CS = Cp + PAD;
  const int j0 = a.part[rg.rank];
  const int nl = a.part[rg.rank + 1] - j0;
  const bool first = rg.rank == 0;
  const bool last = static_cast<int>(rg.rank) == a.NC - 2;

  unsigned char* w_s = base + INBOX_BYTES;
  __nv_bfloat16* past_s = reinterpret_cast<__nv_bfloat16*>(w_s + nl * WL);
  __nv_bfloat16* cond_s = past_s + nl * ROWS * XS;
  __nv_bfloat16* x_s = cond_s + ROWS * CS;
  __nv_bfloat16* z_s = x_s + nl * ROWS * XS;

  const unsigned char* src = a.layers + static_cast<size_t>(j0) * WL;
  for (int i = tid; i < nl * WL / 16; i += THREADS)
    cp16(w_s + 16 * i, src + 16 * i);
  cp_commit();
  int dl[MAX_LPC], of[MAX_LPC];
#pragma unroll
  for (int l = 0; l < MAX_LPC; ++l) {
    dl[l] = l < nl ? a.dil[j0 + l] : 1;
    of[l] = l < nl ? a.offs[j0 + l] : 0;
  }

  // Copy step t's past rows of every layer and its conditioning for
  // group gi into shared memory.
  auto fetch = [&](int t, int gi) {
    const int row0 = (rg.first_group + gi) * ROWS;
#pragma unroll
    for (int l = 0; l < MAX_LPC; ++l) {
      if (l >= nl) break;
      const __nv_bfloat16* past =
          a.ring +
          (static_cast<size_t>(of[l] + (t + 1) % (dl[l] + 1)) * Bp + row0) *
              R;
      if (tid < ROWS * R / 8) {
        const int r = tid / (R / 8), c = (tid % (R / 8)) * 8;
        cp16(past_s + (l * ROWS + r) * XS + c, past + r * R + c);
      }
    }
    const __nv_bfloat16* cond =
        a.cond + (static_cast<size_t>(t) * Bp + row0) * Cp;
    for (int i = tid; i < ROWS * Cp / 8; i += THREADS) {
      const int r = i / (Cp / 8), c = (i % (Cp / 8)) * 8;
      cp16(cond_s + r * CS + c, cond + r * Cp + c);
    }
    cp_commit();
  };

  // The weights must be in before the cluster starts handing off.
  cp_wait_all();
  __syncthreads();
  cluster_sync();
  fetch(0, 0);
  // The chain's B fragments stay in registers for the whole launch: per
  // layer and k-tile, K1's tanh and sigmoid tiles and Wres's and Wskip's.
  uint2 bx[MAX_LPC][R / 16][2], bz[MAX_LPC][CA / 16][2];
#pragma unroll
  for (int l = 0; l < MAX_LPC; ++l) {
    const unsigned char* w1f = w_s + (l < nl ? l : 0) * WL;
    const unsigned char* w2f = w1f + gate_frag_bytes(Cp);
#pragma unroll
    for (int i = 0; i < R / 16; ++i) {
      bx[l][i][0] = load_b(w1f, KT1, warp, R / 16 + i, lane);
      bx[l][i][1] = load_b(w1f, KT1, warp + CA / 8, R / 16 + i, lane);
      bz[l][i][0] = load_b(w2f, CA / 16, S / 8 + warp, i, lane);
      bz[l][i][1] = load_b(w2f, CA / 16, warp, i, lane);
    }
  }

  for (int t = 0; t < a.T; ++t) {
    for (int gi = 0; gi < rg.ng; ++gi) {
      const int row0 = (rg.first_group + gi) * ROWS;
      rg.set_group(row0, a.B);
      cp_wait_all();
      __syncthreads();
      // Off the chain: past.K0 + cond.Wc of every layer, in that k order.
      float pa0[MAX_LPC][4], pb0[MAX_LPC][4];
#pragma unroll
      for (int l = 0; l < MAX_LPC; ++l) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa0[l][e] = pb0[l][e] = 0.f;
        if (l < nl) {
          const unsigned char* w1f = w_s + l * WL;
          uint32_t f[4];
#pragma unroll
          for (int i = 0; i < R / 16; ++i) {
            ldsm_a(f, past_s + l * ROWS * XS, XS, 16 * i, lane);
            mma(pa0[l], f, load_b(w1f, KT1, warp, i, lane));
            mma(pb0[l], f, load_b(w1f, KT1, warp + CA / 8, i, lane));
          }
          for (int i = 0; i < Cp / 16; ++i) {
            ldsm_a(f, cond_s, CS, 16 * i, lane);
            mma(pa0[l], f, load_b(w1f, KT1, warp, 2 * R / 16 + i, lane));
            mma(pb0[l], f,
                load_b(w1f, KT1, warp + CA / 8, 2 * R / 16 + i, lane));
          }
        }
      }

      float xr[4], sk[4] = {0.f, 0.f, 0.f, 0.f};
      rg.receive(0);
      rg.get(0, xr);
      if (first) rg.release();

#pragma unroll
      for (int l = 0; l < MAX_LPC; ++l) {
        if (l >= nl) break;
        const float* b1 = reinterpret_cast<const float*>(
            w_s + l * WL + gate_frag_bytes(Cp) + SR_FRAG_BYTES);
        const float* b2 = b1 + G2;
        const __nv_bfloat162 xb0 = __floats2bfloat162_rn(xr[0], xr[1]);
        const __nv_bfloat162 xb1 = __floats2bfloat162_rn(xr[2], xr[3]);
        __nv_bfloat16* xl_s = x_s + l * ROWS * XS;
        *reinterpret_cast<__nv_bfloat162*>(xl_s + g * XS + c0) = xb0;
        *reinterpret_cast<__nv_bfloat162*>(xl_s + (g + 8) * XS + c0) = xb1;
        __syncthreads();
        // On the chain: bf16(x).K1 (tanh tile `warp`, sigmoid tile
        // `warp + CA/8`) as two k-halves each, then the gate.
        float pa1[2][4] = {}, pb1[2][4] = {};
        uint32_t f[R / 16][4];
#pragma unroll
        for (int i = 0; i < R / 16; ++i) ldsm_a(f[i], xl_s, XS, 16 * i, lane);
#pragma unroll
        for (int i = 0; i < R / 16; ++i) {
          mma(pa1[i & 1], f[i], bx[l][i][0]);
          mma(pb1[i & 1], f[i], bx[l][i][1]);
        }
        float zv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          zv[e] = gate(pa0[l][e] + (pa1[0][e] + pa1[1][e]) + b1[col],
                       pb0[l][e] + (pb1[0][e] + pb1[1][e]) + b1[CA + col]);
        }
        store_bf16x2(z_s + (l * ROWS + g) * XS + c0, zv[0], zv[1]);
        store_bf16x2(z_s + (l * ROWS + g + 8) * XS + c0, zv[2], zv[3]);
        __syncthreads();
        // On the chain: x += bf16(z).Wres, two k-halves.
        float pr[2][4] = {};
#pragma unroll
        for (int i = 0; i < CA / 16; ++i)
          ldsm_a(f[i], z_s + l * ROWS * XS, XS, 16 * i, lane);
#pragma unroll
        for (int i = 0; i < CA / 16; ++i) mma(pr[i & 1], f[i], bz[l][i][0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          xr[e] = (xr[e] + ((pr[0][e] + pr[1][e]) + b2[S + col])) * INV_SQRT2;
        }
      }

      // x on to the next CTA; then, off the chain, the skip products of
      // every layer from its z tile, and the skip sum that came in added.
      rg.wait_slot();
      if (!last) rg.put(0, xr);
#pragma unroll
      for (int l = 0; l < MAX_LPC; ++l) {
        if (l >= nl) break;
        const float* b2 = reinterpret_cast<const float*>(
                              w_s + l * WL + gate_frag_bytes(Cp) +
                              SR_FRAG_BYTES) + G2;
        float ps[2][4] = {};
        uint32_t f[4];
#pragma unroll
        for (int i = 0; i < CA / 16; ++i) {
          ldsm_a(f, z_s + l * ROWS * XS, XS, 16 * i, lane);
          mma(ps[i & 1], f, bz[l][i][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sk[e] += (ps[0][e] + ps[1][e]) + b2[c0 + (e & 1)];
      }
      if (!first) {
        float in[4];
        rg.receive(1);
        rg.get(1, in);
#pragma unroll
        for (int e = 0; e < 4; ++e) sk[e] = in[e] + sk[e];
        rg.release();
      }
      rg.put(1, sk);
      ++rg.sent;
      // ring_l[t mod (d+1)] = bf16(x) of every layer, read back at step
      // t + d: off the chain, from the x tiles (a global store before a
      // block barrier holds the barrier until it lands).
      if (tid < ROWS * R / 8) {
        const int r = tid / (R / 8), c = (tid % (R / 8)) * 8;
#pragma unroll
        for (int l = 0; l < MAX_LPC; ++l) {
          if (l >= nl) break;
          *reinterpret_cast<uint4*>(
              a.ring +
              (static_cast<size_t>(of[l] + t % (dl[l] + 1)) * Bp + row0 + r) *
                  R + c) =
              *reinterpret_cast<const uint4*>(x_s + (l * ROWS + r) * XS + c);
        }
      }
      // This group's ring writes are done: fetch the next group's rows.
      __syncthreads();
      if (gi + 1 < rg.ng)
        fetch(t, gi + 1);
      else if (t + 1 < a.T)
        fetch(t + 1, 0);
    }
  }
}

// CTA NC-1: post1, post2 and the draw for each row group, then the next
// step's x = embed[sample] to CTA 0.
__device__ __forceinline__ void output_role(const Args& a, Ring& rg,
                                            unsigned char* base) {
  const int tid = rg.tid, warp = rg.warp, lane = rg.lane, g = rg.g,
            q = rg.q, c0 = rg.c0;
  const int Bp = a.Bp;
  const unsigned char* post_s = base + INBOX_BYTES;
  const unsigned char* p1f = post_s;
  const unsigned char* p2hi = p1f + P1_FRAG_BYTES;
  const unsigned char* p2lo = p2hi + P2_FRAG_BYTES;
  const float* p1b = reinterpret_cast<const float*>(p2lo + P2_FRAG_BYTES);
  const float* p2b = p1b + S;
  __nv_bfloat16* embed_s =
      reinterpret_cast<__nv_bfloat16*>(base + INBOX_BYTES + POST_BYTES);
  __nv_bfloat16* hh_s = embed_s + CLASSES * R;
  __nv_bfloat16* hi_s = hh_s + ROWS * XS;
  __nv_bfloat16* lo_s = hi_s + ROWS * XS;
  float* logits_s = reinterpret_cast<float*>(lo_s + ROWS * XS);
  int* prev_s = reinterpret_cast<int*>(logits_s + ROWS * LS);

  for (int i = tid; i < POST_BYTES / 16; i += THREADS)
    cp16(base + INBOX_BYTES + 16 * i, a.post + 16 * i);
  for (int i = tid; i < EMBED_BYTES / 16; i += THREADS)
    cp16(reinterpret_cast<unsigned char*>(embed_s) + 16 * i,
         reinterpret_cast<const unsigned char*>(a.embed) + 16 * i);
  cp_commit();
  if (tid < ROWS) prev_s[tid] = a.out_channels / 2;
  cp_wait_all();
  __syncthreads();
  cluster_sync();

  // x = embed[prev] of this thread's rows and columns, to CTA 0.
  auto send_x = [&](int gi) {
    rg.set_group((rg.first_group + gi) * ROWS, a.B);
    float xv[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* e = embed_s + prev_s[g + 8 * h] * R + c0;
      xv[2 * h] = __bfloat162float(e[0]);
      xv[2 * h + 1] = __bfloat162float(e[1]);
    }
    rg.wait_slot();
    rg.put(0, xv);
    ++rg.sent;
  };
  for (int gi = 0; gi < rg.ng; ++gi) send_x(gi);
  const float inv_temperature = 1.f / a.temperature;

  for (int t = 0; t < a.T; ++t) {
    for (int gi = 0; gi < rg.ng; ++gi) {
      const int row0 = (rg.first_group + gi) * ROWS;
      rg.set_group(row0, a.B);
      // This warp's draw rows 2 * warp and 2 * warp + 1.
      float u_row[2] = {0.f, 0.f};
      int f_row[2] = {0, 0};
      const size_t row = static_cast<size_t>(t) * Bp + row0 + 2 * warp;
      if (a.mode == MODE_SAMPLE) {
        u_row[0] = a.uniforms[row];
        u_row[1] = a.uniforms[row + 1];
      } else if (a.mode == MODE_FORCED) {
        f_row[0] = a.forced[row];
        f_row[1] = a.forced[row + 1];
      }

      float sk[4];
      rg.receive(1);
      rg.get(1, sk);
      store_bf16x2(hh_s + g * XS + c0, fmaxf(sk[0], 0.f), fmaxf(sk[1], 0.f));
      store_bf16x2(hh_s + (g + 8) * XS + c0, fmaxf(sk[2], 0.f),
                   fmaxf(sk[3], 0.f));
      rg.release();  // (its barrier also publishes hh_s)

      // post1: tile `warp`, ReLU, split into bf16 hi + lo for post2.
      float ph[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < S / 16; ++i) {
        ldsm_a(f, hh_s, XS, 16 * i, lane);
        mma(ph, f, load_b(p1f, S / 16, warp, i, lane));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(ph[2 * h] + p1b[c0], 0.f);
        const float v1 = fmaxf(ph[2 * h + 1] + p1b[c0 + 1], 0.f);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const int r = g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(hi_s + r * XS + c0) = hi;
        store_bf16x2(lo_s + r * XS + c0, v0 - __low2float(hi),
                     v1 - __high2float(hi));
      }
      __syncthreads();
      // post2: columns 32 warp .. 32 warp + 31 (n-tiles 4 warp + n), as
      // three chains lo.P2hi, hi.P2lo and hi.P2hi, the small ones summed
      // first.
      float acc[3][4][4] = {};
#pragma unroll
      for (int i = 0; i < S / 16; ++i) {
        uint32_t ahi[4], alo[4];
        ldsm_a(ahi, hi_s, XS, 16 * i, lane);
        ldsm_a(alo, lo_s, XS, 16 * i, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int nt = 4 * warp + n;
          const uint2 bhi = load_b(p2hi, S / 16, nt, i, lane);
          mma(acc[0][n], alo, bhi);
          mma(acc[1][n], ahi, load_b(p2lo, S / 16, nt, i, lane));
          mma(acc[2][n], ahi, bhi);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[0][n][e] = (acc[0][n][e] + acc[1][n][e]) + acc[2][n][e];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * warp + 8 * n + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          const float2 lg = make_float2(acc[0][n][2 * h] + p2b[col],
                                        acc[0][n][2 * h + 1] + p2b[col + 1]);
          *reinterpret_cast<float2*>(logits_s + r * LS + col) = lg;
          if (a.want_logits)
            *reinterpret_cast<float2*>(
                a.logits +
                (static_cast<size_t>(t) * Bp + row0 + r) * CLASSES + col) = lg;
        }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * warp + h;
        float v[8];
        const float4 lo =
            *reinterpret_cast<const float4*>(logits_s + r * LS + 8 * lane);
        const float4 hi =
            *reinterpret_cast<const float4*>(logits_s + r * LS + 8 * lane + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        int smp;
        if (a.mode == MODE_FORCED)
          smp = f_row[h];
        else if (a.mode == MODE_SAMPLE)
          smp = draw_row(v, u_row[h], inv_temperature, lane, a.out_channels);
        else
          smp = argmax_row(v, lane);
        if (lane == 0) {
          prev_s[r] = smp;
          a.samples[static_cast<size_t>(t) * Bp + row0 + r] = smp;
        }
      }
      __syncthreads();
      if (t + 1 < a.T) send_x(gi);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    wavenet_sampler_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring rg;
  rg.tid = threadIdx.x;
  rg.warp = rg.tid / 32;
  rg.lane = rg.tid % 32;
  rg.g = rg.lane / 4;
  rg.q = rg.lane % 4;
  rg.c0 = 8 * rg.warp + 2 * rg.q;
  rg.rank = cluster_rank();
  rg.first_group = static_cast<int>(cluster_index()) * a.G;
  rg.ng = min(a.G, a.Bp / ROWS - rg.first_group);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  rg.full[0] = smem_u32(bars);
  rg.full[1] = smem_u32(bars + 1);
  rg.empty_bar = smem_u32(bars + 2);
  unsigned char* base = smem + BARRIER_BYTES;
  rg.inbox = reinterpret_cast<float*>(base);
  const unsigned next = (rg.rank + 1) % a.NC;
  const unsigned prev = (rg.rank + a.NC - 1) % a.NC;
  rg.next_inbox = map_to(smem_u32(base), next);
  rg.next_full[0] = map_to(rg.full[0], next);
  rg.next_full[1] = map_to(rg.full[1], next);
  rg.prev_empty = map_to(rg.empty_bar, prev);
  rg.recv = rg.sent = 0;
  if (rg.tid == 0) {
    bar_init(rg.full[0], 1);
    bar_init(rg.full[1], 1);
    bar_init(rg.empty_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Each role meets a cluster barrier once its weights are in and its
  // barriers initialised, before any hand-off.
  if (static_cast<int>(rg.rank) == a.NC - 1)
    output_role(a, rg, base);
  else
    layer_role(a, rg, base);
  // No CTA leaves while a neighbour may still store into its inbox or
  // arrive on its barriers.
  cluster_sync();
}

// The launch configuration of `clusters` clusters of NC CTAs, with its
// cluster-dimension attribute.
struct Launch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  Launch(int NC, int clusters, size_t smem, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = NC;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(NC * clusters);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t set_attributes(int NC, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && NC > 8)
    err = cudaFuncSetAttribute(wavenet_sampler_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

bool valid_cluster(int NC) {
  return NC == 2 || NC == 4 || NC == 8 || NC == MAX_NC;
}

}  // namespace

// The launch plan for Bp rows on clusters of NC CTAs whose layer CTAs
// hold at most max_nl layers: out[0] = clusters of NC that can be
// resident at once, out[1] = G, the row groups a cluster carries (at
// most NC), out[2] = the clusters launched.
extern "C" int idt_wavenet_sampler_plan(int Bp, int Cp, int NC, int max_nl,
                                        int* out) {
  if (Bp <= 0 || Bp % ROWS != 0 || Cp <= 0 || Cp % 16 != 0 || Cp > MAX_CP ||
      !valid_cluster(NC) || max_nl < 1 || max_nl > MAX_LPC || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Cp, max_nl);
  cudaError_t err = set_attributes(NC, smem);
  int active = 0;
  if (err == cudaSuccess) {
    Launch launch(NC, 1, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&active, wavenet_sampler_kernel,
                                         &launch.cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = Bp / ROWS;
  int G = (groups + active - 1) / active;
  if (G > NC) G = NC;
  out[0] = active;
  out[1] = G;
  out[2] = (groups + G - 1) / G;
  return 0;
}

// part: NC ints, part[k] the first layer of CTA k, part[NC-1] = L; every
// layer CTA holds 1..MAX_LPC layers.
extern "C" int idt_wavenet_sampler(
    const void* cond, const void* uniforms, const void* forced,
    const void* embed, const void* layers, const void* post, const void* dil,
    const void* offs, void* ring, void* samples, void* logits,
    const int* part, int T, int B, int Bp, int Cp, int L, int NC, int G,
    int out_channels, int mode, int want_logits, float temperature,
    cudaStream_t stream) {
  if (T <= 0 || Bp <= 0 || Bp % ROWS != 0 || B < 1 || B > Bp ||
      Bp - B >= ROWS || Cp <= 0 || Cp % 16 != 0 ||
      Cp > MAX_CP || L <= 0 || !valid_cluster(NC) || G < 1 || G > NC ||
      part == nullptr || out_channels < 1 || out_channels > CLASSES ||
      (mode != MODE_SAMPLE && mode != MODE_GREEDY && mode != MODE_FORCED) ||
      (mode == MODE_FORCED && forced == nullptr) ||
      (mode == MODE_SAMPLE && (uniforms == nullptr || !(temperature > 0.f))) ||
      (want_logits && logits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int max_nl = 0;
  if (part[0] != 0 || part[NC - 1] != L)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < NC; ++k) a.part[k] = part[k];
  for (int k = NC; k < MAX_NC; ++k) a.part[k] = L;
  for (int k = 0; k + 1 < NC; ++k) {
    const int nl = part[k + 1] - part[k];
    if (nl < 1 || nl > MAX_LPC) return static_cast<int>(cudaErrorInvalidValue);
    if (nl > max_nl) max_nl = nl;
  }
  a.cond = static_cast<const __nv_bfloat16*>(cond);
  a.uniforms = static_cast<const float*>(uniforms);
  a.forced = static_cast<const int*>(forced);
  a.embed = static_cast<const __nv_bfloat16*>(embed);
  a.layers = static_cast<const unsigned char*>(layers);
  a.post = static_cast<const unsigned char*>(post);
  a.dil = static_cast<const int*>(dil);
  a.offs = static_cast<const int*>(offs);
  a.ring = static_cast<__nv_bfloat16*>(ring);
  a.samples = static_cast<int*>(samples);
  a.logits = static_cast<float*>(logits);
  a.T = T;
  a.B = B;
  a.Bp = Bp;
  a.Cp = Cp;
  a.NC = NC;
  a.G = G;
  a.out_channels = out_channels;
  a.mode = mode;
  a.want_logits = want_logits;
  a.temperature = temperature;
  const size_t smem = smem_bytes(Cp, max_nl);
  cudaError_t err = set_attributes(NC, smem);
  if (err == cudaSuccess) {
    const int groups = Bp / ROWS;
    Launch launch(NC, (groups + G - 1) / G, smem, stream);
    err = cudaLaunchKernelEx(&launch.cfg, wavenet_sampler_kernel, a);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
