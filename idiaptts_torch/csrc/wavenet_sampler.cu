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
//   post    P1 (64 x 64) in fragment order, p1b (64 f32), P2 (64 x 256
//           f32), p2b (256 f32)
//   dil, offs (L) int32: dilations and ring slot offsets
//   ring    (sum(d+1), Bp, 64) bf16 scratch, zeroed by the caller
//   samples (T, Bp) int32;  logits (T, Bp, 256) f32 when requested
// Fragment order of a (K x N) weight: [n-tile][k-tile][lane][4 bf16],
// lane = 4 * (n % 8) + (k % 8) / 2, element 2 * ((k % 16) / 8) + k % 2,
// so a warp loads one m16n8k16 B fragment with one 8-byte load a lane.
//
// Design.  One block of 8 warps owns 16 batch rows (one m16 tile) and
// runs all T steps; rows are independent, so blocks never meet and the
// grid is Bp / 16 blocks.  The weights, 1.2 MB at the production widths,
// do not fit one SM's 227 KB of shared memory, nor do the rings (2066
// slots x 128 B per row).  So the weights stay in global memory, resident
// in the 50 MB L2, and stream through the SM once a step: each layer's
// block (57-67 KB with its 16 past rows) and the output block (73 KB) are
// the stages of a two-buffer cp.async pipeline, the next stage's copy in
// flight while this stage computes.  The rings live in global memory;
// each layer's past rows ride with its weight stage.  In shared memory
// for the whole run: the embedding table, this step's conditioning, x, z
// and the logits.  x and skip stay in registers: warp w owns columns
// 8w..8w+7 of both (and of z), so every carry has one owner.  Products
// are mma.sync m16n8k16 bf16 -> f32: warp w forms the gate's tanh tile w
// and sigmoid tile w + 8 (so z needs no exchange), then skip tile w and
// residual tile w + 8.  post2 is float32 FMAs, one class per thread.
// The draw gives each warp two rows: max, exp and an inclusive scan
// over the 256 classes (8 per lane, then a warp scan), the total taken
// from the scan's last entry so U < 1 never reaches a class of zero
// probability, the count clamped to out_channels - 1.
//
// What bounds it: the sequential chain, not the card's peak rates nor
// the L2 stream.  A step is 20 layers x (one 16-row gate product, the
// activations, one skip/res product) plus the output layers and the
// draw, about 45 block barriers, all on one SM.  On an H100 SXM (700 W)
// a step takes ~45 us at any batch up to 256 rows; probe_wavenet_sampler.py
// splits it into ~25 us for the layer stages (products, tanh/sigmoid,
// barriers), ~7 us for the float32 output stage and the draw and ~7 us
// of stage skeleton, with the weight copies hidden under the compute.
// Spreading each layer over a thread-block cluster with the weights
// resident in distributed shared memory, faster activations and post2
// on tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 64;             // residual channels
constexpr int CA = 64;            // gate half (z) channels
constexpr int S = 64;             // skip channels
constexpr int G2 = 2 * CA;        // gate pre-activation width
constexpr int SR = S + R;         // [skip | res] columns
constexpr int CLASSES = 256;
constexpr int ROWS = 16;          // batch rows per block: one m16 tile
constexpr int THREADS = 256;      // 8 warps
constexpr int NW = THREADS / 32;
constexpr int PAD = 8;            // bf16 row padding in shared memory
constexpr int XS = R + PAD;       // row stride of the x and past tiles
constexpr int ZS = CA + PAD;      // z tile
constexpr int HS = S + PAD;       // relu(skip) tile
constexpr int MAX_CP = 64;
static_assert(R / 8 == NW && CA / 8 == NW && S / 8 == NW,
              "warp w owns column tile w of x, z and skip");
static_assert(THREADS == CLASSES, "post2 gives each thread one class");
static_assert(2 * NW == ROWS, "the draw gives each warp two rows");

constexpr int MODE_SAMPLE = 0, MODE_GREEDY = 1, MODE_FORCED = 2;
constexpr float INV_SQRT2 = 0.7071067811865475f;  // float32(1 / sqrt 2)

constexpr int SR_FRAG_BYTES = CA * SR * 2;
constexpr int PAST_BYTES = ROWS * XS * 2;
constexpr int POST_BYTES = S * S * 2 + S * 4 + S * CLASSES * 4 + CLASSES * 4;

__host__ __device__ constexpr int gate_frag_bytes(int Cp) {
  return (2 * R + Cp) * G2 * 2;
}
__host__ __device__ constexpr int layer_bytes(int Cp) {
  return gate_frag_bytes(Cp) + SR_FRAG_BYTES + G2 * 4 + SR * 4;
}
__host__ __device__ constexpr int stage_bytes(int Cp) {
  return layer_bytes(Cp) + PAST_BYTES > POST_BYTES
             ? layer_bytes(Cp) + PAST_BYTES
             : POST_BYTES;
}
size_t smem_bytes(int Cp, int L) {
  return 2 * static_cast<size_t>(stage_bytes(Cp)) + CLASSES * R * 2 +
         ROWS * XS * 2 + ROWS * (Cp + PAD) * 2 + ROWS * ZS * 2 +
         ROWS * HS * 2 + ROWS * S * 4 + ROWS * CLASSES * 4 + ROWS * 4 +
         2 * L * 4;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (rows 0..15, columns k0..k0+15) of a bf16 tile with row
// stride ld: g = lane / 4, q = lane % 4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int k0, int g, int q) {
  a[0] = lds32(tile + g * ld + k0 + 2 * q);
  a[1] = lds32(tile + (g + 8) * ld + k0 + 2 * q);
  a[2] = lds32(tile + g * ld + k0 + 8 + 2 * q);
  a[3] = lds32(tile + (g + 8) * ld + k0 + 8 + 2 * q);
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

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr unsigned FULL = 0xffffffffu;

// Inverse-CDF draw for one row: v holds this lane's classes 8*lane..+7.
__device__ __forceinline__ int draw_row(const float (&v)[8], float U,
                                        float temperature, int lane,
                                        int out_channels) {
  float z[8];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    z[i] = v[i] / temperature;
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

__global__ void __launch_bounds__(THREADS, 1)
wavenet_sampler_kernel(const __nv_bfloat16* __restrict__ cond,
                       const float* __restrict__ uniforms,
                       const int* __restrict__ forced,
                       const __nv_bfloat16* __restrict__ embed,
                       const unsigned char* __restrict__ layers,
                       const unsigned char* __restrict__ post,
                       const int* __restrict__ dil,
                       const int* __restrict__ offs, __nv_bfloat16* ring,
                       int* __restrict__ samples, float* __restrict__ logits,
                       int T, int Bp, int Cp, int L, int out_channels,
                       int mode, int want_logits, float temperature) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int c0 = 8 * warp + 2 * q;  // this thread's columns c0, c0 + 1
  const int b0 = blockIdx.x * ROWS;
  const int WL = layer_bytes(Cp);
  const int STAGE = stage_bytes(Cp);
  const int CS = Cp + PAD;
  const int KT1 = (2 * R + Cp) / 16;

  unsigned char* stage[2] = {smem, smem + STAGE};
  __nv_bfloat16* embed_s = reinterpret_cast<__nv_bfloat16*>(smem + 2 * STAGE);
  __nv_bfloat16* x_s = embed_s + CLASSES * R;
  __nv_bfloat16* cond_s = x_s + ROWS * XS;
  __nv_bfloat16* z_s = cond_s + ROWS * CS;
  __nv_bfloat16* hh_s = z_s + ROWS * ZS;
  float* h2_s = reinterpret_cast<float*>(hh_s + ROWS * HS);
  float* logits_s = h2_s + ROWS * S;
  int* prev_s = reinterpret_cast<int*>(logits_s + ROWS * CLASSES);
  int* dil_s = prev_s + ROWS;
  int* off_s = dil_s + L;

  for (int i = tid; i < CLASSES * R / 8; i += THREADS)
    reinterpret_cast<uint4*>(embed_s)[i] =
        reinterpret_cast<const uint4*>(embed)[i];
  for (int i = tid; i < L; i += THREADS) {
    dil_s[i] = dil[i];
    off_s[i] = offs[i];
  }
  if (tid < ROWS) prev_s[tid] = out_channels / 2;
  __syncthreads();

  // Copy stage s of step t (layer s, or the output layers at s == L) into
  // buf: the weight block, for a layer its 16 past rows, for layer 0 also
  // the step's conditioning (cond_s is free then: the previous step's last
  // layer is done).
  auto issue = [&](int t, int s, unsigned char* buf) {
    if (s < L) {
      const unsigned char* src = layers + static_cast<size_t>(s) * WL;
      for (int i = tid; i < WL / 16; i += THREADS)
        cp16(buf + 16 * i, src + 16 * i);
      const int size = dil_s[s] + 1;
      const __nv_bfloat16* past =
          ring + (static_cast<size_t>(off_s[s] + (t + 1) % size) * Bp + b0) * R;
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(buf + WL);
      for (int i = tid; i < ROWS * R / 8; i += THREADS) {
        const int r = i / (R / 8);
        const int c = (i % (R / 8)) * 8;
        cp16(dst + r * XS + c, past + r * R + c);
      }
      if (s == 0) {
        const __nv_bfloat16* src_c =
            cond + (static_cast<size_t>(t) * Bp + b0) * Cp;
        for (int i = tid; i < ROWS * Cp / 8; i += THREADS) {
          const int r = i / (Cp / 8);
          const int c = (i % (Cp / 8)) * 8;
          cp16(cond_s + r * CS + c, src_c + r * Cp + c);
        }
      }
    } else {
      for (int i = tid; i < POST_BYTES / 16; i += THREADS)
        cp16(buf + 16 * i, post + 16 * i);
    }
    cp_commit();
  };

  // Carries: rows g and g + 8, columns c0 and c0 + 1.
  float xr[4], sk[4];
  // This warp's draw rows 2 * warp and 2 * warp + 1.
  float u_row[2] = {0.f, 0.f};
  int f_row[2] = {0, 0};

  issue(0, 0, stage[0]);
  int k = 0;
  for (int t = 0; t < T; ++t) {
    for (int s = 0; s <= L; ++s, ++k) {
      const unsigned char* buf = stage[k & 1];
      cp_wait_all();
      __syncthreads();
      // The next stage's copy overlaps this stage's work; its buffer was
      // last read by the previous stage, which every thread has left.
      if (s < L)
        issue(t, s + 1, stage[(k + 1) & 1]);
      else if (t + 1 < T)
        issue(t + 1, 0, stage[(k + 1) & 1]);

      if (s == 0) {
        const size_t row = static_cast<size_t>(t) * Bp + b0 + 2 * warp;
        if (mode == MODE_SAMPLE) {
          u_row[0] = uniforms[row];
          u_row[1] = uniforms[row + 1];
        } else if (mode == MODE_FORCED) {
          f_row[0] = forced[row];
          f_row[1] = forced[row + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          const __nv_bfloat16* e = embed_s + prev_s[r] * R + c0;
          xr[2 * h] = __bfloat162float(e[0]);
          xr[2 * h + 1] = __bfloat162float(e[1]);
          store_bf16x2(x_s + r * XS + c0, xr[2 * h], xr[2 * h + 1]);
          sk[2 * h] = 0.f;
          sk[2 * h + 1] = 0.f;
        }
        __syncthreads();
      }

      if (s < L) {
        const unsigned char* w1f = buf;
        const unsigned char* w2f = buf + gate_frag_bytes(Cp);
        const float* b1 =
            reinterpret_cast<const float*>(w2f + SR_FRAG_BYTES);
        const float* b2 = b1 + G2;
        const __nv_bfloat16* past_s =
            reinterpret_cast<const __nv_bfloat16*>(buf + WL);
        // ring_s[t mod (d+1)] = bf16(x), read back at step t + d.
        if (tid < ROWS * R / 8) {
          const int r = tid / (R / 8);
          const int c = (tid % (R / 8)) * 8;
          const int slot = off_s[s] + t % (dil_s[s] + 1);
          *reinterpret_cast<uint4*>(
              ring + (static_cast<size_t>(slot) * Bp + b0 + r) * R + c) =
              *reinterpret_cast<const uint4*>(x_s + r * XS + c);
        }
        // Gate: tanh tile `warp`, sigmoid tile `warp + CA/8`; the past
        // and cond k-tiles on one accumulator chain, x on another.
        float pa0[4] = {0.f, 0.f, 0.f, 0.f}, pb0[4] = {0.f, 0.f, 0.f, 0.f};
        float pa1[4] = {0.f, 0.f, 0.f, 0.f}, pb1[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < R / 16; ++i) {
          load_a(a, past_s, XS, 16 * i, g, q);
          mma(pa0, a, load_b(w1f, KT1, warp, i, lane));
          mma(pb0, a, load_b(w1f, KT1, warp + CA / 8, i, lane));
          load_a(a, x_s, XS, 16 * i, g, q);
          mma(pa1, a, load_b(w1f, KT1, warp, R / 16 + i, lane));
          mma(pb1, a, load_b(w1f, KT1, warp + CA / 8, R / 16 + i, lane));
        }
        for (int i = 0; i < Cp / 16; ++i) {
          load_a(a, cond_s, CS, 16 * i, g, q);
          mma(pa0, a, load_b(w1f, KT1, warp, 2 * R / 16 + i, lane));
          mma(pb0, a, load_b(w1f, KT1, warp + CA / 8, 2 * R / 16 + i, lane));
        }
        float zv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          const float pa = pa0[e] + pa1[e] + b1[col];
          const float pb = pb0[e] + pb1[e] + b1[CA + col];
          zv[e] = tanhf(pa) * sigmoidf_(pb);
        }
        store_bf16x2(z_s + g * ZS + c0, zv[0], zv[1]);
        store_bf16x2(z_s + (g + 8) * ZS + c0, zv[2], zv[3]);
        __syncthreads();
        // [skip | res]: skip tile `warp`, residual tile `S/8 + warp`.
        float ps[4] = {0.f, 0.f, 0.f, 0.f}, pr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < CA / 16; ++i) {
          load_a(a, z_s, ZS, 16 * i, g, q);
          mma(ps, a, load_b(w2f, CA / 16, warp, i, lane));
          mma(pr, a, load_b(w2f, CA / 16, S / 8 + warp, i, lane));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          sk[e] += ps[e] + b2[col];
          xr[e] = (xr[e] + (pr[e] + b2[S + col])) * INV_SQRT2;
        }
        store_bf16x2(x_s + g * XS + c0, xr[0], xr[1]);
        store_bf16x2(x_s + (g + 8) * XS + c0, xr[2], xr[3]);
      } else {
        const unsigned char* p1f = buf;
        const float* p1b = reinterpret_cast<const float*>(buf + S * S * 2);
        const float* p2 = p1b + S;
        const float* p2b = p2 + S * CLASSES;
        store_bf16x2(hh_s + g * HS + c0, fmaxf(sk[0], 0.f), fmaxf(sk[1], 0.f));
        store_bf16x2(hh_s + (g + 8) * HS + c0, fmaxf(sk[2], 0.f),
                     fmaxf(sk[3], 0.f));
        __syncthreads();
        // post1: tile `warp`, then ReLU, kept in float32 for post2.
        float ph[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < S / 16; ++i) {
          load_a(a, hh_s, HS, 16 * i, g, q);
          mma(ph, a, load_b(p1f, S / 16, warp, i, lane));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          const int r = g + 8 * (e >> 1);
          h2_s[r * S + col] = fmaxf(ph[e] + p1b[col], 0.f);
        }
        __syncthreads();
        // post2 in float32: class `tid` for all 16 rows.
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
        for (int kk = 0; kk < S; kk += 4) {
          const float w0 = p2[(kk + 0) * CLASSES + tid];
          const float w1 = p2[(kk + 1) * CLASSES + tid];
          const float w2 = p2[(kk + 2) * CLASSES + tid];
          const float w3 = p2[(kk + 3) * CLASSES + tid];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 h = *reinterpret_cast<const float4*>(h2_s + r * S + kk);
            acc[r] = fmaf(h.x, w0, acc[r]);
            acc[r] = fmaf(h.y, w1, acc[r]);
            acc[r] = fmaf(h.z, w2, acc[r]);
            acc[r] = fmaf(h.w, w3, acc[r]);
          }
        }
        const float bias = p2b[tid];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float lg = acc[r] + bias;
          logits_s[r * CLASSES + tid] = lg;
          if (want_logits)
            logits[(static_cast<size_t>(t) * Bp + b0 + r) * CLASSES + tid] = lg;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * warp + h;
          float v[8];
          const float4 lo =
              *reinterpret_cast<const float4*>(logits_s + r * CLASSES + 8 * lane);
          const float4 hi = *reinterpret_cast<const float4*>(
              logits_s + r * CLASSES + 8 * lane + 4);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
          int smp;
          if (mode == MODE_FORCED)
            smp = f_row[h];
          else if (mode == MODE_SAMPLE)
            smp = draw_row(v, u_row[h], temperature, lane, out_channels);
          else
            smp = argmax_row(v, lane);
          if (lane == 0) {
            prev_s[r] = smp;
            samples[static_cast<size_t>(t) * Bp + b0 + r] = smp;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int idt_wavenet_sampler(
    const void* cond, const void* uniforms, const void* forced,
    const void* embed, const void* layers, const void* post, const void* dil,
    const void* offs, void* ring, void* samples, void* logits, int T, int Bp,
    int Cp, int L, int out_channels, int mode, int want_logits,
    float temperature, cudaStream_t stream) {
  if (T <= 0 || Bp <= 0 || Bp % ROWS != 0 || Cp <= 0 || Cp % 16 != 0 ||
      Cp > MAX_CP || L <= 0 || out_channels < 1 || out_channels > CLASSES ||
      mode < MODE_SAMPLE || mode > MODE_FORCED ||
      (mode == MODE_FORCED && forced == nullptr) ||
      (mode == MODE_SAMPLE && (uniforms == nullptr || !(temperature > 0.f))) ||
      (want_logits && logits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Cp, L);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wavenet_sampler_kernel<<<Bp / ROWS, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(cond),
      static_cast<const float*>(uniforms), static_cast<const int*>(forced),
      static_cast<const __nv_bfloat16*>(embed),
      static_cast<const unsigned char*>(layers),
      static_cast<const unsigned char*>(post), static_cast<const int*>(dil),
      static_cast<const int*>(offs), static_cast<__nv_bfloat16*>(ring),
      static_cast<int*>(samples), static_cast<float*>(logits), T, Bp, Cp, L,
      out_channels, mode, want_logits, temperature);
  return static_cast<int>(cudaGetLastError());
}
