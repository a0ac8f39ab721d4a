// BiLSTM input projection, per direction d and row r of step t:
//   xp[t, d*Bp + r, :] = bf16(xin[t, d*Bp + r, :] . Wx[d]) + b[d]
//
// Replaces the projection half of two kernels of
// idiaptts_tpu/ops/pallas_lstm.py: _bilstm_layer_kernel (:590, wrapper
// _layer_tmajor, lines 615-625) and _bilstm_layer_kernel_train (:742,
// lines 758-765).  bf16 operands, float32 accumulation, the product
// rounded to bf16 (RNE; what the scan path's bf16 einsum emits), then the
// float32 bias added.  The recurrence half of those kernels is
// bilstm_recurrence.cu, launched right after this one.
//
// Layout (the JAX package's time-major layer layout):
//   xin  (T, R, K) bf16, R = ndir*Bp rows per step: [fwd Bp | bwd Bp]
//   wx   (ndir, K, N) bf16, N = 4F, row-major per direction
//   b    (ndir, N) float32
//   xp   (T, R, N) float32
// ndir is 2 (both directions), or 1: one direction's instance, which a
// tensor-parallel rank launches on its direction's rows and weights.  Its
// tiles are the two-direction launch's tiles of that direction, with the
// same arithmetic, so its xp is that half of the two-direction xp bit for
// bit.
// Per direction this is one (T*Bp, K) x (K, N) GEMM whose row m = (t, r)
// lives at xin row t*R + d*Bp + r.
//
// What bounds it: at the serving and training shapes (K = 1024, N = 2048,
// T*Bp = 3072 to 32768 rows a direction) 360 to 400 FLOP a byte of
// operands and float32 output, above the H100's ~295 FLOP/byte ridge: the
// tensor cores, with the float32 output (up to 537 MB) the largest byte
// term.  So the design is the usual Hopper GEMM:
// - wgmma (m64n256k16, bf16 -> float32 in registers): two consumer
//   warpgroups each own 64 rows of a 128 x 256 output tile.
// - A ring of STAGES shared-memory stages, 64 bf16 deep, in the 128-byte
//   swizzle that the wgmma descriptors name; one producer thread keeps
//   TMA loads in flight, full/empty mbarriers hand stages over.
// - A persistent grid, one block per SM, walking tiles direction-major,
//   then row tile, then column tile, so the blocks in flight share one
//   direction's Wx (4 MiB) and a few row panels in L2, and the loads of
//   a tile start while the last one is being finished.
// - The epilogue off the tensor cores' path: the consumers round their
//   accumulators to bf16 (RNE) into a shared staging tile and go on to
//   the next tile; three storer warps add the bias and write the float32
//   rows with 16-byte streaming stores, while the next tile's products
//   run.
// Tried on an H100 (probe_bilstm_proj.py, PERF.md): 192 x 128 tiles of
// three m64n128 warpgroups, and 128 x 128 or 256 x 128 tiles, are slower
// at every serving and training shape.
//
// The strided A rows: one direction's rows are Bp rows of every step, so
// no 2-D box covers them.  A is loaded by TMA through a 4-D tensor map
// over (K, Bp, direction, T) (strides 2K, 2*Bp*K and 2*ndir*Bp*K bytes): a box
// of 64 x BR x 1 x BT lands in shared memory as BR*BT dense 128-byte rows
// in (t, r) order, which is the K-major operand wgmma reads.  BR divides
// Bp (or is BM when Bp > BM) and is chosen to fill the most of the BM
// rows with BT = BM / BR steps: Bp = 6 as 2 x 64, 8 as 8 x 16, 48 as
// 16 x 8, 32 as 32 x 4; every Bp below BM fills all BM rows (BR = 1
// does).  Every Bp works; the rows past BR*BT compute on stale shared
// memory and are not stored.  TMA zero-fills the step, row,
// K and N tails.  Wx[d] (K x N, N contiguous) is the N-major B operand:
// four 64-column boxes a stage, read by wgmma with its transpose-B bit.
// TMA needs 16-byte strides: K and N multiples of 8 (the wrapper pads K).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using idt::fence_acc;
using idt::global_ns;
using idt::smem_desc;
using idt::smem_u32;
using idt::wgmma_commit;
using idt::wgmma_fence;
using idt::wgmma_wait;

constexpr int BM = 128;                        // rows a tile
constexpr int BN = 256;                        // columns a tile
constexpr int BK = 64;                         // K a stage: 128 bytes of bf16
constexpr int STAGES = 3;
constexpr int CONSUMERS = BM / 64;             // warpgroups of m64
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STORER0 = CONSUMERS * 128 + 32;  // warps 1-3 of the last group
constexpr int STORERS = 96;
constexpr int A_STAGE = BM * BK * 2;
constexpr int B_BOX = BK * 64 * 2;             // 64 k rows x 64 columns
constexpr int B_STAGE = BN / 64 * B_BOX;
// The bf16 products of one tile, handed from the consumers to the
// storers; rows padded by 16 bytes so the consumers' writes of 8 rows x 4
// column pairs hit 32 banks.
constexpr int PITCH = BN * 2 + 16;
constexpr int STAGING = BM * PITCH;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) + STAGING +
                           (2 * STAGES + 2) * 8 + 1024;

struct Tiling {
  int T, Bp, N, ndir;
  int BR, BT;                  // A box: BR rows of each of BT steps
  int r_tiles, m_tiles, n_tiles, k_blocks, tiles;
};

struct Tile {
  int d, t0, r0, n0;
};

__device__ __forceinline__ Tile tile_at(const Tiling& s, int i) {
  const int per_dir = s.m_tiles * s.n_tiles;
  Tile x;
  x.d = i / per_dir;
  const int rem = i - x.d * per_dir;
  const int mt = rem / s.n_tiles;
  x.n0 = (rem - mt * s.n_tiles) * BN;
  const int tt = mt / s.r_tiles;
  x.t0 = tt * s.BT;
  x.r0 = (mt - tt * s.r_tiles) * s.BR;
  return x;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete; traps after
// idt::SPIN_LIMIT_NS (4 s).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > idt::SPIN_LIMIT_NS) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// D (64 x N, float32) += A (64 x 16, K-major) . B (16 x N, N-major).  The
// kernel's tiles are N = 256 wide; N = 128 builds the narrower tiles that
// probe_bilstm_proj.py times against them.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  if constexpr (N == 128)
    wgmma_m64n128k16(d, desc_a, desc_b);
  else
    wgmma_m64n256k16(d, desc_a, desc_b);
}

__global__ void __launch_bounds__(THREADS, 1)
bilstm_proj_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const float* __restrict__ bias, float* __restrict__ xp,
                   const Tiling s) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_base = base;
  const uint32_t b_base = base + STAGES * A_STAGE;
  const uint32_t staging = b_base + STAGES * B_STAGE;
  uint8_t* const staging_ptr = smem_raw + (staging - raw);
  const uint32_t full_bar = staging + STAGING;
  const uint32_t empty_bar = full_bar + STAGES * 8;
  const uint32_t staged_bar = empty_bar + STAGES * 8;   // products staged
  const uint32_t stored_bar = staged_bar + 8;           // staging free
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar + 8 * i, 1);
      mbar_init(empty_bar + 8 * i, CONSUMERS * 4);   // one per warp
    }
    mbar_init(staged_bar, CONSUMERS * 128);
    mbar_init(stored_bar, STORERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == CONSUMERS * 128) {
    // Producer: one thread keeps the ring full, across tiles.
    const uint32_t tx = 128u * s.BR * s.BT + B_STAGE;
    int st = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < s.tiles; i += gridDim.x) {
      const Tile x = tile_at(s, i);
      for (int kb = 0; kb < s.k_blocks; ++kb) {
        mbar_wait(empty_bar + 8 * st, phase ^ 1);
        const uint32_t full = full_bar + 8 * st;
        mbar_expect_tx(full, tx);
        tma_load_4d(a_base + st * A_STAGE, &a_map, full, kb * BK, x.r0, x.d,
                    x.t0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(b_base + st * B_STAGE + c * B_BOX, &b_map, full,
                      x.n0 + 64 * c, kb * BK, x.d);
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  const int R = s.ndir * s.Bp;
  if (threadIdx.x >= STORER0) {
    // Storers: the tile's bf16 products plus the bias, as float4 rows
    // (one 512-byte row segment a warp store), while the consumers run
    // the next tile.
    // Lane l stores columns 4l + 128c + {0..3}.
    const int u = threadIdx.x - STORER0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < s.tiles; i += gridDim.x) {
      const Tile x = tile_at(s, i);
      float4 bv[BN / 128];
#pragma unroll
      for (int c = 0; c < BN / 128; ++c) {
        const int n = x.n0 + 128 * c + 4 * lane;
        bv[c] = n < s.N ? __ldg(reinterpret_cast<const float4*>(
                              bias + static_cast<size_t>(x.d) * s.N + n))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mbar_wait(staged_bar, phase);
      for (int m = u / 32; m < s.BR * s.BT; m += STORERS / 32) {
        const int tl = m / s.BR;
        const int t = x.t0 + tl;
        const int r = x.r0 + (m - tl * s.BR);
        if (t >= s.T || r >= s.Bp) continue;
        float* const out =
            xp + (static_cast<size_t>(t) * R + x.d * s.Bp + r) * s.N + x.n0;
#pragma unroll
        for (int c = 0; c < BN / 128; ++c) {
          const int col = 128 * c + 4 * lane;
          if (x.n0 + col >= s.N) continue;
          const uint2 q = *reinterpret_cast<const uint2*>(
              staging_ptr + m * PITCH + 2 * col);
          const __nv_bfloat162 lo =
              *reinterpret_cast<const __nv_bfloat162*>(&q.x);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&q.y);
          float4 v;
          v.x = __low2float(lo) + bv[c].x;
          v.y = __high2float(lo) + bv[c].y;
          v.z = __low2float(hi) + bv[c].z;
          v.w = __high2float(hi) + bv[c].w;
          __stcs(reinterpret_cast<float4*>(out + col), v);
        }
      }
      mbar_arrive(stored_bar);
      phase ^= 1;
    }
    return;
  }
  if (wg == CONSUMERS) return;   // the producer warp's other lanes

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int row = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  int st = 0;
  uint32_t phase = 0, staged_phase = 0;
  float acc[BN / 2];
  for (int i = blockIdx.x; i < s.tiles; i += gridDim.x) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    fence_acc(acc);
    int prev = 0;
    for (int kb = 0; kb < s.k_blocks; ++kb) {
      mbar_wait(full_bar + 8 * st, phase);
      const uint32_t a = a_base + st * A_STAGE + wg * 64 * 128;
      const uint32_t b = b_base + st * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: 16 k a step are 32 bytes along the swizzled row; B: 16 k rows
        // of 128 bytes.
        wgmma_tile<BN>(acc, smem_desc(a + kk * 32, 16, 1024),
                       smem_desc(b + kk * 16 * 128, B_BOX, 1024));
      wgmma_commit();
      // The stage before this one is read once its group has completed.
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev);
      prev = st;
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

    // Hand the products over rounded to bf16 (RNE): this thread holds rows
    // `row` and `row + 8`, columns 8j + 2(lane % 4) + {0, 1}, j < BN / 8.
    mbar_wait(stored_bar, staged_phase ^ 1);
    uint8_t* const dst = staging_ptr + row * PITCH + 4 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * h * PITCH + 16 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                  acc[4 * j + 2 * h + 1]);
    mbar_arrive(staged_bar);
    staged_phase ^= 1;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; its address comes from the
// runtime's entry-point query, so the library links against the runtime
// alone.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int idt_bilstm_proj(const void* xin, const void* wx,
                               const void* bias, void* xp, int T, int Bp,
                               int K, int N, int ndir, cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and strides (K, N multiples of 8);
  // the storers' float4 accesses need 16-byte aligned bias and xp.
  if (T <= 0 || Bp <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 ||
      (ndir != 1 && ndir != 2) ||
      reinterpret_cast<uintptr_t>(xin) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);

  Tiling s;
  s.T = T;
  s.Bp = Bp;
  s.N = N;
  s.ndir = ndir;
  // A tile holds BT steps of BR rows; BR divides Bp (or is BM when Bp >
  // BM) and is the one that fills most of the BM rows.
  s.BR = BM;
  if (Bp < BM) {
    s.BR = Bp;
    for (int br = Bp; br >= 1; --br)
      if (Bp % br == 0 && br * (BM / br) > s.BR * (BM / s.BR)) s.BR = br;
  }
  s.BT = BM / s.BR;
  s.r_tiles = (Bp + s.BR - 1) / s.BR;
  const long long m_tiles =
      static_cast<long long>((T + s.BT - 1) / s.BT) * s.r_tiles;
  s.n_tiles = (N + BN - 1) / BN;
  s.k_blocks = (K + BK - 1) / BK;
  const long long tiles = ndir * m_tiles * s.n_tiles;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  s.m_tiles = static_cast<int>(m_tiles);
  s.tiles = static_cast<int>(tiles);

  // A: (K, Bp, direction, T) over xin; B: (N, K, direction) over wx.
  CUtensorMap a_map, b_map;
  const cuuint64_t k2 = static_cast<cuuint64_t>(K) * 2;
  const cuuint64_t a_dims[4] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(Bp),
                                static_cast<cuuint64_t>(ndir),
                                static_cast<cuuint64_t>(T)};
  const cuuint64_t a_strides[3] = {k2, k2 * Bp, k2 * ndir * Bp};
  const cuuint32_t a_box[4] = {BK, static_cast<cuuint32_t>(s.BR), 1,
                               static_cast<cuuint32_t>(s.BT)};
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(ndir)};
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                   static_cast<cuuint64_t>(N) * 2 * K};
  const cuuint32_t b_box[3] = {64, BK, 1};
  if (!encode(fn, &a_map, xin, 4, a_dims, a_strides, a_box) ||
      !encode(fn, &b_map, wx, 3, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);

  // The shared-memory opt-in and the SM count, once per device.
  static int sms_of[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bilstm_proj_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int grid = s.tiles < sms_of[device] ? s.tiles : sms_of[device];
  bilstm_proj_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      a_map, b_map, static_cast<const float*>(bias), static_cast<float*>(xp),
      s);
  return static_cast<int>(cudaGetLastError());
}
