// BiLSTM input projection, per direction d and row r of step t:
//   xp[t, d*Bp + r, :] = bf16(xin[t, d*Bp + r, :] . Wx[d]) + b[d]
//
// Replaces the projection half of idiaptts_tpu/ops/pallas_lstm.py:
// _bilstm_layer_kernel (wrapper _layer_tmajor), lines 615-625: bf16
// operands, float32 accumulation, the product rounded to bf16 (what the
// scan path's bf16 einsum emits), then the float32 bias added.  The
// recurrence half of that kernel is bilstm_recurrence.cu, launched right
// after this one.
//
// Layout (the JAX package's time-major layer layout):
//   xin  (T, R, K) bf16, R = 2*Bp rows per step: [fwd Bp | bwd Bp]
//   wx   (2, K, N) bf16, N = 4F, row-major per direction
//   b    (2, N) float32
//   xp   (T, R, N) float32
// Per direction this is one (T*Bp, K) x (K, N) GEMM whose row m = (t, r)
// lives at xin row t*R + d*Bp + r.
//
// What bounds it: at the serving shapes (T = 512, Bp = 6 or 48,
// K = 1024, N = 2048) a layer is 26 to 206 GFLOP (both directions) on
// 71 to 512 MB of operands and float32 output, 360 to 400 FLOP per
// byte, above the H100's ~295 FLOP/byte ridge: tensor-core bound.  This
// first version is a plain tiled WMMA GEMM (64x64 block tile, 4 warps of
// 32x32, K step 32, one shared-memory stage, no TMA or wgmma), far below
// the card's bf16 peak; its time beside the plain version's is in
// PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;   // bf16 elements; row stride 80 B
constexpr int B_LD = BN + 8;   // row stride 144 B
constexpr int C_LD = BN + 4;   // float elements

__global__ void __launch_bounds__(THREADS)
bilstm_proj_kernel(const __nv_bfloat16* __restrict__ xin,
                   const __nv_bfloat16* __restrict__ wx,
                   const float* __restrict__ bias, float* __restrict__ xp,
                   int T, int Bp, int K, int N) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int d = blockIdx.z;
  const int M = T * Bp;
  const int R = 2 * Bp;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;   // warp tile row (0..1) of 32 rows
  const int wn = warp % 2;   // warp tile col (0..1) of 32 cols
  const __nv_bfloat16* w_d = wx + static_cast<size_t>(d) * K * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 64 rows x 32 cols = 256 chunks of 8 bf16 (16 B).
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int row = c / (BK / 8);
      const int col = (c % (BK / 8)) * 8;
      const int m = m0 + row;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && k0 + col < K) {
        const int t = m / Bp;
        const int r = m - t * Bp;
        const size_t src = (static_cast<size_t>(t) * R + d * Bp + r) * K +
                           k0 + col;
        v = *reinterpret_cast<const uint4*>(xin + src);
      }
      *reinterpret_cast<uint4*>(&As[row * A_LD + col]) = v;
    }
    // B tile: 32 rows x 64 cols = 256 chunks.
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int row = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + row < K && n0 + col < N) {
        v = *reinterpret_cast<const uint4*>(
            w_d + static_cast<size_t>(k0 + row) * N + n0 + col);
      }
      *reinterpret_cast<uint4*>(&Bs[row * B_LD + col]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16],
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j], C_LD,
          wmma::mem_row_major);
  __syncthreads();

  // Epilogue: round the f32 product to bf16 (RNE), add the f32 bias.
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int row = e / BN;
    const int col = e % BN;
    const int m = m0 + row;
    const int n = n0 + col;
    if (m < M && n < N) {
      const int t = m / Bp;
      const int r = m - t * Bp;
      const float prod =
          __bfloat162float(__float2bfloat16_rn(Cs[row * C_LD + col]));
      xp[(static_cast<size_t>(t) * R + d * Bp + r) * N + n] =
          prod + bias[d * N + n];
    }
  }
}

}  // namespace

extern "C" int idt_bilstm_proj(const void* xin, const void* wx,
                               const void* bias, void* xp, int T, int Bp,
                               int K, int N, cudaStream_t stream) {
  // 16-byte vector loads need K and N to be multiples of 8 and aligned
  // base pointers.
  if (T <= 0 || Bp <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(xin) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(T) * Bp;
  const long long row_tiles = (M + BM - 1) / BM;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, static_cast<unsigned>(row_tiles), 2);
  bilstm_proj_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(xin),
      static_cast<const __nv_bfloat16*>(wx), static_cast<const float*>(bias),
      static_cast<float*>(xp), T, Bp, K, N);
  return static_cast<int>(cudaGetLastError());
}
