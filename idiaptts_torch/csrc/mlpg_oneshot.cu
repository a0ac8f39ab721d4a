// One-shot MLPG: assemble one utterance's pentadiagonal MLPG system,
// factor it and solve L L^T x = b in one launch, independently in every
// lane (feature dimension).
//
// Replaces idiaptts_tpu/ops/pallas_mlpg.py:_mlpg_kernel (wrapper
// mlpg_pallas).  Same float32 recurrences:
//   l0_t = sqrt(max(a0_t - l1_{t-1}^2 - l2_{t-2}^2, 1e-20))
//   l1_t = (a1_t - l1_{t-1} l2_{t-1}) / l0_t
//   l2_t = a2_t / l0_t
//   y_t  = (b_t - l1_{t-1} y_{t-1} - l2_{t-2} y_{t-2}) / l0_t
//   x_t  = (y_t - l1_t x_{t+1} - l2_t x_{t+2}) / l0_t
// with zero carries before row 0 and after row T-1, so T = 1 and 2 need
// no special case (the TPU kernel needs T >= 3).  Each step takes 1/l0
// as the hardware's approximate reciprocal square root with one Newton
// step (~1 ulp), and multiplies by it in place of the three divides; the
// sums go into FMAs.
//
// Two modes, one kernel:
// - fused (MLPG.generation): the inputs are the window means (T, 3L)
//   [statics | deltas | delta-deltas] and the diagonal variances (3L,);
//   the kernel builds a0, a1, a2 and b with exactly the terms, and the
//   order of sums, of ops/mlpg.py:_banded_precision and _b_vector,
//   including the 1e11 delta variances of the first and last frames;
// - thin (mlpg_oneshot): b, a0, a1, a2 are given, each (T, L).
//
// What bounds it: the factorisation is a nonlinear recurrence of T
// dependent steps a lane (sqrt, reciprocal, a few FMAs), then the
// backward substitution T steps of one FMA and one multiply; with L = 1
// to 60 lanes the card is idle but for that chain.  So nothing else may
// sit on it: a block holds LC lanes, one chain thread each in warp 0,
// and seven helper warps assemble (or copy) the system rows one chunk of
// CHUNK rows at a time into a store in shared memory, signalling each
// chunk on its own mbarrier; the chain thread waits on the chunk's
// mbarrier (long since complete but for the first chunk) and reads its
// rows from shared memory, eight rows loaded ahead of the eight it
// computes.  Each row's (a0, a1, a2, b) is overwritten in place by
// (1/l0, l1, l2, y), the backward sweep reads them back in reverse and
// leaves x in the y slot, and after a block barrier all warps copy x out
// coalesced.  The store takes T * LC * 16 bytes; plan() picks LC so that
// it fits the block's shared memory (227 KB on an H100: LC = 20 at
// T = 512, 6 at T = 2048), and only where one lane does not fit
// (T > ~14,500) does the caller pass a global scratch of the same
// layout, which the same code reads through the L1/L2 caches.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int CHUNK = 32;           // rows per mbarrier
constexpr int GROUP = 8;            // rows the chain loads ahead
constexpr int HELPERS = 7;          // helper warps
constexpr int UNROLL = 4;           // rows a helper thread builds at once
constexpr int THREADS = 32 * (1 + HELPERS);
constexpr float BOUNDARY_VAR = 1e11f;

struct Args {
  const float* in;    // fused: means (T, 3L); thin: b (T, L)
  const float* var;   // fused: variances (3L,); thin: null
  const float* a0;    // thin: (T, L) each; fused: null
  const float* a1;
  const float* a2;
  float4* scratch;    // (grid, T, LC) when the store does not fit; or null
  float* x;           // (T, L)
  int T, L, LC, nchunks;
};

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   idt::smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];" ::"r"(
                   idt::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint64_t* bar) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(idt::smem_u32(bar))
      : "memory");
  return done != 0;
}

// Wait for a chunk's first (and only) phase; a wait longer than
// SPIN_LIMIT_NS traps.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  if (bar_try_wait(bar)) return;
  const uint64_t t0 = idt::global_ns();
  while (!bar_try_wait(bar))
    if (idt::global_ns() - t0 > idt::SPIN_LIMIT_NS) __trap();
}

// Row t of lane l of the fused system: (a0, a1, a2, b), as
// _banded_precision and _b_vector sum them (zero terms outside [0, T)
// left out: adding 0 changes nothing).  tau = 1/var of the lane's three
// windows; the deltas take 1/1e11 on the first and last frame.
__device__ __forceinline__ float4 assemble(const Args& a, int t, int l,
                                           float tau0, float v1, float v2) {
  const int T = a.T, L = a.L;
  const float tb = __frcp_rn(BOUNDARY_VAR);
  auto tau1 = [&](int u) { return (u == 0 || u == T - 1) ? tb : v1; };
  auto tau2 = [&](int u) { return (u == 0 || u == T - 1) ? tb : v2; };
  const float* m = a.in;
  const int S = 3 * L;
  const bool prev = t >= 1, next = t + 1 < T, next2 = t + 2 < T;
  const float tau1p = prev ? tau1(t - 1) : 0.f;
  const float tau1n = next ? tau1(t + 1) : 0.f;
  const float tau2p = prev ? tau2(t - 1) : 0.f;
  const float tau2c = tau2(t);
  const float tau2n = next ? tau2(t + 1) : 0.f;

  float a0 = tau0;
  if (next) a0 = __fadd_rn(a0, __fmul_rn(0.25f, tau1n));
  if (prev) a0 = __fadd_rn(a0, __fmul_rn(0.25f, tau1p));
  if (next) a0 = __fadd_rn(a0, tau2n);
  a0 = __fadd_rn(a0, __fmul_rn(4.f, tau2c));
  if (prev) a0 = __fadd_rn(a0, tau2p);
  const float a1 =
      next ? __fadd_rn(__fmul_rn(-2.f, tau2n), __fmul_rn(-2.f, tau2c)) : 0.f;
  const float a2 =
      next2 ? __fadd_rn(__fmul_rn(-0.25f, tau1n), tau2n) : 0.f;

  const float q1p = prev ? __fmul_rn(m[(t - 1) * S + L + l], tau1p) : 0.f;
  const float q1n = next ? __fmul_rn(m[(t + 1) * S + L + l], tau1n) : 0.f;
  const float q2p = prev ? __fmul_rn(m[(t - 1) * S + 2 * L + l], tau2p) : 0.f;
  const float q2c = __fmul_rn(m[t * S + 2 * L + l], tau2c);
  const float q2n = next ? __fmul_rn(m[(t + 1) * S + 2 * L + l], tau2n) : 0.f;
  float b = __fmul_rn(m[t * S + l], tau0);
  b = __fadd_rn(b, __fmul_rn(-0.5f, q1n));
  b = __fadd_rn(b, __fmul_rn(0.5f, q1p));
  b = __fadd_rn(b, q2n);
  b = __fadd_rn(b, __fmul_rn(-2.f, q2c));
  b = __fadd_rn(b, q2p);
  return make_float4(a0, a1, a2, b);
}

// 1/sqrt(v) for v >= 1e-20: the hardware approximation and one Newton
// step, ~1 ulp (a correctly rounded sqrt and reciprocal cost twice the
// latency on the chain).
__device__ __forceinline__ float rsqrt_newton(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return fmaf(0.5f * r, fmaf(-v * r, r, 1.f), r);
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS) mlpg_oneshot_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int T = a.T, LC = a.LC;
  const int bar_bytes = (a.nchunks * 8 + 15) / 16 * 16;
  float4* store =
      kShared ? reinterpret_cast<float4*>(smem + bar_bytes)
              : a.scratch + static_cast<size_t>(blockIdx.x) * T * LC;
  const int base = blockIdx.x * LC;
  const int nl = min(LC, a.L - base);  // lanes of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  __shared__ float taus[3][32];  // 1/var of the lanes (fused)
  for (int k = tid; k < a.nchunks; k += THREADS) bar_init(&bars[k], 32);
  if (a.var != nullptr && tid < 3 * nl) {
    const int w = tid / nl, j = tid % nl;
    taus[w][j] = __frcp_rn(a.var[w * a.L + base + j]);
  }
  __syncthreads();

  if (warp > 0) {
    // Helpers: chunk k by warp 1 + k % HELPERS, in order; each thread
    // builds UNROLL rows at once, so their loads are in flight together.
    for (int k = warp - 1; k < a.nchunks; k += HELPERS) {
      const int t0 = k * CHUNK;
      const int n = min(CHUNK, T - t0) * nl;
      for (int e0 = lane; e0 < n; e0 += 32 * UNROLL) {
        float4 row[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = e0 + 32 * u;
          if (e < n) {
            const int t = t0 + e / nl, j = e % nl, l = base + j;
            if (a.var != nullptr) {
              row[u] = assemble(a, t, l, taus[0][j], taus[1][j], taus[2][j]);
            } else {
              const int i = t * a.L + l;
              row[u] = make_float4(a.a0[i], a.a1[i], a.a2[i], a.in[i]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = e0 + 32 * u;
          if (e < n) store[(t0 + e / nl) * LC + e % nl] = row[u];
        }
      }
      bar_arrive(&bars[k]);
    }
  } else if (lane < nl) {
    const int j = lane;
    // Forward: factor row t and y_t; (a0, a1, a2, b) -> (1/l0, l1, l2, y).
    float l1m1 = 0.f, l2m1 = 0.f, l2m2 = 0.f;  // l1_{t-1}, l2_{t-1}, l2_{t-2}
    float ym1 = 0.f, ym2 = 0.f;                // y_{t-1}, y_{t-2}
    auto forward = [&](const float4 s, int t) {
      const float c0 = fmaf(-l2m2, l2m2, s.x);  // l2_{t-2}: off the chain
      const float n1 = fmaf(-l1m1, l2m1, s.y);
      const float v = fmaxf(fmaf(-l1m1, l1m1, c0), 1e-20f);
      const float r = rsqrt_newton(v);
      const float l1 = n1 * r;
      const float l2 = s.z * r;
      const float y = fmaf(-l1m1, ym1, fmaf(-l2m2, ym2, s.w)) * r;
      store[t * LC + j] = make_float4(r, l1, l2, y);
      l2m2 = l2m1;
      l1m1 = l1;
      l2m1 = l2;
      ym2 = ym1;
      ym1 = y;
    };
    // Whole groups of rows with no bounds checks on the chain (a branch
    // a step would keep the compiler from overlapping the steps), then
    // the last rows.
    const int full = T / GROUP * GROUP;
    float4 cur[GROUP], nxt[GROUP];
    bar_wait(&bars[0]);
    if (full > 0) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) cur[i] = store[i * LC + j];
    }
    for (int t0 = 0; t0 < full; t0 += GROUP) {
      const int n0 = t0 + GROUP;
      if (n0 < full) {
        if (n0 % CHUNK == 0) bar_wait(&bars[n0 / CHUNK]);
#pragma unroll
        for (int i = 0; i < GROUP; ++i) nxt[i] = store[(n0 + i) * LC + j];
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) forward(cur[i], t0 + i);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) cur[i] = nxt[i];
    }
    if (full < T && full > 0 && full % CHUNK == 0)
      bar_wait(&bars[full / CHUNK]);
    for (int t = full; t < T; ++t) forward(store[t * LC + j], t);

    // Backward: x_t into the y slot; the last rows, then whole groups,
    // eight rows loaded ahead.
    float xp1 = 0.f, xp2 = 0.f;  // x_{t+1}, x_{t+2}
    auto backward = [&](const float4 f, int t) {
      const float xv = fmaf(-f.y, xp1, fmaf(-f.z, xp2, f.w)) * f.x;
      store[t * LC + j].w = xv;
      xp2 = xp1;
      xp1 = xv;
    };
    for (int t = T - 1; t >= full; --t) backward(store[t * LC + j], t);
    if (full > 0) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        cur[i] = store[(full - GROUP + i) * LC + j];
    }
    for (int t0 = full - GROUP; t0 >= 0; t0 -= GROUP) {
      if (t0 >= GROUP) {
#pragma unroll
        for (int i = 0; i < GROUP; ++i)
          nxt[i] = store[(t0 - GROUP + i) * LC + j];
      }
#pragma unroll
      for (int i = GROUP - 1; i >= 0; --i) backward(cur[i], t0 + i);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) cur[i] = nxt[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < T * nl; e += THREADS) {
    const int t = e / nl, j = e % nl;
    a.x[t * a.L + base + j] = store[t * LC + j].w;
  }
}

// What the plan needs of a device, read once per device: the dynamic
// shared memory a block of the shared-store kernel may have (the opt-in
// limit less the kernel's static bytes), raised to on that device.
constexpr int MAX_DEVICES = 64;
std::mutex limits_mutex;
size_t smem_max_of[MAX_DEVICES];  // 0: not read yet

cudaError_t device_smem_max(size_t* smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(limits_mutex);
  if (smem_max_of[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, mlpg_oneshot_kernel<true>);
    if (err != cudaSuccess) return err;
    const size_t most = static_cast<size_t>(optin) - fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(mlpg_oneshot_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return err;
    smem_max_of[dev] = most;
  }
  *smem_max = smem_max_of[dev];
  return cudaSuccess;
}

// K1's launch plan on the current device for (T, L): LC lanes a block,
// the mbarriers' bytes, the dynamic shared memory of a block, and
// whether the store fits there (else it goes to a global scratch of
// (ceil(L / LC), T, LC) float4).
struct Plan {
  int LC;
  size_t bar_bytes, smem;
  bool shared;
};

cudaError_t plan(int T, int L, Plan* p) {
  size_t smem_max = 0;
  const cudaError_t err = device_smem_max(&smem_max);
  if (err != cudaSuccess) return err;
  const size_t nchunks = (static_cast<size_t>(T) + CHUNK - 1) / CHUNK;
  const size_t bar_bytes = (nchunks * 8 + 15) / 16 * 16;
  p->bar_bytes = bar_bytes;
  const size_t row_bytes = static_cast<size_t>(T) * sizeof(float4);
  const size_t fit =
      smem_max > bar_bytes ? (smem_max - bar_bytes) / row_bytes : 0;
  const int most = L < 32 ? L : 32;
  p->shared = fit >= 1;
  p->LC = p->shared && fit < static_cast<size_t>(most)
              ? static_cast<int>(fit) : most;
  p->smem = bar_bytes + (p->shared ? row_bytes * p->LC : 0);
  return cudaSuccess;
}

}  // namespace

// The plan for (T, L) on the current device: `lanes` a block, and the
// bytes of global scratch a launch must be given (0 when the store fits
// shared memory).
extern "C" int idt_mlpg_oneshot_plan(int T, int L, int* lanes,
                                     long long* scratch_bytes) {
  if (T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(T, L, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  *lanes = p.LC;
  *scratch_bytes = p.shared ? 0
                            : static_cast<long long>((L + p.LC - 1) / p.LC) *
                                  T * p.LC * sizeof(float4);
  return 0;
}

// Fused mode when `var` is not null (in: means (T, 3L)); thin mode
// otherwise (in: b, and a0/a1/a2, each (T, L)).  The store lives in
// shared memory unless `scratch` is given (the bytes that
// idt_mlpg_oneshot_plan names), which it must be where the plan says the
// store does not fit.
extern "C" int idt_mlpg_oneshot(const void* in, const void* var,
                                const void* a0, const void* a1,
                                const void* a2, void* scratch, void* x,
                                int T, int L, cudaStream_t stream) {
  if (T <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (var == nullptr && (a0 == nullptr || a1 == nullptr || a2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = plan(T, L, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!p.shared && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(in),
               static_cast<const float*>(var),
               static_cast<const float*>(a0),
               static_cast<const float*>(a1),
               static_cast<const float*>(a2),
               static_cast<float4*>(scratch),
               static_cast<float*>(x),
               T, L, p.LC, (T + CHUNK - 1) / CHUNK};
  const int blocks = (L + p.LC - 1) / p.LC;
  if (scratch == nullptr) {
    mlpg_oneshot_kernel<true><<<blocks, THREADS, p.smem, stream>>>(a);
  } else {
    mlpg_oneshot_kernel<false><<<blocks, THREADS, p.bar_bytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
