// MLPG banded substitution: solve L L^T x = b for a bandwidth-2 Cholesky
// factor, independently in every lane, with the time axis split into
// chunks that run in parallel.
//
// Replaces idiaptts_tpu/ops/pallas_mlpg.py:_solve_kernel (wrapper
// solve_banded_pallas).  Same recurrences and zero-carry boundary:
//   forward   y_t = (b_t - l1_{t-1} y_{t-1} - l2_{t-2} y_{t-2}) / l0_t
//   backward  x_t = (y_t - l1_t x_{t+1}     - l2_t x_{t+2})     / l0_t
// with y_{-1} = y_{-2} = x_T = x_{T+1} = 0.  As on the TPU, each step
// multiplies by 1/l0 (correctly rounded, taken as the row is loaded, off
// the chain) instead of dividing, and the sums go into FMAs.
//
// Two modes, one kernel:
// - fused (the served MLPG stage): the right-hand side is assembled here
//   from the model output (B, T, C) through a column map of 3 columns per
//   MLPG dimension [statics | deltas | delta-deltas], and the
//   per-frame window precisions tau (T, 3, D), with exactly the terms of
//   ops/mlpg.py:_b_vector; the factor (l0, l1, l2), each (T, D), is shared
//   by the B utterances (lane = b * D + d reads row d), and x is written
//   as (B, T, D).
// - thin (solve_banded): b is given as (T, L) and the factor as (T, L):
//   B = 1, D = C = L.
//
// What bounds it: each lane is a linear recurrence of 2T dependent
// steps, a few hundred lanes on a card of 132 SMs, so a sequential sweep
// is latency-bound (~0.2 ms at T = 512, about one L2 round trip a step,
// in the first version of this kernel).  Here one thread owns one
// (lane, chunk of R rows) pair and all chunks of a lane sit in one block:
//   (a) each thread loads its rows (and assembles b) before any
//       dependent arithmetic, then runs its chunk's recurrence in
//       registers with zero carries, and beside it the responses to the
//       unit carries (1, 0) and (0, 1);
//   (b) the chunk's two outgoing values are an affine function of its
//       two incoming carries, z + M (p, q); one thread per lane walks the
//       chunks through shared memory and hands each its true carries;
//   (c) each thread runs its chunk again from its true carries.
// The backward sweep does the same in reverse; y stays in registers
// between the sweeps and never goes to global memory.  The chain is
// 2 (2R + P) dependent steps of one FMA and one multiply (plus two block
// barriers a sweep) instead of 2T divides and loads.  The homogeneous
// solutions that carry the correction decay away from the chunk edge
// (the inverse of a well-conditioned banded factor decays off its
// diagonal), so phase (c) is the sequential recurrence from carries that
// are right to rounding.
//
// A block holds at most NC = 256 chunks a lane (4096 rows).  A longer
// lane runs as S super-chunks of NC chunks in order, the walking thread
// carrying (p, q) from one to the next: the forward sweep leaves each
// super-chunk's y but the last in the x buffer, and the backward sweep,
// which starts on the last super-chunk still in registers, loads each
// earlier one's y back with its factor rows before that super-chunk's
// chain.  So any T runs, and T <= 4096 (S = 1) never stores y.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 16;         // rows a thread owns: one chunk
constexpr int THREADS = 256;  // most threads a block (LB * NC), and so
                              // most chunks a lane in a block

struct Args {
  const float* in;      // fused: model output (B, T, C); thin: b (T, L)
  const int* colmap;    // fused: (3D,) columns of `in`; thin: null
  const float* tau;     // fused: (T, 3, D); thin: null
  const float* l0;      // (T, D)
  const float* l1;      // (T, D)
  const float* l2;      // (T, D)
  float* x;             // (B, T, D); also y of all super-chunks but the last
  int B, T, D, C;
  int NC;               // chunks a lane in a block: min(ceil(T / R), 256)
  int S;                // super-chunks: ceil(ceil(T / R) / NC)
  int LB;               // lanes a block; blockDim.x = LB * NC
};

// The factor rows s .. s + R - 1 of dimension d: 1/l0 (l0 until the
// caller takes the reciprocals), l1, l2; rows past T are identity rows
// (zeros), which give x = 0 and zero carries.
__device__ __forceinline__ void load_factor(const Args& a, int s, int d,
                                            float (&inv)[R], float (&f1)[R],
                                            float (&f2)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = s + r;
    const bool in = t < a.T;
    inv[r] = in ? a.l0[t * a.D + d] : 0.f;
    f1[r] = in ? a.l1[t * a.D + d] : 0.f;
    f2[r] = in ? a.l2[t * a.D + d] : 0.f;
  }
}

__device__ __forceinline__ void take_reciprocals(int s, int T,
                                                 float (&inv)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) inv[r] = s + r < T ? __frcp_rn(inv[r]) : 0.f;
}

// One sweep's phase (b) around the chunks' summaries z: the thread of
// chunk 0 (the walker) walks the carries (p, q) over the NC chunks, from
// the last chunk down when `backward`, starting from the (p, q) it holds
// and leaving there the super-chunk's outgoing carries; every thread
// gets its chunk's true carries.  summ and carry are [value][chunk * LB
// + lane in block].
__device__ __forceinline__ float2 walk_carries(float (&summ)[6][THREADS],
                                               float (&carry)[2][THREADS],
                                               const float (&z)[6], int ll,
                                               int LB, int NC,
                                               bool walker, float& p,
                                               float& q, bool backward) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int v = 0; v < 6; ++v) summ[v][tid] = z[v];
  __syncthreads();
  if (walker) {
#pragma unroll 4
    for (int k0 = 0; k0 < NC; ++k0) {
      const int i = (backward ? NC - 1 - k0 : k0) * LB + ll;
      carry[0][i] = p;
      carry[1][i] = q;
      const float np = fmaf(summ[2][i], p, fmaf(summ[3][i], q, summ[0][i]));
      const float nq = fmaf(summ[4][i], p, fmaf(summ[5][i], q, summ[1][i]));
      p = np;
      q = nq;
    }
  }
  __syncthreads();
  return make_float2(carry[0][tid], carry[1][tid]);
}

// Blocks of 256 threads keep their registers to 128 so that two fit an
// SM: past one wave (T > 1024 at B = 48) that is 27% faster, and no
// slower below it.
__global__ void __launch_bounds__(THREADS, 2)
    banded_solve_kernel(const Args a) {
  __shared__ float summ[6][THREADS];
  __shared__ float carry[2][THREADS];
  const int tid = threadIdx.x;
  const int LB = a.LB, T = a.T, D = a.D, NC = a.NC;
  const int ll = tid % LB;
  const int c = tid / LB;
  const int lane = blockIdx.x * LB + ll;
  const bool active = lane < a.B * D;
  const bool walker = c == 0 && active;
  const int bb = active ? lane / D : 0;
  const int d = active ? lane % D : 0;
  const bool fused = a.colmap != nullptr;
  int c0 = d, c1 = 0, c2 = 0;
  if (active && fused) {
    c0 = a.colmap[d];
    c1 = a.colmap[D + d];
    c2 = a.colmap[2 * D + d];
  }
  float* out = a.x + static_cast<size_t>(bb) * T * D + d;

  // This chunk's rows: b (then y, then x), 1/l0, l1, l2.
  float bv[R], inv[R], f1[R], f2[R];
  float p = 0.f, q = 0.f;  // the walker's carries, across super-chunks

  // ---- forward: L y = b, super-chunks in order ----------------------------
  for (int sc = 0; sc < a.S; ++sc) {
    const int s = (sc * NC + c) * R;
    // l1_{s-1}, l2_{s-1}, l2_{s-2} for the first two rows.  Every load is
    // issued before the reciprocals, whose slow-path branches would
    // otherwise hold the later loads back.
    float f1m = 0.f, f2m1 = 0.f, f2m2 = 0.f;
    if (active) {
      load_factor(a, s, d, inv, f1, f2);
      if (s >= 1 && s - 1 < T) {
        f1m = a.l1[(s - 1) * D + d];
        f2m1 = a.l2[(s - 1) * D + d];
      }
      if (s >= 2 && s - 2 < T) f2m2 = a.l2[(s - 2) * D + d];
      if (!fused) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = s + r;
          bv[r] = t < T ? a.in[t * a.C + d] : 0.f;
        }
      } else {
        // b_t = btau0_t - 0.5 btau1_{t+1} + 0.5 btau1_{t-1} + btau2_{t+1}
        //       - 2 btau2_t + btau2_{t-1}, in _b_vector's order, with
        // btau_w = mean_w * tau_w and zeros outside [0, T).
        const float* m = a.in + static_cast<size_t>(bb) * T * a.C;
        // btau0 at rows s .. s + R - 1, btau1 and btau2 at s - 1 .. s + R:
        // every load predicated, none behind a branch, so that all are in
        // flight at once.  Rows past T get a b that their 1/l0 = 0
        // ignores.
        float q0[R], q1[R + 2], q2[R + 2];
#pragma unroll
        for (int r = 0; r < R + 2; ++r) {
          const int t = s - 1 + r;
          const bool in = t >= 0 && t < T;
          q1[r] = in ? __fmul_rn(m[t * a.C + c1], a.tau[(t * 3 + 1) * D + d])
                     : 0.f;
          q2[r] = in ? __fmul_rn(m[t * a.C + c2], a.tau[(t * 3 + 2) * D + d])
                     : 0.f;
          if (r >= 1 && r <= R)
            q0[r - 1] = in ? __fmul_rn(m[t * a.C + c0], a.tau[t * 3 * D + d])
                           : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float b = q0[r];
          b = __fadd_rn(b, __fmul_rn(-0.5f, q1[r + 2]));
          b = __fadd_rn(b, __fmul_rn(0.5f, q1[r]));
          b = __fadd_rn(b, q2[r + 2]);
          b = __fadd_rn(b, __fmul_rn(-2.f, q2[r + 1]));
          b = __fadd_rn(b, q2[r]);
          bv[r] = b;
        }
      }
      take_reciprocals(s, T, inv);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r] = inv[r] = f1[r] = f2[r] = 0.f;
    }

    // (a) zero carries, and the responses to y_{s-1} = 1 (u), y_{s-2} = 1
    // (v).  Three independent chains: the latency of one.
    float y1 = 0.f, y2 = 0.f, u1 = 1.f, u2 = 0.f, v1 = 0.f, v2 = 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s1 = r == 0 ? f1m : f1[r - 1];
      const float s2 = r == 0 ? f2m2 : (r == 1 ? f2m1 : f2[r - 2]);
      const float yn = fmaf(-s1, y1, fmaf(-s2, y2, bv[r])) * inv[r];
      const float un = fmaf(-s1, u1, -s2 * u2) * inv[r];
      const float vn = fmaf(-s1, v1, -s2 * v2) * inv[r];
      y2 = y1; y1 = yn;
      u2 = u1; u1 = un;
      v2 = v1; v1 = vn;
    }
    // (b) outgoing (y_{e-1}, y_{e-2}) = (y1, y2) + [[u1, v1], [u2, v2]]
    // (p, q), walked from (p, q) = (y_{s-1}, y_{s-2}) of the first chunk.
    const float z[6] = {y1, y2, u1, v1, u2, v2};
    const float2 cin = walk_carries(summ, carry, z, ll, LB, NC, walker,
                                    p, q, false);
    // (c) the chunk again from its true carries; y replaces b.
    y1 = cin.x;
    y2 = cin.y;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s1 = r == 0 ? f1m : f1[r - 1];
      const float s2 = r == 0 ? f2m2 : (r == 1 ? f2m1 : f2[r - 2]);
      const float yn = fmaf(-s1, y1, fmaf(-s2, y2, bv[r])) * inv[r];
      bv[r] = yn;
      y2 = y1;
      y1 = yn;
    }
    if (sc + 1 < a.S && active) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (s + r < T) out[(s + r) * D] = bv[r];
    }
  }

  // ---- backward: L^T x = y, super-chunks and chunks in reverse ----------
  p = q = 0.f;
  for (int sc = a.S - 1; sc >= 0; --sc) {
    const int s = (sc * NC + c) * R;
    if (sc + 1 < a.S && active) {
      // This thread's rows of an earlier super-chunk: its own y back.
      load_factor(a, s, d, inv, f1, f2);
#pragma unroll
      for (int r = 0; r < R; ++r) bv[r] = s + r < T ? out[(s + r) * D] : 0.f;
      take_reciprocals(s, T, inv);
    }
    // (a) zero carries, and the responses to x_e = 1 (u), x_{e+1} = 1 (v).
    float x1 = 0.f, x2 = 0.f, u1 = 1.f, u2 = 0.f, v1 = 0.f, v2 = 1.f;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const float xn = fmaf(-f1[r], x1, fmaf(-f2[r], x2, bv[r])) * inv[r];
      const float un = fmaf(-f1[r], u1, -f2[r] * u2) * inv[r];
      const float vn = fmaf(-f1[r], v1, -f2[r] * v2) * inv[r];
      x2 = x1; x1 = xn;
      u2 = u1; u1 = un;
      v2 = v1; v1 = vn;
    }
    // (b) outgoing (x_s, x_{s+1}) = (x1, x2) + [[u1, v1], [u2, v2]] (p, q),
    // walked from (p, q) = (x_e, x_{e+1}) of the last chunk down.
    const float z[6] = {x1, x2, u1, v1, u2, v2};
    const float2 cin = walk_carries(summ, carry, z, ll, LB, NC, walker,
                                    p, q, true);
    // (c) the chunk from its true carries, x to global memory.
    x1 = cin.x;
    x2 = cin.y;
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const float xn = fmaf(-f1[r], x1, fmaf(-f2[r], x2, bv[r])) * inv[r];
      x2 = x1;
      x1 = xn;
      if (active && s + r < T) out[(s + r) * D] = xn;
    }
  }
}

}  // namespace

// Fused mode when `colmap` is not null (in: (B, T, C) model output, tau:
// (T, 3, D)); thin mode otherwise (in: b (T, D), B = 1, C = D).  The
// factor rows l0/l1/l2 are (T, D); x is (B, T, D).  Blocks of about 256
// threads: as many lanes as fit beside one lane's chunks.
extern "C" int idt_banded_solve(const void* in, const void* colmap,
                                const void* tau, const void* l0,
                                const void* l1, const void* l2, void* x,
                                int B, int T, int D, int C,
                                cudaStream_t stream) {
  if (B <= 0 || T <= 0 || D <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((colmap == nullptr) != (tau == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = (T + R - 1) / R;
  const int NC = P < THREADS ? P : THREADS;
  int LB = 1;
  while (LB < 32 && 2 * LB * NC <= THREADS) LB *= 2;
  const Args a{static_cast<const float*>(in),
               static_cast<const int*>(colmap),
               static_cast<const float*>(tau),
               static_cast<const float*>(l0),
               static_cast<const float*>(l1),
               static_cast<const float*>(l2),
               static_cast<float*>(x),
               B, T, D, C, NC, (P + NC - 1) / NC, LB};
  const int blocks = (B * D + LB - 1) / LB;
  banded_solve_kernel<<<blocks, LB * NC, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
