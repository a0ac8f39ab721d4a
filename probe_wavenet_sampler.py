#!/usr/bin/env python3
"""Where a step of the WaveNet sampler kernel goes, on one NVIDIA GPU.

    python3 probe_wavenet_sampler.py [--parent DIR] [--batches B ...]
        [--steps T] [--variants NAME ...]   # from the repository root

Builds variants of ``idiaptts_torch/csrc/wavenet_sampler.cu`` (text
substitutions of the source at fixed anchors; a variant with a part
left out computes garbage and serves only for timing), times each over
T = 4000 sampling steps (``--steps``) at the production widths (20
layers, C = 23) at B = 1, 16 and 256 (``--batches``) with CUDA events,
samples the SM clock and the power draw with ``nvidia-smi`` while each
runs, and prints one JSON line of microseconds per step:

- ``kernel``: the kernel as it is;
- ``parent``: ``DIR/idiaptts_torch/csrc/wavenet_sampler.cu`` (a checkout
  of an earlier kernel with the single-block, weight-streaming entry
  point), fed the same weights; left out without ``--parent``;
- ``no_handoff``: no hand-off between the cluster's CTAs (no waits, no
  sends, zeros read from the inbox): each CTA's own work a step, the
  CTAs in parallel;
- ``handoffs_only``: the layer and output work left out: the ring of
  hand-offs alone;
- ``exact_activation``: ``tanhf`` and ``1 / (1 + expf(-x))`` in place of
  ``tanh.approx``;
- ``no_precompute``: past·K0 + cond·Wc computed after x arrives, on the
  chain;
- ``no_output``: post1, post2 and the draw left out;
- ``post2_fma``: post2 as float32 FMAs, each thread's P2 column in
  registers (the post blob then holds P2 in float32 where the kernel's
  holds its two bf16 parts);
- ``no_ring_store``: the layers' ring writes left out;
- ``cheap_activation``: ``tanh(a) * sigmoid(b)`` replaced by ``a * b``;
- ``activation_f16x2``: the activations as ``tanh.approx.f16x2``, two
  values an instruction;
- ``no_x_barrier``: the block barrier after each layer's x store left
  out (its cost and the warps' skew).

It also runs ``micro``: latencies on one SM from ``clock64`` (cycles
and ns at the clock read beside them): a dependent ``mma.sync``
m16n8k16 (and, with four chains in each of 8 warps, the cycles one
takes of an SM sub-partition's tensor core), ``tanh.approx.f32``,
``__syncthreads`` of 256 threads, and
a round trip of hand-offs between two CTAs of a cluster, each
completing on the receiver's mbarrier (``HANDOFFS``: 8 KB as 8- or
16-byte ``st.async``, 4 KB, 256 B, and 8 KB staged locally and sent by
one ``cp.async.bulk``), the pieces of the chain's floor.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
T_STEPS = 4000
BATCHES = (1, 16, 256)
# The micro kernel's hand-off forms, in its `mode` order.
HANDOFFS = ("8KB_v2", "8KB_v4", "4KB_v4", "256B_v2", "8KB_bulk")

ACTIVATION = ("  return tanh_approx(a) * fmaf(0.5f, tanh_approx(0.5f * b), "
              "0.5f);")
RECEIVE = ("    if (tid == 0) bar_expect_tx(full[half], rows * R * 4);\n"
           "    bar_wait(full[half], recv & 1);\n")
RELEASE = "    if (tid == 0) remote_arrive(prev_empty);\n"
PUT = ("      st_async4(next_inbox + half * HALF_INBOX + (row * FS + col) "
       "* 4,\n"
       "                odd ? s0 : v[0], odd ? s1 : v[1], odd ? v[2] : s0,\n"
       "                odd ? v[3] : s1, next_full[half]);")
WAIT_SLOT = "    bar_wait(empty_bar, (sent & 1) ^ 1);\n"
PRECOMPUTE = ("      // Off the chain: past.K0 + cond.Wc of every layer, in "
              "that k order.\n")
RECV_BLOCK = "      float xr[4], sk[4] = {0.f, 0.f, 0.f, 0.f};\n"
RECV_END = "      if (first) rg.release();\n\n"
PA0 = "        if (l < nl) {\n"
CHAIN = "        if (l >= nl) break;\n"
OUT_START = ("      // post1: tile `warp`, ReLU, split into bf16 hi + lo for "
             "post2.\n")
OUT_END = "      __syncthreads();\n      if (t + 1 < a.T) send_x(gi);\n"
P1_EPILOGUE = ("#pragma unroll\n      for (int h = 0; h < 2; ++h) {\n"
               "        const float v0 = fmaxf(ph[2 * h] + p1b[c0], 0.f);\n")
DRAW = ("      __syncthreads();\n#pragma unroll\n      for (int h = 0; h < 2; "
        "++h) {\n        const int r = 2 * warp + h;\n")
FIRST_SEND = "  for (int gi = 0; gi < rg.ng; ++gi) send_x(gi);\n"
GET_ROWS = "      if (g + 8 * h < rows)\n"
RING_STORE = ("      // block barrier holds the barrier until it lands).\n"
              "      if (tid < ROWS * R / 8) {\n")
X_BARRIER = ("        *reinterpret_cast<__nv_bfloat162*>(xl_s + (g + 8) * XS "
             "+ c0) = xb1;\n        __syncthreads();\n")
GATE_LOOP = """        float zv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e & 1);
          zv[e] = gate(pa0[l][e] + (pa1[0][e] + pa1[1][e]) + b1[col],
                       pb0[l][e] + (pb1[0][e] + pb1[1][e]) + b1[CA + col]);
        }
"""
GATE_F16X2 = """        float zv[4];
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          float ta[2], tb[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            ta[k] = pa0[l][e + k] + (pa1[0][e + k] + pa1[1][e + k]) + b1[c0 + k];
            tb[k] = 0.5f * (pb0[l][e + k] + (pb1[0][e + k] + pb1[1][e + k]) +
                            b1[CA + c0 + k]);
          }
          __half2 h = __floats2half2_rn(ta[0], ta[1]);
          __half2 s = __floats2half2_rn(tb[0], tb[1]);
          uint32_t hu = *reinterpret_cast<uint32_t*>(&h);
          uint32_t su = *reinterpret_cast<uint32_t*>(&s);
          asm("tanh.approx.f16x2 %0, %0;" : "+r"(hu));
          asm("tanh.approx.f16x2 %0, %0;" : "+r"(su));
          const float2 th = __half22float2(*reinterpret_cast<__half2*>(&hu));
          const float2 ts = __half22float2(*reinterpret_cast<__half2*>(&su));
          zv[e] = th.x * fmaf(0.5f, ts.x, 0.5f);
          zv[e + 1] = th.y * fmaf(0.5f, ts.y, 0.5f);
        }
"""

POST2_FMA = r"""      float* h2 = reinterpret_cast<float*>(hi_s);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        h2[r * S + c0] = fmaxf(ph[2 * h] + p1b[c0], 0.f);
        h2[r * S + c0 + 1] = fmaxf(ph[2 * h + 1] + p1b[c0 + 1], 0.f);
      }
      __syncthreads();
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < S; kk += 4) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h2 + r * S + kk);
          acc[r] = fmaf(hv.x, p2w[kk], acc[r]);
          acc[r] = fmaf(hv.y, p2w[kk + 1], acc[r]);
          acc[r] = fmaf(hv.z, p2w[kk + 2], acc[r]);
          acc[r] = fmaf(hv.w, p2w[kk + 3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float lg = acc[r] + p2b[tid];
        logits_s[r * LS + tid] = lg;
        if (a.want_logits)
          a.logits[(static_cast<size_t>(t) * Bp + row0 + r) * CLASSES + tid] =
              lg;
      }
"""
P2_REGISTERS = ("  float p2w[S];\n#pragma unroll\n"
                "  for (int k = 0; k < S; ++k)\n"
                "    p2w[k] = reinterpret_cast<const float*>(p2hi)[k * CLASSES"
                " + tid];\n")

MICRO = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
constexpr int N = 1024;
__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// out[0..3]: cycles of one dependent mma.sync, tanh.approx, __syncthreads
// (256 threads), and one hand-off round trip between two CTAs in `mode`:
// 0: 8 KB as 4 st.async.v2 a thread; 1: 8 KB as 2 st.async.v4 a thread;
// 2: 4 KB as 1 st.async.v4 a thread; 3: 256 B from one warp (v2);
// 4: 8 KB stored locally, then one cp.async.bulk into the other CTA.
__global__ void __launch_bounds__(256, 1) micro(long long* out, float seed,
                                                int mode) {
  __shared__ __align__(128) float box[2 * 16 * 72];
  __shared__ __align__(128) float stage[2048];
  __shared__ __align__(8) uint64_t bars[2];
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int tid = threadIdx.x;
  float d[4] = {seed, seed, seed, seed};
  uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  uint32_t b0 = 0x3c003c00u, b1 = 0x3c003c00u;
  long long t0 = clock64();
  for (int i = 0; i < N; ++i)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  long long t1 = clock64();
  float x = d[0] * 1e-30f + seed;
  for (int i = 0; i < N; ++i) asm volatile("tanh.approx.f32 %0, %0;" : "+f"(x));
  long long t2 = clock64();
  for (int i = 0; i < N; ++i) __syncthreads();
  long long t3 = clock64();
  // Throughput: four independent chains a warp, all 8 warps.
  float e[4][4] = {};
  __syncthreads();
  long long t6 = clock64();
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(e[c][0]), "+f"(e[c][1]), "+f"(e[c][2]), "+f"(e[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                     "r"(b1));
  __syncthreads();
  long long t7 = clock64();
  x += e[0][0] + e[1][1] + e[2][2] + e[3][3];
  const uint32_t full = sa(&bars[0]);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  const unsigned other = rank ^ 1;
  uint32_t r_box, r_full;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r_box) : "r"(sa(box)), "r"(other));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r_full) : "r"(full), "r"(other));
  const unsigned bytes = mode == 2 ? 4096u : mode == 3 ? 256u : 8192u;
  long long t4 = clock64();
  // CTA 0 sends, CTA 1 receives and sends back: N round trips.
  for (int i = 0; i < N; ++i) {
    for (int turn = 0; turn < 2; ++turn) {
      if (static_cast<int>(rank) == turn) {
        const uint32_t u = __float_as_uint(x);
        if (mode == 0) {
          for (int k = 0; k < 4; ++k)
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                         ".v2.u32 [%0], {%1, %2}, [%3];" ::"r"(r_box + (tid * 4 + k) * 8),
                         "r"(u), "r"(0u), "r"(r_full) : "memory");
        } else if (mode == 1 || mode == 2) {
          for (int k = 0; k < (mode == 1 ? 2 : 1); ++k)
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                         ".v4.u32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(r_box + (tid * 2 + k) * 16),
                         "r"(u), "r"(0u), "r"(u), "r"(0u), "r"(r_full) : "memory");
        } else if (mode == 3) {
          if (tid < 32)
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                         ".v2.u32 [%0], {%1, %2}, [%3];" ::"r"(r_box + tid * 8),
                         "r"(u), "r"(0u), "r"(r_full) : "memory");
        } else {
          reinterpret_cast<float2*>(stage)[tid * 4] = make_float2(x, 0.f);
          reinterpret_cast<float2*>(stage)[tid * 4 + 1] = make_float2(x, 0.f);
          reinterpret_cast<float2*>(stage)[tid * 4 + 2] = make_float2(x, 0.f);
          reinterpret_cast<float2*>(stage)[tid * 4 + 3] = make_float2(x, 0.f);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncthreads();
          if (tid == 0)
            asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
                         "complete_tx::bytes [%0], [%1], 8192, [%2];" ::"r"(r_box),
                         "r"(sa(stage)), "r"(r_full) : "memory");
        }
      } else {
        if (tid == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                       ::"r"(full), "r"(bytes) : "memory");
        uint32_t done = 0;
        while (!done)
          asm volatile("{\n\t.reg .pred p;\n\t"
                       "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
                       "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(done) : "r"(full), "r"(i & 1) : "memory");
        x += box[tid];
        if (mode == 4) __syncthreads();
      }
    }
  }
  long long t5 = clock64();
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (tid == 0 && rank == 0) {
    out[0] = (t1 - t0) / N;
    out[1] = (t2 - t1) / N;
    out[2] = (t3 - t2) / N;
    out[3] = (t5 - t4) / N;
    out[4] = static_cast<long long>(d[1] + x) & 1;
    // Cycles per mma.sync per SM sub-partition (2 warps each).
    out[5] = (t7 - t6) / (2 * 4 * N);
  }
}
extern "C" int micro_run(void* out, int mode, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, micro,
                                             static_cast<long long*>(out), 1.0f, mode));
}
"""


def _need(src, *anchors):
    for anchor in anchors:
        if anchor not in src:
            raise SystemExit("probe anchor not found in the kernel source:\n"
                             + anchor)


def variants(src):
    _need(src, ACTIVATION, RECEIVE, RELEASE, PUT, WAIT_SLOT, PRECOMPUTE,
          RECV_BLOCK, RECV_END, PA0, CHAIN, OUT_START, OUT_END, P1_EPILOGUE,
          DRAW, FIRST_SEND, RING_STORE, X_BARRIER, GATE_LOOP, GET_ROWS)
    # (Reading zeros where nothing arrives keeps garbage off the slow
    # paths of the draw's division.)
    no_handoff = (src.replace(RECEIVE, "").replace(RELEASE, "")
                  .replace(PUT, "      (void)col;").replace(WAIT_SLOT, "")
                  .replace(GET_ROWS, "      if (rows < 0)\n"))
    out_a, out_rest = src.split(OUT_START)
    _, out_b = out_rest.split(OUT_END)
    no_output = out_a + OUT_END + out_b
    handoffs_only = (
        no_output.replace(PA0, "        if (l < nl && a.T < 0) {\n")
        .replace(CHAIN, "        if (l >= nl || a.T > 0) break;\n"))
    pre_a, pre_rest = src.split(PRECOMPUTE)
    pa0_block, recv_rest = pre_rest.split(RECV_BLOCK)
    recv_block, after = recv_rest.split(RECV_END)
    no_precompute = (pre_a + RECV_BLOCK + recv_block + RECV_END + PRECOMPUTE
                     + pa0_block + after)
    fma_a, fma_rest = src.split(P1_EPILOGUE)
    _, fma_b = fma_rest.split(DRAW)
    post2_fma = (fma_a + POST2_FMA + DRAW + fma_b).replace(
        FIRST_SEND, P2_REGISTERS + FIRST_SEND)
    return {
        "kernel": src,
        "no_handoff": no_handoff,
        "handoffs_only": handoffs_only,
        "exact_activation": src.replace(
            ACTIVATION, "  return tanhf(a) * (1.f / (1.f + expf(-b)));"),
        "no_precompute": no_precompute,
        "no_output": no_output,
        "post2_fma": post2_fma,
        "no_ring_store": src.replace(
            RING_STORE, RING_STORE.replace("tid < ", "a.T < 0 && tid < ")),
        "cheap_activation": src.replace(ACTIVATION, "  return a * b;"),
        "activation_f16x2": src.replace(GATE_LOOP, GATE_F16X2).replace(
            "#include <cuda_bf16.h>\n", "#include <cuda_bf16.h>\n"
            "#include <cuda_fp16.h>\n"),
        "no_x_barrier": src.replace(
            X_BARRIER, X_BARRIER.replace("        __syncthreads();\n", "")),
    }


def compile_all(workdir, nvcc, flags, sources):
    """{name: shared library path}, one nvcc per source, in parallel."""
    csrc = os.path.join(REPO, "idiaptts_torch", "csrc")
    procs = {}
    for name, (text, include) in sources.items():
        path = os.path.join(workdir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", include, "-shared", "-o",
             path[:-3] + ".so", path, os.path.join(csrc, "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for {}:\n{}".format(name, out))
        libs[name] = os.path.join(workdir, name + ".so")
    return libs


def smi(*fields):
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(fields),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Sampled:
    """SM clock (MHz) and power draw (W) from ``nvidia-smi`` every 50 ms
    while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        rows = [[float(v) for v in line.split(",")]
                for line in out.splitlines() if line.count(",") == 1]
        self.clock = ([min(r[0] for r in rows), max(r[0] for r in rows)]
                      if rows else None)
        self.power = max(r[1] for r in rows) if rows else None


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="checkout of an earlier kernel")
    parser.add_argument("--batches", type=int, nargs="+", default=BATCHES)
    parser.add_argument("--steps", type=int, default=T_STEPS)
    parser.add_argument("--variants", nargs="+",
                        help="time only these variants (default: all)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_wavenet_sampler: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    from idiaptts_torch.ops import cuda_wavenet as cw
    from idiaptts_torch.ops import dispatch
    dev = torch.device("cuda", 0)
    card = smi("name", "power.limit")
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",), num_layers=20,
                                num_stacks=2, cond_channels=23)
    w = cfg.create_model(torch.Generator().manual_seed(0)).to(dev) \
        .sampler().weights
    layers, post, dil, offs, Cp, plan = w.kernel_args()
    b = cw._bytes
    post_fma = torch.cat([b(cw._fragments(w.p1)), b(w.p2), b(w.p1b),
                          b(w.p2b)])
    post_parent = torch.cat([b(cw._fragments(w.p1)), b(w.p1b), b(w.p2),
                             b(w.p2b)])
    csrc = os.path.join(REPO, "idiaptts_torch", "csrc")
    with open(os.path.join(csrc, "wavenet_sampler.cu")) as f:
        src = f.read()
    sources = {k: (v, csrc) for k, v in variants(src).items()
               if not args.variants or k in args.variants}
    if args.parent:
        pcsrc = os.path.join(args.parent, "idiaptts_torch", "csrc")
        with open(os.path.join(pcsrc, "wavenet_sampler.cu")) as f:
            sources["parent"] = (f.read(), pcsrc)
    sources["micro"] = (MICRO, csrc)
    part = (ctypes.c_int * plan.NC)(*plan.part)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = args.steps
    result = {"card": card, "T": steps, "L": len(w.dilations), "C": w.C,
              "us_per_step": {}, "clock_mhz": {}, "max_power_w": {},
              "plan": {}}
    with tempfile.TemporaryDirectory() as workdir:
        libs = compile_all(workdir, dispatch.nvcc_path(), dispatch.NVCC_FLAGS,
                           sources)
        stream = torch.cuda.current_stream(dev).cuda_stream

        micro = ctypes.CDLL(libs.pop("micro")).micro_run
        micro.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        cyc = {}
        for mode, name in enumerate(HANDOFFS):
            out = torch.zeros(6, dtype=torch.int64, device=dev)
            for _ in range(2):
                err = micro(out.data_ptr(), mode, stream)
                if err:
                    raise SystemExit("micro: cuda error {}".format(err))
            torch.cuda.synchronize()
            vals = out.tolist()
            cyc.update(mma_sync=vals[0], tanh_approx=vals[1],
                       syncthreads_256=vals[2],
                       mma_sync_issue_per_subpartition=vals[5])
            cyc["round_trip_" + name] = vals[3]
        mhz = float(smi("clocks.sm"))
        result["micro_cycles"] = cyc
        result["micro_ns"] = {k: v * 1e3 / mhz for k, v in
                              result["micro_cycles"].items()}
        result["micro_clock_mhz"] = mhz
        print("micro (cycles):", json.dumps(result["micro_cycles"]), "at",
              mhz, "MHz", flush=True)

        fns = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(path).idt_wavenet_sampler
            if name == "parent":
                fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                               + [ctypes.c_float, ctypes.c_void_p])
            else:
                fn.argtypes = ([ctypes.c_void_p] * 11
                               + [ctypes.POINTER(ctypes.c_int)]
                               + [ctypes.c_int] * 10
                               + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = fn
        for B in args.batches:
            lp = cw.launch_plan(w, B)
            result["plan"][B] = lp
            cond = torch.zeros(steps, B, Cp, dtype=torch.bfloat16,
                               device=dev)
            cond[:, :, :w.C] = 0.3 * torch.randn(steps, B, w.C,
                                                 generator=gen, device=dev)
            u = torch.rand(steps, B, generator=gen, device=dev)
            Bp = -(-B // 16) * 16
            cond_p = torch.zeros(steps, Bp, Cp, dtype=torch.bfloat16,
                                 device=dev)
            cond_p[:, :B] = cond
            u_p = torch.zeros(steps, Bp, device=dev)
            u_p[:, :B] = u
            samples = torch.empty(steps, Bp, dtype=torch.int32, device=dev)
            ring = torch.zeros(w.slots, Bp, w.R, dtype=torch.bfloat16,
                               device=dev)
            for key in ("us_per_step", "clock_mhz", "max_power_w"):
                result[key][B] = {}
            for name, fn in fns.items():
                def run():
                    if name == "parent":
                        err = fn(cond_p.data_ptr(), u_p.data_ptr(), None,
                                 w.embed.data_ptr(), layers.data_ptr(),
                                 post_parent.data_ptr(), dil.data_ptr(),
                                 offs.data_ptr(), ring.data_ptr(),
                                 samples.data_ptr(), None, steps, Bp, Cp,
                                 len(w.dilations), w.out_channels, 0, 0, 1.0,
                                 stream)
                    else:
                        blob = post_fma if name == "post2_fma" else post
                        err = fn(cond_p.data_ptr(), u_p.data_ptr(), None,
                                 w.embed.data_ptr(), layers.data_ptr(),
                                 blob.data_ptr(), dil.data_ptr(),
                                 offs.data_ptr(), ring.data_ptr(),
                                 samples.data_ptr(), None, part, steps, B,
                                 Bp, Cp, len(w.dilations), plan.NC, lp["G"],
                                 w.out_channels, 0, 0, 1.0, stream)
                    if err:
                        raise RuntimeError("{}: cuda error {}".format(
                            name, err))
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with Sampled() as smp:
                    start.record()
                    run()
                    run()
                    end.record()
                    torch.cuda.synchronize()
                us = start.elapsed_time(end) / 2 * 1e3 / steps
                result["us_per_step"][B][name] = us
                result["clock_mhz"][B][name] = smp.clock
                result["max_power_w"][B][name] = smp.power
                print("B={:<4d} {:<18s} {:8.3f} us/step ({:.1f} ms a run)  SM {}"
                      " MHz, <= {} W [{}]".format(B, name, us,
                                                   us * steps / 1e3,
                                                   smp.clock, smp.power,
                                                   card), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
