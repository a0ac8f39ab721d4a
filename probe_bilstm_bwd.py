#!/usr/bin/env python3
"""Where a step of the BiLSTM backward kernel (K5) goes, on one NVIDIA GPU.

    python3 probe_bilstm_bwd.py      # from the repository root

Builds variants of ``idiaptts_torch/csrc/bilstm_bwd.cu`` by text
substitution of the source (one nvcc per variant, all started together):
a part of the step is switched off by guarding its call with ``if (T <
0)``, which the compiler cannot drop.  Every variant runs the kernel's
prologue (the Wh rows into shared memory) and T steps of:

- ``barrier_grid``: the old grid-wide barrier alone (``grid_barrier``:
  all blocks of both directions, ``__nanosleep(20)`` between polls);
- ``barrier``: the per-direction barrier alone (release arrival, acquire
  poll);
- ``barrier_copies``: the barrier and the dz_{t+1} copies into the ring
  (the product loop runs without its ldmatrix and ``mma.sync``);
- ``barrier_copies_product``: also the product;
- ``kernel``: the kernel as it is (also the residual loads and
  prefetches, the gate math and both dz stores);
- ``kernel_grid_barrier``: the kernel with the old grid barrier;
- ``no_copies``, ``no_product``, ``no_mma``, ``no_residuals``,
  ``no_dz_stores``, ``no_exchange_stores``: the kernel without the
  dz_{t+1} copies (the product multiplies whatever the ring holds),
  without the product, without its ``mma.sync`` (the ldmatrix stay),
  with every step's residual loads from step T-1 (cached) and no
  prefetches, without the float32 dz stores, without the bf16 stores of
  dz_t to the exchange buffer;
- ``units16``, ``units16_barrier_copies``: the first broadcast lever, 16
  hidden units a block (half the blocks, so half the L2 bytes of the dz
  broadcast, twice the product a block);
- ``cluster2``, ``cluster2_barrier_copies``, ``cluster1``,
  ``cluster1_barrier_copies``: the second lever, thread block clusters:
  thread 0 of each block copies its 1/C of a chunk's rows with one TMA
  bulk copy (``cp.async.bulk``, completing on the ring slot's mbarrier)
  multicast to the C blocks of its cluster (C = 2, or 1: one bulk copy a
  chunk and no multicast), the launch cooperative with a cluster
  dimension, refills of a slot after a cluster barrier;
- ``k_batch``: the product loading the fragments of 8 / 4 / 2 k-steps
  before multiplying them at 1 / 2 / 4 m-tiles (the kernel: 8 at one
  m-tile, one k-step at a time beyond);
- ``wait_once``: where the whole dz is in flight (four chunks), one
  wait for all of it and one block barrier before the product (the
  kernel: a wait and a barrier before each chunk's product);
- ``threads256``, ``threads256_barrier_copies``: eight warps a block
  (half the k-steps a warp, the copies issued by twice the threads).

The variants that compute and write dz (``CHECKED``) are held against the
plain backward with chip_smoke.py's tolerance; the others compute garbage
or write nothing, and serve only for timing.  Each variant is timed at
T = 1024, F = 512, B = 8, 32 and 64 (16, 64 and 128 rows), float32
residuals, with CUDA events in the order variants, variants reversed, and
``kernel``, ``units16`` and ``cluster2`` also at F = 64, B = 8.  Then the
SM clock and power draw (``nvidia-smi``, every 100 ms) during two seconds
of back-to-back kernel calls at B = 8 and 32.  Prints one JSON line: per
variant and shape the ms of each pass and the µs a step (the best pass
over T).
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
T_TIME = 1024
SHAPES = ((8, 512), (32, 512), (64, 512))     # (B, F)
NARROW = (8, 64)
CHECK_SHAPES = ((64, 32, 512), (12, 130, 64), (1, 6, 512), (10, 47, 512))
BWD_TOL = 1e-3                   # chip_smoke.py's, relative to max|dz|

UNITS = "constexpr int UNITS = 8;"
THREADS = "constexpr int THREADS = 128;"
U_DEF = "  constexpr int U = MT == 1 ? 8 : 1;\n"
K_BATCH = ("  constexpr int U = MT == 1 ? 8 : MT == 2 ? 4 : MT == 4 ? 2 : 1;\n"
           "  constexpr int KACC_ = U < 4 ? U : 4;\n")
KACC_DEF = "  constexpr int KACC = MT == 1 ? 4 : 1;\n"
PRODUCT = "    if (s > 0) product(dzbuf"
COPIES = ("        cp_async16(st + 16 * i, chunk + 8 * i);\n",)
MULTIPLY = "      multiply(ch);\n"
MMA = "                mma_bf16(acc[u % KACC][m][nt], af[u][m], b[u][nt]);\n"
GATES = "    gates(s > 0, t);\n"
EXCHANGE = "    if (!last) store_exchange("
ARRIVE = "    if (!last) idt::group_arrive(counter);\n"
STORE = "    store_dz(t);\n"
RES = ("  load_res_ahead(T - 1, false);\n",
       "  if (T > 1) load_res_ahead(T - 2, true);\n",
       "    load_res_ahead(t - 1, false);\n",
       "    if (t >= 2) load_res_ahead(t - 2, true);\n")
RES_STEP = "pre[i] = load_res(a, c, gout, t,"
WAIT = ("    idt::group_wait(counter, static_cast<unsigned int>(s + 1) * "
        "groups);\n")
CHUNK_WAIT = "      cp_async_wait<STAGES - 1>();\n      __syncthreads();\n"
WAIT_ONCE = ("      if (nc > STAGES || ch == 0) {\n"
             "        if (nc > STAGES)\n"
             "          cp_async_wait<STAGES - 1>();\n"
             "        else\n"
             "          cp_async_wait<0>();\n"
             "        __syncthreads();\n"
             "      }\n")
GRID = ("    idt::grid_barrier(bar, static_cast<unsigned int>(s + 1) * "
        "gridDim.x);\n")

# The cluster lever: (anchor, replacement) pairs applied in order.
CLUSTER_HELPERS = r'''
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const uint64_t t0 = idt::global_ns();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (idt::global_ns() - t0 > idt::SPIN_LIMIT_NS) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_multicast(
    uint32_t dst, const void* src, uint32_t bytes, uint32_t bar,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

'''
CLUSTER_LAUNCH = r'''
constexpr int CLUSTER = 2;

// The cooperative launch in clusters of `cluster` blocks, co-residency
// checked by whole clusters.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, int blocks, size_t smem,
                           void** args, unsigned int* bar,
                           cudaStream_t stream, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err == cudaSuccess && clusters * cluster < blocks)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bar, 0, 2 * BAR_STRIDE * sizeof(unsigned int),
                          stream);
  cfg.numAttrs = 2;
  if (err == cudaSuccess)
    err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                              args);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

'''
CLUSTER_SUBS = (
    ("__device__ __forceinline__ void cp_async16(uint32_t dst, "
     "const void* src) {",
     CLUSTER_HELPERS + "__device__ __forceinline__ void cp_async16("
     "uint32_t dst, const void* src) {"),
    ("  return static_cast<size_t>(UNITS) * (8 * F + 16) +",
     "  return 8 * STAGES + static_cast<size_t>(UNITS) * (8 * F + 16) +"),
    ("  uint8_t* const w_s = smem;\n",
     "  const uint32_t bars = idt::smem_u32(smem);\n"
     "  uint8_t* const w_s = smem + 8 * STAGES;\n"),
    ("  const uint32_t ring = idt::smem_u32(xs + Bp * UNITS * XS);\n",
     "  const uint32_t ring = idt::smem_u32(xs + Bp * UNITS * XS);\n"
     "  const int C = static_cast<int>(cluster_blocks());\n"
     "  const int rank = static_cast<int>(cluster_rank());\n"
     "  uint32_t phases = 0;\n"
     "  if (tid == 0) {\n"
     "    for (int k = 0; k < STAGES; ++k) mbar_init(bars + 8 * k, 1);\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: "
     "\"memory\");\n"
     "  }\n"
     "  if (C > 1) cluster_sync();\n"),
    ("    if (ch < nc) {\n"
     "      const uint32_t st = ring + (ch % STAGES) * stage_bytes;\n"
     "      const __nv_bfloat16* chunk = src + ch * chunk_elems;\n"
     "      for (int i = tid; i < stage_bytes / 16; i += THREADS)\n"
     "        cp_async16(st + 16 * i, chunk + 8 * i);\n"
     "    }\n"
     "    cp_async_commit();\n",
     "    if (ch < nc && tid == 0) {\n"
     "      const uint32_t st = ring + (ch % STAGES) * stage_bytes;\n"
     "      const __nv_bfloat16* chunk = src + ch * chunk_elems;\n"
     "      const uint32_t mb = bars + 8 * (ch % STAGES);\n"
     "      mbar_expect_tx(mb, stage_bytes);\n"
     "      const int rb = rank * Bp / C;\n"
     "      const int re = (rank + 1) * Bp / C;\n"
     "      if (re > rb) {\n"
     "        if (C > 1)\n"
     "          bulk_copy_multicast(st + rb * a_pitch, chunk + rb * xpitch,\n"
     "                              (re - rb) * a_pitch, mb,\n"
     "                              static_cast<uint16_t>((1u << C) - 1));\n"
     "        else\n"
     "          bulk_copy(st, chunk, stage_bytes, mb);\n"
     "      }\n"
     "    }\n"),
    ("    for (int ch = 0; ch < STAGES; ++ch) issue(src, ch);\n",
     "    if (tid == 0) asm volatile(\"fence.proxy.async;\" ::: \"memory\");\n"
     "    for (int ch = 0; ch < STAGES; ++ch) issue(src, ch);\n"),
    (CHUNK_WAIT,
     "      mbar_wait(bars + 8 * (ch % STAGES), (phases >> (ch % STAGES)) "
     "& 1u);\n      phases ^= 1u << (ch % STAGES);\n"),
    ("      if (ch + STAGES < nc) __syncthreads();   // every warp read slot "
     "ch\n",
     "      if (ch + STAGES < nc) {\n"
     "        if (C > 1) cluster_sync(); else __syncthreads();\n"
     "        if (tid == 0) asm volatile(\"fence.proxy.async;\" ::: "
     "\"memory\");\n"
     "      }\n"),
    (WAIT + "  }\n}\n", WAIT + "  }\n  if (C > 1) cluster_sync();\n}\n"),
    ("template <int MT, typename ResT>\nint launch_tiles(",
     CLUSTER_LAUNCH + "template <int MT, typename ResT>\nint launch_tiles("),
    ("  return static_cast<int>(idt::launch_persistent(\n"
     "      bilstm_bwd_kernel<MT, ResT>, ndir * (F / UNITS), THREADS,\n"
     "      smem_bytes(Bp, F, KC), args, bar_, stream,\n"
     "      ndir * BAR_STRIDE * sizeof(unsigned int)));\n",
     "  const int groups = F / UNITS;\n"
     "  for (int cluster = CLUSTER;; cluster /= 2) {\n"
     "    if (groups % cluster) continue;\n"
     "    const cudaError_t err = launch_cluster(\n"
     "        bilstm_bwd_kernel<MT, ResT>, ndir * groups,\n"
     "        smem_bytes(Bp, F, KC), args, bar_, stream, cluster);\n"
     "    if (err != cudaErrorCooperativeLaunchTooLarge || cluster == 1)\n"
     "      return static_cast<int>(err);\n"
     "  }\n"),
)
CHECKED = ("kernel", "kernel_grid_barrier", "units16", "cluster1",
           "cluster2", "k_batch", "wait_once", "threads256")
ENTRIES = {"idt_bilstm_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5}


def variants(src):
    from probe_bilstm_proj import _sub

    def sub(text, old, new):
        return _sub(text, old, new, source="bilstm_bwd.cu")

    def off(text, *anchors):
        for a in anchors:
            text = sub(text, a, a[:len(a) - len(a.lstrip())] + "if (T < 0) "
                       + a.lstrip())
        return text

    def grid(text):
        return sub(sub(text, ARRIVE, ""), WAIT, GRID)

    def clusters(text, n):
        for old, new in CLUSTER_SUBS:
            text = sub(text, old, new)
        return sub(text, "constexpr int CLUSTER = 2;",
                   "constexpr int CLUSTER = {};".format(n))

    barrier_copies_product = off(src, GATES, EXCHANGE, STORE, *RES)
    barrier_copies = off(barrier_copies_product, MULTIPLY)
    barrier = off(barrier_copies, PRODUCT)
    units16 = sub(src, UNITS, UNITS.replace("8", "16"))
    return {
        "barrier_grid": grid(barrier),
        "barrier": barrier,
        "barrier_copies": barrier_copies,
        "barrier_copies_product": barrier_copies_product,
        "kernel": src,
        "kernel_grid_barrier": grid(src),
        "no_copies": off(src, *COPIES),
        "no_product": off(src, MULTIPLY),
        "no_mma": off(src, MMA),
        "no_residuals": off(sub(src, RES_STEP, RES_STEP.replace(
            " t,", " T - 1,")), RES[1], RES[3]),
        "no_dz_stores": off(src, STORE),
        "no_exchange_stores": off(src, EXCHANGE),
        "units16": units16,
        "units16_barrier_copies": sub(barrier_copies, UNITS,
                                      UNITS.replace("8", "16")),
        "cluster2": clusters(src, 2),
        "cluster2_barrier_copies": clusters(barrier_copies, 2),
        "cluster1": clusters(src, 1),
        "cluster1_barrier_copies": clusters(barrier_copies, 1),
        "k_batch": sub(sub(src, U_DEF, K_BATCH), KACC_DEF,
                       "  constexpr int KACC = KACC_;\n"),
        "wait_once": sub(src, CHUNK_WAIT, WAIT_ONCE),
        "threads256": sub(src, THREADS, THREADS.replace("128", "256")),
        "threads256_barrier_copies": sub(barrier_copies, THREADS,
                                         THREADS.replace("128", "256")),
    }


def launcher(torch, lib):
    def call(a, c, gout, wh, dz):
        T, R, G = a.shape
        # The kernel's chunk-major exchange buffer, as cuda_lstm allocates.
        dzbuf = torch.empty(2, R, 3 * G // 2, dtype=torch.bfloat16,
                            device="cuda")
        bar = torch.empty(64, dtype=torch.int32, device="cuda")
        err = lib.idt_bilstm_bwd(
            a.data_ptr(), c.data_ptr(), gout.data_ptr(), wh.data_ptr(),
            dz.data_ptr(), dzbuf.data_ptr(), bar.data_ptr(), T, R // 2,
            G // 4, 2, int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("launch failed: cuda error {}".format(err))
    return call


def inputs(torch, T, B, F_, seed):
    """Residuals of the training recurrence, an upstream cotangent and Wh
    (bf16), as tests/unit/test_torch_cuda_kernels.py makes them."""
    from idiaptts_torch.ops import cuda_lstm
    g = torch.Generator(device="cuda").manual_seed(seed)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F_, generator=g, device="cuda")
    wh = (torch.randn(2 * F_, 4 * F_, generator=g, device="cuda")
          / F_ ** 0.5).to(torch.bfloat16)
    _, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh)
    gout = 0.1 * torch.randn(T, 2 * B, F_, generator=g, device="cuda")
    return a, c, gout, wh


def agrees(torch, call, T, B, F_):
    from idiaptts_torch.ops import cuda_lstm
    a, c, gout, wh = inputs(torch, T, B, F_, 1)
    dz = torch.full(a.shape, float("nan"), device="cuda")
    call(a, c, gout, wh, dz)
    torch.cuda.synchronize()
    ref = cuda_lstm.dz_bwd_tmajor_plain(a, c, gout, wh)
    err = (dz - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    return err <= BWD_TOL


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_bilstm_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from probe_bilstm_proj import build, clocks_during, cuda_ms
    from idiaptts_torch.ops import dispatch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(dispatch.CSRC_DIR, "bilstm_bwd.cu")) as f:
        srcs = variants(f.read())
    os.makedirs(dispatch.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_DIR) as tmp:
        libs, ptxas = build(srcs, tmp, ENTRIES)
        calls = {k: launcher(torch, lib) for k, lib in libs.items()}
        checked = {k: all(agrees(torch, calls[k], *s) for s in CHECK_SHAPES)
                   for k in calls if k in CHECKED}
        print("checks against the plain version:", checked, flush=True)
        times = {}
        for B, F in SHAPES + (NARROW,):
            args = inputs(torch, T_TIME, B, F, 0)
            dz = torch.empty(args[0].shape, device="cuda")
            names = (list(calls) if F == 512
                     else ["kernel", "units16", "cluster2", "threads256"])
            row = {}
            for k in names + names[::-1]:
                row.setdefault(k, []).append(cuda_ms(
                    torch, lambda k=k: calls[k](*args, dz), reps=5))
            times["B={},F={}".format(B, F)] = {
                k: {"ms": v, "us_per_step": min(v) * 1e3 / T_TIME}
                for k, v in row.items()}
            print("B={} F={}: {}".format(B, F, "  ".join(
                "{} {:.3f} us/step".format(k, min(v) * 1e3 / T_TIME)
                for k, v in row.items())), flush=True)
            del args, dz
        clocks = {}
        for B in (8, 32):
            args = inputs(torch, T_TIME, B, 512, 0)
            dz = torch.empty(args[0].shape, device="cuda")
            clocks["B={}".format(B)] = clocks_during(
                torch, lambda: calls["kernel"](*args, dz))
    print(json.dumps({"card": card, "ptxas": ptxas, "checked": checked,
                      "times": times, "clocks": clocks}))
    return 0 if all(checked.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
