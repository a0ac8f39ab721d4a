#!/usr/bin/env python3
"""Where a step of the BiLSTM recurrence kernel goes, on one NVIDIA GPU.

    python3 probe_bilstm_recurrence.py      # from the repository root

Builds variants of ``idiaptts_torch/csrc/bilstm_recurrence.cu`` by text
substitution of the source (one nvcc per variant, all started together):
a part of the step is switched off by guarding its call with ``if (T <
0)``, which the compiler cannot drop.  Every variant runs the kernel's
prologue (the Wh slice into shared memory) and T steps of:

- ``barrier_grid``: the old grid-wide barrier alone (``grid_barrier``:
  all blocks of both directions, ``__nanosleep(20)`` between polls);
- ``barrier``: the per-direction barrier alone (release arrival, acquire
  poll);
- ``barrier_load``: the barrier and the h_{t-1} copies into the A tiles;
- ``barrier_load_product``: also the wgmma (four a 64-deep k-block);
- ``kernel``: the kernel as it is (also the xp loads and prefetches, the
  cell update and the stores);
- ``kernel_grid_barrier``: the kernel with the old grid barrier;
- ``no_load_h``, ``no_product``, ``no_xp``: the kernel without the
  h_{t-1} copies, without the wgmma (the update runs on whatever the
  accumulators hold), without the xp loads and prefetches;
- ``no_prefetch``: the kernel without its L2 prefetch of xp_{t+2};
- ``xp_ldcs``: the kernel loading xp with streaming loads (``__ldcs``)
  instead of through the read-only path (``__ldg``);
- ``two_acc``: the kernel accumulating alternate k steps into two sets
  of accumulators, summed after the wait (two chains of dependent
  wgmma in place of one);
- ``no_outputs``: the kernel without the stores of out (hnext's stay);
- ``libm_act``: the kernel with libm's sigmoid and tanh (``expf``,
  IEEE division, ``tanhf``) in place of its ``__expf``/``__fdividef``
  ones;
- ``poll_relaxed``: the kernel polling with relaxed loads and one
  acquire fence after the wait;
- ``red_release``: the kernel arriving with ``red.release.gpu`` and no
  separate fence.

The variants that compute and write the recurrence (``CHECKED``) are
held against the plain recurrence with chip_smoke.py's tolerance; the
others compute garbage or write nothing, and serve only for timing.
Each variant is timed through the inference entry point at the serving
(T = 512, B = 6 and 48) and training (T = 1024, B = 8 and 32) shapes
with CUDA events, in the order variants, variants reversed; ``kernel``
also through the training entry point (float32 residuals) at the
training shapes.  Then the SM clock and power draw (``nvidia-smi``,
every 100 ms) during two seconds of back-to-back kernel calls at T =
512, B = 6 and 48.  Prints one JSON line: per variant and shape the ms
of each pass and the µs a step (the best pass over T).
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((512, 6), (512, 48), (1024, 8), (1024, 32))   # (T, B)
F = 512
CHECK_SHAPES = ((64, 48, 512), (12, 130, 64), (1, 6, 512))   # (T, B, F)
REC_TOL = 5e-3                   # chip_smoke.py's recurrence tolerance

LOAD_XP0 = "  load_xp(0, false);\n"
PREFETCH0 = "  if (T > 1) load_xp(1, true);\n"
PREFETCH = "    if (t + 2 < T) load_xp(t + 2, true);\n"
LOAD_H = "    if (t > 0) load_h("
PRODUCT = "    product();\n"
UPDATE = "    update(hbuf"
STORE = "    store_outputs(t);\n"
LOAD_XP = "    load_xp(t + 1, false);\n"
ARRIVE = "    if (!last) idt::group_arrive(counter);\n"
WAIT = ("    idt::group_wait(counter, static_cast<unsigned int>(t + 1) * "
        "groups);\n")
GRID = ("    idt::grid_barrier(bar, static_cast<unsigned int>(t + 1) * "
        "gridDim.x);\n")
HELPERS_AT = "using idt::smem_desc;\n"
HELPERS = """
__device__ __forceinline__ float libm_sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void wait_relaxed(const unsigned int* counter,
                                             unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void arrive_release(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(counter) : "memory");
}
"""
CHECKED = ("kernel", "kernel_grid_barrier", "libm_act", "poll_relaxed",
           "red_release", "no_prefetch", "xp_ldcs", "two_acc")
TWO_ACC_DECL = (
    "      idt::fence_acc(acc[m]);\n    }\n",
    "      idt::fence_acc(acc[m]);\n    }\n    float acc2[MT][16];\n"
    "#pragma unroll\n    for (int m = 0; m < MT; ++m) {\n"
    "#pragma unroll\n      for (int i = 0; i < 16; ++i) acc2[m][i] = 0.f;\n"
    "      idt::fence_acc(acc2[m]);\n    }\n")
TWO_ACC_MMA = ("          wgmma_m64n32k16(acc[m],",
               "          wgmma_m64n32k16((kk & 1) ? acc2[m] : acc[m],")
TWO_ACC_SUM = (
    "    for (int m = 0; m < MT; ++m) idt::fence_acc(acc[m]);\n",
    "    for (int m = 0; m < MT; ++m) {\n      idt::fence_acc(acc[m]);\n"
    "      idt::fence_acc(acc2[m]);\n#pragma unroll\n"
    "      for (int i = 0; i < 16; ++i) acc[m][i] += acc2[m][i];\n    }\n")
ENTRIES = {
    "idt_bilstm_recurrence": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
    "idt_bilstm_recurrence_train": ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 5),
}


def variants(src):
    from probe_bilstm_proj import _sub

    def sub(text, old, new):
        return _sub(text, old, new, source="bilstm_recurrence.cu")

    def off(text, *anchors):
        for a in anchors:
            text = sub(text, a, a[:len(a) - len(a.lstrip())] + "if (T < 0) "
                       + a.lstrip())
        return text

    def grid(text):
        return sub(sub(text, ARRIVE, ""), WAIT, GRID)

    barrier_load_product = off(src, LOAD_XP0, PREFETCH0, UPDATE, STORE,
                               LOAD_XP, PREFETCH)
    barrier_load = off(barrier_load_product, PRODUCT)
    barrier = off(barrier_load, LOAD_H)
    helped = sub(src, HELPERS_AT, HELPERS_AT + HELPERS)
    libm = helped
    for old, new in (("sigmoid_fast(g", "libm_sigmoid(g"),
                     ("tanh_fast(g", "tanhf(g"),
                     ("tanh_fast(cell", "tanhf(cell")):
        libm = _sub(libm, old, new, count=libm.count(old) or 1,
                    source="bilstm_recurrence.cu")
    return {
        "barrier_grid": grid(barrier),
        "barrier": barrier,
        "barrier_load": barrier_load,
        "barrier_load_product": barrier_load_product,
        "kernel": src,
        "kernel_grid_barrier": grid(src),
        "no_load_h": off(src, LOAD_H),
        "no_product": off(src, PRODUCT),
        "no_xp": off(src, LOAD_XP0, PREFETCH0, LOAD_XP, PREFETCH),
        "no_prefetch": off(src, PREFETCH0, PREFETCH),
        "xp_ldcs": sub(src, "__ldg(reinterpret_cast<const float2*>",
                       "__ldcs(reinterpret_cast<const float2*>"),
        "two_acc": sub(sub(sub(src, TWO_ACC_DECL[0], TWO_ACC_DECL[1]),
                           TWO_ACC_MMA[0], TWO_ACC_MMA[1]),
                       TWO_ACC_SUM[0], TWO_ACC_SUM[1]),
        "no_outputs": off(src, STORE),
        "libm_act": libm,
        "poll_relaxed": sub(helped, WAIT, WAIT.replace(
            "idt::group_wait", "wait_relaxed")),
        "red_release": sub(helped, ARRIVE, ARRIVE.replace(
            "idt::group_arrive", "arrive_release")),
    }


def launchers(torch, lib):
    def scratch(xp):
        T, R, G = xp.shape
        hbuf = torch.empty(2, R, G // 4, dtype=torch.bfloat16, device="cuda")
        return hbuf, torch.empty(64, dtype=torch.int32, device="cuda")

    def check(err):
        if err:
            raise RuntimeError("launch failed: cuda error {}".format(err))

    def infer(xp, wh, out):
        T, R, G = xp.shape
        hbuf, bar = scratch(xp)
        check(lib.idt_bilstm_recurrence(
            xp.data_ptr(), wh.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
            bar.data_ptr(), T, R // 2, G // 4, 2,
            torch.cuda.current_stream().cuda_stream))

    def train(xp, wh, out, a, c):
        T, R, G = xp.shape
        hbuf, bar = scratch(xp)
        check(lib.idt_bilstm_recurrence_train(
            xp.data_ptr(), wh.data_ptr(), out.data_ptr(), a.data_ptr(),
            c.data_ptr(), hbuf.data_ptr(), bar.data_ptr(), T, R // 2,
            G // 4, 2, 0, torch.cuda.current_stream().cuda_stream))

    return infer, train


def inputs(torch, T, B, F_, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F_, generator=g, device="cuda")
    wh = (torch.randn(2 * F_, 4 * F_, generator=g, device="cuda")
          / F_ ** 0.5).to(torch.bfloat16)
    return xp, wh


def agrees(torch, infer, T, B, F_):
    from idiaptts_torch.ops import cuda_lstm
    xp, wh = inputs(torch, T, B, F_, 1)
    out = torch.full((T, 2 * B, F_), float("nan"), device="cuda")
    infer(xp, wh, out)
    torch.cuda.synchronize()
    err = (out - cuda_lstm.recurrence_tmajor_plain(xp, wh)).abs().max()
    return err.item() <= REC_TOL


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_bilstm_recurrence: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from probe_bilstm_proj import build, clocks_during, cuda_ms
    from idiaptts_torch.ops import dispatch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(dispatch.CSRC_DIR, "bilstm_recurrence.cu")) as f:
        srcs = variants(f.read())
    os.makedirs(dispatch.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_DIR) as tmp:
        libs, ptxas = build(srcs, tmp, ENTRIES)
        calls = {k: launchers(torch, lib) for k, lib in libs.items()}
        checked = {k: all(agrees(torch, calls[k][0], *s)
                          for s in CHECK_SHAPES)
                   for k in calls if k in CHECKED}
        print("checks against the plain version:", checked, flush=True)
        times = {}
        for T, B in SHAPES:
            xp, wh = inputs(torch, T, B, F, 0)
            out = torch.empty(T, 2 * B, F, device="cuda")
            row = {}
            order = list(calls) + list(calls)[::-1]
            if T == 1024:
                a = torch.empty(T, 2 * B, 4 * F, device="cuda")
                c = torch.empty(T, 2 * B, F, device="cuda")
                order += ["kernel_train", "kernel_train"]
            for k in order:
                if k == "kernel_train":
                    fn = (lambda: calls["kernel"][1](xp, wh, out, a, c))
                else:
                    fn = (lambda k=k: calls[k][0](xp, wh, out))
                row.setdefault(k, []).append(cuda_ms(torch, fn, reps=10))
            times["T={},B={}".format(T, B)] = {
                k: {"ms": v, "us_per_step": min(v) * 1e3 / T}
                for k, v in row.items()}
            print("T={} B={}: {}".format(T, B, "  ".join(
                "{} {:.3f} us/step".format(k, min(v) * 1e3 / T)
                for k, v in row.items())), flush=True)
        clocks = {}
        for B in (6, 48):
            xp, wh = inputs(torch, 512, B, F, 0)
            out = torch.empty(512, 2 * B, F, device="cuda")
            clocks["T=512,B={}".format(B)] = clocks_during(
                torch, lambda: calls["kernel"][0](xp, wh, out))
    print(json.dumps({"card": card, "ptxas": ptxas, "checked": checked,
                      "times": times, "clocks": clocks}))
    return 0 if all(checked.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
