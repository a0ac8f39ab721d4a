#!/usr/bin/env python3
"""Where the time of the two MLPG kernels goes, on one NVIDIA GPU.

    python3 probe_mlpg.py [--parent DIR] [--reps N] [--serve-pairs N]

Builds ``idiaptts_torch/csrc/banded_solve.cu`` (K2) and
``idiaptts_torch/csrc/mlpg_oneshot.cu`` (K1) as they are, variants of
them (text substitutions at fixed anchors; a variant with a part left
out computes garbage and serves only for timing) and, with ``--parent``,
the kernels of a checkout of an earlier commit (``DIR/idiaptts_torch/
csrc``, the one-thread-a-lane kernels with their (b, l0, l1, l2, y, x, T,
L) and (b, a0, a1, a2, scratch, x, T, L) entry points), one nvcc each,
all at once.  It times each with CUDA events (mean over ``--reps``
launches after a warm-up) at the shapes of ``chip_smoke.py`` phases 3
and 9 (and, from torch.profiler's kernel records over 50 launches, the
kernel's own device time, which a launch rate that the host holds back
cannot inflate), samples the SM clock and the power draw with
``nvidia-smi``, and prints one JSON line of milliseconds:

K2 at T = 512, B = 6 and 48 (L = B * 22), T = 2048, B = 48, and
T = 16640, B = 2 (five super-chunks), on the bucket's factor from the
fixture variances:
- ``kernel``: the served MLPG (fused mode: b assembled in the kernel
  from a (B, T, 67) model output through the pipeline's column map);
- ``lanewise``: the same kernel with b given and the factor tiled
  (thin mode): the assembly left out;
- ``no_carry``: phase (b), the walk of the carries across the chunks,
  left out (fused mode);
- ``no_colmap_load``: the column map's loads left out (the columns
  taken as 0..3D-1), so the window means' loads depend on nothing;
- ``no_tau_load``: tau's loads left out (tau = 1);
- ``one_block``: ``__launch_bounds__(THREADS)``, registers not capped
  (the kernel caps them so that two blocks of 256 threads fit an SM);
- ``parent``: the earlier kernel with b and the tiled factor given.

K1 at T = 512 with L = 20 and 1, T = 2048 with L = 60, and T = 1, 2, 3
with L = 20, on seeded window means and variances:
- ``kernel``: the system assembled in the kernel (fused mode);
- ``assembled``: the system given (thin mode: the helper warps copy it
  in): the assembly left out;
- ``global_store``: the rows kept in a global scratch, not in shared
  memory: the shared-memory store left out;
- ``no_overlap``: the chain starts only when every chunk has been
  assembled: the helpers' head start left out;
- ``exact_root``: 1/l0 as the correctly rounded reciprocal of the
  correctly rounded sqrt, in place of the approximate reciprocal square
  root and its Newton step;
- ``rsqrt``: the approximate reciprocal square root with no Newton step;
- ``no_backward``: the backward sweep left out;
- ``parent``: the earlier kernel on the system given.
Each variant's error against the plain version is logged.

``micro`` measures, with ``clock64`` on one SM, the latency of the
chains' steps: K2's (and K1's backward) substitution step (two FMAs and
a multiply, carried), K1's forward step (the factor row and y) as the
kernel takes it (approximate reciprocal square root and a Newton step),
with a correctly rounded sqrt and reciprocal, and with the approximation
alone, a barrier of 256 threads, and phase (b)'s carry step from shared
memory.  The chain floors in ``floor_ms``: K2 2 (2R + NC) steps a
super-chunk (NC = min(P, 256) chunks), K1 T forward and T backward
steps, at the measured latencies and clock.

``--serve-pairs N`` (with ``--parent``, a whole checkout) then times
label -> waveform serving of both trees, each run in a process of its
own through that tree's ``chip_smoke.build_slice`` and ``time_slice``
(xRT and stage ms at B = 6 and 48), in N alternating pairs: parent,
change, change, parent, ...; it prints every run and the medians.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SOLVE_SHAPES = ((512, 6), (512, 48), (2048, 48), (16640, 2))  # (T, B)
ONESHOT_SHAPES = ((512, 20), (512, 1), (2048, 60), (1, 20), (2, 20),
                  (3, 20))                           # (T, L)

CARRY_WALK = "  const bool walker = c == 0 && active;\n"
BOUNDS = "__global__ void __launch_bounds__(THREADS, 2)"
COLMAP = ("    c0 = a.colmap[d];\n    c1 = a.colmap[D + d];\n"
          "    c2 = a.colmap[2 * D + d];\n")
TAU = ("a.tau[(t * 3 + 1) * D + d]", "a.tau[(t * 3 + 2) * D + d]",
       "a.tau[t * 3 * D + d]")
FIRST_WAIT = "    bar_wait(&bars[0]);\n"
STEP_ROOT = "      const float r = rsqrt_newton(v);\n"
BACK_TAIL = ("    for (int t = T - 1; t >= full; --t) backward(store[t * LC + j], "
             "t);\n")
BACK_LOOP = "    for (int t0 = full - GROUP; t0 >= 0; t0 -= GROUP) {\n"

MICRO = r"""
#include <cuda_runtime.h>

constexpr int N = 1024;

__global__ void micro_kernel(double* out, float* sink, float seed) {
  __shared__ float sm[6][256];
  const int tid = threadIdx.x;
  for (int k = tid; k < 6 * 256; k += blockDim.x)
    (&sm[0][0])[k] = 0.001f * (k % 7) + seed * 1e-6f;
  __syncthreads();
  // K2 / K1 backward: y = (b - s1 y1 - s2 y2) * inv, carried.
  float y1 = seed, y2 = 0.5f * seed;
  const float b = seed + 1.f, s1 = 0.3f + 1e-3f * seed, s2 = 0.1f,
              inv = 0.9f;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    const float yn = fmaf(-s1, y1, fmaf(-s2, y2, b)) * inv;
    y2 = y1;
    y1 = yn;
  }
  long long t1 = clock64();
  // K1 forward: the factor row and y_t.
  float l1m1 = 0.1f * seed, l2m1 = 0.05f, l2m2 = 0.02f, ym1 = 0.f, ym2 = 0.f;
  const float a0 = 3.f, a1 = -0.5f, a2 = 0.2f;
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    const float c0 = fmaf(-l2m2, l2m2, a0);
    const float n1 = fmaf(-l1m1, l2m1, a1);
    const float v = fmaxf(fmaf(-l1m1, l1m1, c0), 1e-20f);
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    r = fmaf(0.5f * r, fmaf(-v * r, r, 1.f), r);
    const float l1 = n1 * r, l2 = a2 * r;
    const float y = fmaf(-l1m1, ym1, fmaf(-l2m2, ym2, b)) * r;
    l2m2 = l2m1; l1m1 = l1; l2m1 = l2; ym2 = ym1; ym1 = y;
  }
  long long t2 = clock64();
  float e1m1 = 0.1f * seed, e2m1 = 0.05f, e2m2 = 0.02f, em1 = 0.f, em2 = 0.f;
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    const float c0 = fmaf(-e2m2, e2m2, a0);
    const float n1 = fmaf(-e1m1, e2m1, a1);
    const float r = __frcp_rn(__fsqrt_rn(fmaxf(fmaf(-e1m1, e1m1, c0),
                                               1e-20f)));
    const float l1 = n1 * r, l2 = a2 * r;
    const float y = fmaf(-e1m1, em1, fmaf(-e2m2, em2, b)) * r;
    e2m2 = e2m1; e1m1 = l1; e2m1 = l2; em2 = em1; em1 = y;
  }
  long long t2b = clock64();
  float k1m1 = 0.1f * seed, k2m1 = 0.05f, k2m2 = 0.02f, zm1 = 0.f, zm2 = 0.f;
#pragma unroll 16
  for (int i = 0; i < N; ++i) {
    const float c0 = fmaf(-k2m2, k2m2, a0);
    const float n1 = fmaf(-k1m1, k2m1, a1);
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;"
        : "=f"(r)
        : "f"(fmaxf(fmaf(-k1m1, k1m1, c0), 1e-20f)));
    const float l1 = n1 * r, l2 = a2 * r;
    const float y = fmaf(-k1m1, zm1, fmaf(-k2m2, zm2, b)) * r;
    k2m2 = k2m1; k1m1 = l1; k2m1 = l2; zm2 = zm1; zm1 = y;
  }
  long long t3 = clock64();
#pragma unroll 1
  for (int i = 0; i < N; ++i) __syncthreads();
  long long t4 = clock64();
  // Phase (b): (p, q) = z_k + M_k (p, q) from shared memory.
  float p = 0.f, q = 0.f;
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    const int i = (k * 7 + tid) & 255;
    const float np = fmaf(sm[2][i], p, fmaf(sm[3][i], q, sm[0][i]));
    const float nq = fmaf(sm[4][i], p, fmaf(sm[5][i], q, sm[1][i]));
    p = np;
    q = nq;
  }
  long long t5 = clock64();
  sink[tid] = y1 + ym1 + em1 + zm1 + p + q;
  if (tid == 0) {
    out[0] = double(t1 - t0) / N;
    out[1] = double(t2 - t1) / N;
    out[2] = double(t2b - t2) / N;
    out[3] = double(t3 - t2b) / N;
    out[4] = double(t4 - t3) / N;
    out[5] = double(t5 - t4) / N;
  }
}

extern "C" int micro_run(double* out, float* sink, cudaStream_t stream) {
  micro_kernel<<<1, 256, 0, stream>>>(out, sink, 1.f);
  return static_cast<int>(cudaGetLastError());
}
"""
MICRO_KEYS = ("substitution_step", "factor_step", "factor_step_exact",
              "factor_step_rsqrt", "syncthreads_256", "carry_step")


def _need(src, *anchors):
    for anchor in anchors:
        if anchor not in src:
            raise SystemExit("probe anchor not found in the kernel source:\n"
                             + anchor)


def solve_variants(src):
    _need(src, CARRY_WALK, BOUNDS, COLMAP, *TAU)
    no_tau = src
    for load in TAU:
        no_tau = no_tau.replace(load, "1.f")
    return {"solve_kernel": src,
            "solve_no_colmap_load": src.replace(COLMAP, (
                "    c1 = D + d;\n    c2 = 2 * D + d;\n")),
            "solve_no_tau_load": no_tau,
            "solve_no_carry": src.replace(CARRY_WALK, CARRY_WALK.replace(
                "active", "active && a.T < 0")),
            "solve_one_block": src.replace(BOUNDS, BOUNDS.replace(
                ", 2", ""))}


def oneshot_variants(src):
    _need(src, FIRST_WAIT, STEP_ROOT, BACK_TAIL, BACK_LOOP)
    return {"oneshot_kernel": src,
            "oneshot_no_overlap": src.replace(FIRST_WAIT, (
                "    for (int k = 0; k < a.nchunks; ++k) "
                "bar_wait(&bars[k]);\n")),
            "oneshot_exact_root": src.replace(
                STEP_ROOT, "      const float r = __frcp_rn(__fsqrt_rn(v));\n"),
            "oneshot_rsqrt": src.replace(STEP_ROOT, (
                "      float r;\n"
                "      asm(\"rsqrt.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : "
                "\"f\"(v));\n")),
            "oneshot_no_backward": src.replace(
                BACK_TAIL, "    if (T < 0)\n" + BACK_TAIL).replace(
                BACK_LOOP, BACK_LOOP.replace("t0 >= 0;", "t0 >= 0 && T < 0;"))}


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


def timed(torch, fn, reps):
    """Mean CUDA-event ms over ``reps`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Mean device time of one launch, from torch.profiler's CUDA kernel
    records over ``reps`` launches (the kernel alone, without the gaps
    that the host's launch rate leaves)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps if total else None


def entry(lib, symbol, n_ptr, n_int):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check(name, err):
    if err:
        raise RuntimeError("{}: cuda error {}".format(name, err))


# One label -> waveform timing of a tree, run from its root: its own
# chip_smoke.build_slice and time_slice (B = 6, the fixture batch, and
# B = 48), one JSON line of the numbers compared.
SERVE_RUN = r"""
import json, sys
import torch
import chip_smoke
dev = torch.device("cuda", 0)
questions, model, make_pipeline = chip_smoke.build_slice(torch, dev)
timing = chip_smoke.time_slice(torch, make_pipeline(dev), model, questions,
                               sys.argv[1])
print("SERVE_JSON " + json.dumps({str(B): {
    k: r[k] for k in ("xrt", "total_ms", "model_ms", "mlpg_ms",
                      "vocoder_ms")} for B, r in timing.items()}))
"""


def serve_pairs(trees, pairs, card):
    """label -> waveform xRT of the parent's tree and this one, each run
    in a process of its own, in ``pairs`` alternating pairs (parent,
    change, change, parent, ...).  Returns {tree: [runs]} and prints each
    run and the medians."""
    order = []
    for i in range(pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    for name in order:
        proc = subprocess.run([sys.executable, "-c", SERVE_RUN, card],
                              cwd=trees[name], capture_output=True,
                              text=True, timeout=900, check=False)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("SERVE_JSON ")]
        if proc.returncode or not line:
            raise SystemExit("label->wav run in {} failed:\n{}\n{}".format(
                trees[name], proc.stdout[-4000:], proc.stderr[-4000:]))
        run = json.loads(line[-1][len("SERVE_JSON "):])
        runs[name].append(run)
        print("serve {:<6s} {} [{}]".format(name, json.dumps(run), card),
              flush=True)
    for B in runs["change"][0]:
        med = {name: sorted(r[B]["xrt"] for r in rs)[len(rs) // 2]
               for name, rs in runs.items()}
        print("serve B={}: xRT parent {} / change {} (upper medians of {} "
              "runs each) [{}]".format(B, med["parent"], med["change"],
                                       pairs, card), flush=True)
    return runs


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="checkout of an earlier commit")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--serve-pairs", type=int, default=0,
                        help="also time label -> waveform serving of the "
                             "--parent checkout and this tree in this many "
                             "alternating pairs")
    args = parser.parse_args()
    if args.serve_pairs and not args.parent:
        parser.error("--serve-pairs needs --parent")
    import torch
    if not torch.cuda.is_available():
        print("probe_mlpg: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from idiaptts_torch.ops import cuda_mlpg, dispatch
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name", "power.limit")
    csrc = os.path.join(REPO, "idiaptts_torch", "csrc")
    sources = {}
    with open(os.path.join(csrc, "banded_solve.cu")) as f:
        sources.update({k: (v, csrc) for k, v in solve_variants(
            f.read()).items()})
    with open(os.path.join(csrc, "mlpg_oneshot.cu")) as f:
        sources.update({k: (v, csrc) for k, v in oneshot_variants(
            f.read()).items()})
    if args.parent:
        pcsrc = os.path.join(args.parent, "idiaptts_torch", "csrc")
        for name, file in (("solve_parent", "banded_solve.cu"),
                           ("oneshot_parent", "mlpg_oneshot.cu")):
            with open(os.path.join(pcsrc, file)) as f:
                sources[name] = (f.read(), pcsrc)
    sources["micro"] = (MICRO, csrc)
    result = {"card": card, "reps": args.reps, "solve_ms": {},
              "solve_device_ms": {}, "oneshot_ms": {},
              "oneshot_device_ms": {}, "clock_mhz": {}, "max_power_w": {}}
    sampled = {"solve": Sampled(), "oneshot": Sampled()}
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as workdir:
        libs = compile_all(workdir, dispatch.nvcc_path(), dispatch.NVCC_FLAGS,
                           sources)

        micro = entry(libs.pop("micro"), "micro_run", 2, 0)
        out = torch.zeros(len(MICRO_KEYS), dtype=torch.float64, device=dev)
        sink = torch.zeros(256, device=dev)
        for _ in range(2):
            check("micro", micro(out.data_ptr(), sink.data_ptr(), stream))
        torch.cuda.synchronize()
        mhz = float(smi("clocks.sm"))
        cyc = dict(zip(MICRO_KEYS, out.tolist()))
        result.update(micro_cycles=cyc, micro_clock_mhz=mhz,
                      micro_ns={k: v * 1e3 / mhz for k, v in cyc.items()})
        print("micro (cycles):", json.dumps(cyc), "at", mhz, "MHz",
              flush=True)

        # K2 on the served bucket's factor.
        _, variances, _ = chip_smoke.load_corpus()
        pipe = FusedAcousticPipeline(None, variances, 20, device=dev)
        R = cuda_mlpg.SOLVE_ROWS
        floors = {}
        sampled["solve"].__enter__()
        for T, B in SOLVE_SHAPES:
            factors, tau = pipe.factors_for(T)
            D = factors.shape[-1]
            model_out = torch.randn(B, T, 67, generator=gen, device=dev)
            x = torch.empty(B, T, D, device=dev)
            ref = cuda_mlpg.mlpg_served(model_out, pipe._colmap, factors,
                                        tau)
            L = B * D
            feats = model_out.index_select(-1, pipe._colmap.long()) \
                .reshape(B, T, 3, D)
            b = cuda_mlpg.b_vector(feats * tau).permute(1, 0, 2) \
                .reshape(T, L).contiguous()
            tiled = [factors[i].repeat(1, B).contiguous() for i in range(3)]
            y = torch.empty(T, L, device=dev)
            xl = torch.empty(T, L, device=dev)
            fns = {}
            for name, lib in libs.items():
                if name.startswith("solve_parent"):
                    fn = entry(lib, "idt_banded_solve", 6, 2)
                    fns["parent"] = (lambda fn=fn: fn(
                        b.data_ptr(), *(t.data_ptr() for t in tiled),
                        y.data_ptr(), xl.data_ptr(), T, L, stream), xl)
                elif name.startswith("solve_"):
                    fn = entry(lib, "idt_banded_solve", 7, 4)
                    fns[name[6:]] = (lambda fn=fn: fn(
                        model_out.data_ptr(), pipe._colmap.data_ptr(),
                        tau.data_ptr(), *(factors[i].data_ptr()
                                          for i in range(3)),
                        x.data_ptr(), B, T, D, 67, stream), x)
                    if name == "solve_kernel":
                        fns["lanewise"] = (lambda fn=fn: fn(
                            b.data_ptr(), None, None,
                            *(t.data_ptr() for t in tiled), xl.data_ptr(),
                            1, T, L, L, stream), xl)
            key = "T={},B={}".format(T, B)
            result["solve_ms"][key] = {}
            result["solve_device_ms"][key] = {}
            for name, (fn, dst) in fns.items():
                ms = timed(torch, lambda: check(name, fn()), args.reps)
                dev_ms = device_ms(torch, lambda: check(name, fn()), 50)
                result["solve_device_ms"][key][name] = dev_ms
                got = dst if dst.dim() == 3 else dst.reshape(T, B, D) \
                    .permute(1, 0, 2)
                err = (got - ref).abs().max().item()
                result["solve_ms"][key][name] = ms
                print("K2 {:<14s} {:<14s} {:9.4f} ms, device {} ms ({:.4f} "
                      "us a step; max|d| to the kernel {:.1e}) [{}]".format(
                          key, name, ms, dev_ms, ms * 1e3 / (2 * T), err,
                          card), flush=True)
            # Each sweep, super-chunk by super-chunk: a chunk's 2R steps
            # (phases a and c), the walk over its NC chunks, two barriers.
            P = -(-T // R)
            NC = min(P, 256)
            floors["solve " + key] = 2 * -(-P // NC) * (
                2 * R * cyc["substitution_step"] + NC * cyc["carry_step"]
                + 2 * cyc["syncthreads_256"]) / (mhz * 1e3)

        sampled["solve"].__exit__(None, None, None)

        # K1 on seeded systems.
        sampled["oneshot"].__enter__()
        for T, Lk in ONESHOT_SHAPES:
            means, var, sys_args = chip_smoke.mlpg_system(torch, dev, T, Lk,
                                                          0)
            ref = cuda_mlpg.mlpg_oneshot_plain(*sys_args)
            lc, _ = cuda_mlpg.oneshot_plan(dev, T, Lk)
            x = torch.empty(T, Lk, device=dev)
            scratch = torch.empty(-(-Lk // lc), T, lc, 4, device=dev)
            old_scratch = torch.empty(4, T, Lk, device=dev)
            ptrs = [a.data_ptr() for a in sys_args]
            fns = {}
            for name, lib in libs.items():
                if name == "oneshot_parent":
                    fn = entry(lib, "idt_mlpg_oneshot", 6, 2)
                    fns["parent"] = lambda fn=fn: fn(
                        *ptrs, old_scratch.data_ptr(), x.data_ptr(), T, Lk,
                        stream)
                elif name.startswith("oneshot_"):
                    fn = entry(lib, "idt_mlpg_oneshot", 7, 2)
                    fused = (means.data_ptr(), var.data_ptr(), None, None,
                             None)
                    fns[name[8:]] = lambda fn=fn, fused=fused: fn(
                        *fused, None, x.data_ptr(), T, Lk, stream)
                    if name == "oneshot_kernel":
                        fns["assembled"] = lambda fn=fn: fn(
                            ptrs[0], None, *ptrs[1:], None, x.data_ptr(), T,
                            Lk, stream)
                        fns["global_store"] = lambda fn=fn, fused=fused: fn(
                            *fused, scratch.data_ptr(), x.data_ptr(), T, Lk,
                            stream)
            key = "T={},L={}".format(T, Lk)
            result["oneshot_ms"][key] = {}
            result["oneshot_rel_err"] = result.get("oneshot_rel_err", {})
            result["oneshot_rel_err"][key] = {}
            result["oneshot_device_ms"][key] = {}
            for name, fn in fns.items():
                ms = timed(torch, lambda: check(name, fn()), args.reps)
                dev_ms = device_ms(torch, lambda: check(name, fn()), 50)
                result["oneshot_device_ms"][key][name] = dev_ms
                rel = (x - ref).abs().max().item() / ref.abs().max().item()
                result["oneshot_ms"][key][name] = ms
                result["oneshot_rel_err"][key][name] = rel
                print("K1 {:<14s} {:<14s} {:9.4f} ms, device {} ms ({:.4f} "
                      "us a step; rel err to the plain version {:.1e}) [{}]"
                      .format(key, name, ms, dev_ms, ms * 1e3 / (2 * T), rel,
                              card), flush=True)
            floors["oneshot " + key] = T * (
                cyc["factor_step"] + cyc["substitution_step"]) / (mhz * 1e3)
        sampled["oneshot"].__exit__(None, None, None)
        result["floor_ms"] = floors
    for part, smp in sampled.items():
        result["clock_mhz"][part] = smp.clock
        result["max_power_w"][part] = smp.power
        print("{}: SM clock {} MHz, <= {} W".format(part, smp.clock,
                                                     smp.power))
    if args.serve_pairs:
        result["serve"] = serve_pairs(
            {"parent": os.path.abspath(args.parent), "change": REPO},
            args.serve_pairs, card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
