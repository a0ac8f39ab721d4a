#!/usr/bin/env python3
"""What holds the BiLSTM projection kernel back, on one NVIDIA GPU.

    python3 probe_bilstm_proj.py      # from the repository root

Builds variants of ``idiaptts_torch/csrc/bilstm_proj.cu`` by text
substitution of the source (one nvcc per variant, all started together),
checks the tile variants against the plain version, times every variant
beside a bf16 ``torch.bmm`` of the same product at the serving (T = 512,
B = 6 and 48) and training (T = 1024, B = 8 and 32) shapes with CUDA
events, in the order variants, bmm, variants reversed, and prints one
JSON line:

- ``kernel``: the kernel as it is (128 x 256 tiles, 3 stages);
- ``no_store``: the storers write nothing, so the float32 output's
  share shows;
- ``no_loads``: as ``no_store`` with no TMA load either (the products
  run on whatever shared memory holds): the tensor cores, the barriers
  and the hand-over alone;
- ``no_loads_k16``: as ``no_loads`` with each tile's K loop run 16
  times, so the tile boundaries, the launch and the last wave weigh
  1/16 as much; its TFLOP/s count the 16-fold work;
- ``tile_192x128``, ``tile_128x128``, ``tile_256x128``: other tile
  shapes and stage counts, checked and timed like the kernel.

The ``no_*`` variants compute garbage and serve only for timing.  Then
the card's SM clock and power draw (``nvidia-smi``, every 100 ms) during
two seconds of back-to-back kernel and bmm calls at T = 512, B = 48, and
the host time per call (no synchronisation inside) of the wrapper
``bilstm_projection_tmajor``, of the bare C entry point and of bmm at
T = 512, B = 6.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((512, 6), (512, 48), (1024, 8), (1024, 32))   # (T, B)
D, F = 1024, 512
CHECK_SHAPES = ((37, 7, 1000, 96), (9, 48, 1024, 72), (3, 131, 64, 128),
                (512, 48, 1024, 512))

CFG = """constexpr int BM = 128;                        // rows a tile
constexpr int BN = 256;                        // columns a tile
constexpr int BK = 64;                         // K a stage: 128 bytes of bf16
constexpr int STAGES = 3;"""
STORE = "          __stcs(reinterpret_cast<float4*>(out + col), v);"
A_LOAD = """        tma_load_4d(a_base + st * A_STAGE, &a_map, full, kb * BK, x.r0, x.d,
                    x.t0);"""
B_LOAD = """#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(b_base + st * B_STAGE + c * B_BOX, &b_map, full,
                      x.n0 + 64 * c, kb * BK, x.d);"""
EXPECT = "        mbar_expect_tx(full, tx);"
K_LOOP = "for (int kb = 0; kb < s.k_blocks; ++kb) {"


def _sub(src, old, new, count=1, source="bilstm_proj.cu"):
    if src.count(old) != count:
        raise SystemExit("probe: anchor not found {} time(s) in {}:\n{}"
                         .format(count, source, old))
    return src.replace(old, new)


def variants(src):
    def tile(bm, bn, stages):
        return _sub(src, CFG, "constexpr int BM = {};\nconstexpr int BN = "
                    "{};\nconstexpr int BK = 64;\nconstexpr int STAGES = {};"
                    .format(bm, bn, stages))
    no_store = _sub(src, STORE, "          if (s.N < 0)\n" + STORE)
    no_loads = _sub(_sub(_sub(no_store, A_LOAD, ""), B_LOAD, ""), EXPECT,
                    "        mbar_arrive(full);")
    return {
        "kernel": src,
        "no_store": no_store,
        "no_loads": no_loads,
        "no_loads_k16": _sub(no_loads, K_LOOP, K_LOOP.replace(
            "s.k_blocks", "16 * s.k_blocks"), count=2),
        "tile_192x128": tile(192, 128, 4),
        "tile_128x128": tile(128, 128, 5),
        "tile_256x128": tile(256, 128, 3),
    }


ENTRIES = {"idt_bilstm_proj": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5}


def build(srcs, out_dir, entries=None):
    """One nvcc per variant source, all started together (the sources'
    headers from ``idiaptts_torch/csrc``); returns the loaded libraries
    with ``entries`` ({symbol: argtypes without the stream}) typed, and
    ptxas' register and spill lines per variant."""
    from idiaptts_torch.ops import dispatch
    entries = ENTRIES if entries is None else entries
    nvcc = dispatch.nvcc_path()
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(out_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *dispatch.NVCC_FLAGS, "-I", dispatch.CSRC_DIR, "-shared",
             "-o", os.path.join(out_dir, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for {}:\n{}".format(name, log))
        ptxas[name] = [line.split(":", 1)[-1].strip()
                       for line in log.splitlines()
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line]
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        for symbol, argtypes in entries.items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def launcher(torch, lib):
    def call(xin, wx, bias, xp):
        T, R, K = xin.shape
        err = lib.idt_bilstm_proj(xin.data_ptr(), wx.data_ptr(),
                                  bias.data_ptr(), xp.data_ptr(), T, R // 2,
                                  K, wx.shape[-1], 2,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("launch failed: cuda error {}".format(err))
    return call


def inputs(torch, T, B, K, N, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xin = torch.randn(T, 2 * B, K, generator=g, device="cuda").to(
        torch.bfloat16)
    wx = (torch.randn(2, K, N, generator=g, device="cuda")
          / K ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(2, N, generator=g, device="cuda")
    return xin, wx, bias


def agrees(torch, call, T, B, K, F_):
    """The checks of chip_smoke.py: at most one bf16 ulp (+1e-5) from the
    plain version with a zero bias, under 1% of products apart, the bias
    add exact, every output written."""
    from idiaptts_torch.ops import cuda_lstm
    xin, wx, bias = inputs(torch, T, B, K, 4 * F_, 1)
    zero = torch.zeros_like(bias)
    out = torch.full((T, 2 * B, 4 * F_), float("nan"), device="cuda")
    call(xin, wx, zero, out)
    ref = cuda_lstm.projection_tmajor_plain(xin, wx, zero)
    _, e = torch.frexp(torch.maximum(out.abs(), ref.abs()))
    d = (out - ref).abs()
    with_bias = torch.empty_like(out)
    call(xin, wx, bias, with_bias)
    rows = bias[None, :, None, :].expand(T, 2, B, 4 * F_).reshape(
        T, 2 * B, 4 * F_)
    return bool(torch.all(d <= torch.ldexp(torch.ones_like(d), e - 8)
                          + 1e-5)
                and (d > 0).float().mean().item() < 1e-2
                and torch.equal(with_bias, out + rows))


def cuda_ms(torch, fn, reps=20):
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


def clocks_during(torch, fn, seconds=2.0):
    """nvidia-smi samples (SM MHz, power W) while ``fn`` runs back to
    back; the first 0.5 s of samples are dropped."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        t0 = time.time()
        while time.time() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
    rows = [line.split(",") for line in proc.communicate()[0].splitlines()
            if line.strip()][5:]
    mhz = [float(r[0]) for r in rows]
    watts = [float(r[1]) for r in rows]
    return {"samples": len(rows), "sm_mhz_min": min(mhz),
            "sm_mhz_max": max(mhz), "sm_mhz_mean": sum(mhz) / len(mhz),
            "power_w_mean": sum(watts) / len(watts),
            "power_w_max": max(watts)}


def host_ms(torch, fn, calls=50):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_bilstm_proj: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import cuda_lstm, dispatch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(REPO, "idiaptts_torch", "csrc",
                           "bilstm_proj.cu")) as f:
        srcs = variants(f.read())
    os.makedirs(dispatch.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dispatch.BUILD_DIR) as tmp:
        libs, ptxas = build(srcs, tmp)
        calls = {k: launcher(torch, lib) for k, lib in libs.items()}
        checked = {k: all(agrees(torch, calls[k], *s) for s in CHECK_SHAPES)
                   for k in calls if not k.startswith("no_")}
        print("checks against the plain version:", checked, flush=True)
        times = {}
        for T, B in SHAPES:
            xin, wx, bias = inputs(torch, T, B, D, 4 * F, 0)
            xp = torch.empty(T, 2 * B, 4 * F, device="cuda")
            x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
                2, T * B, D).contiguous()
            flops = 2.0 * T * 2 * B * D * 4 * F
            row = {}
            for k in list(calls) + ["bmm"] + list(calls)[::-1]:
                fn = ((lambda: torch.bmm(x_dir, wx)) if k == "bmm" else
                      (lambda k=k: calls[k](xin, wx, bias, xp)))
                row.setdefault(k, []).append(cuda_ms(torch, fn))
            times["T={},B={}".format(T, B)] = {
                k: {"ms": v, "tflops_per_s": (16 if k.endswith("k16")
                                              else 1) * flops / min(v) / 1e9}
                for k, v in row.items()}
            print("T={} B={}: {}".format(T, B, "  ".join(
                "{} {}".format(k, "/".join("{:.4f}".format(x) for x in v))
                for k, v in row.items())), flush=True)
        T, B = 512, 48
        xin, wx, bias = inputs(torch, T, B, D, 4 * F, 0)
        xp = torch.empty(T, 2 * B, 4 * F, device="cuda")
        x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
            2, T * B, D).contiguous()
        clocks = {
            "kernel": clocks_during(torch, lambda: calls["kernel"](
                xin, wx, bias, xp)),
            "bmm": clocks_during(torch, lambda: torch.bmm(x_dir, wx))}
        T, B = 512, 6
        xin, wx, bias = inputs(torch, T, B, D, 4 * F, 0)
        xp = torch.empty(T, 2 * B, 4 * F, device="cuda")
        x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
            2, T * B, D).contiguous()
        host = {
            "wrapper": host_ms(torch, lambda: cuda_lstm
                               .bilstm_projection_tmajor(xin, wx, bias)),
            "c_entry_point": host_ms(torch, lambda: calls["kernel"](
                xin, wx, bias, xp)),
            "bmm": host_ms(torch, lambda: torch.bmm(x_dir, wx))}
    print(json.dumps({"card": card, "ptxas": ptxas, "checked": checked,
                      "times": times, "clocks_T512_B48": clocks,
                      "host_ms_per_call_T512_B6": host}))
    return 0 if all(checked.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
