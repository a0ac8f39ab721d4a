#!/usr/bin/env python3
"""Where a step of the WaveNet sampler kernel goes, on one NVIDIA GPU.

    python3 probe_wavenet_sampler.py      # from the repository root

Builds variants of ``idiaptts_torch/csrc/wavenet_sampler.cu`` with parts
of the step taken out (by text substitution of the source; the variants
compute garbage and serve only for timing), times each over T = 4000
sampling steps at the production widths (20 layers, C = 23) with CUDA
events, and prints one JSON line of microseconds per step:

- ``full``: the kernel as it is;
- ``no_weight_copy``: the weight stages are not copied (the products run
  on whatever shared memory holds), so the copies' share shows;
- ``no_compute``: the copies, the barriers and the embedding lookup
  only (the layer and output stages' work, ring writes included, left
  out);
- ``no_copy_no_compute``: as ``no_compute`` without the weight copies;
- ``no_layer_compute``: the layer stages' work left out (ring writes
  included);
- ``no_output_compute``: post1, post2 and the draw left out;
- ``cheap_activation``: ``tanh(a) * sigmoid(b)`` replaced by ``a * b``.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
T_STEPS = 4000
BATCHES = (16, 256)

COPY_LAYER = """      for (int i = tid; i < WL / 16; i += THREADS)
        cp16(buf + 16 * i, src + 16 * i);"""
COPY_POST = """      for (int i = tid; i < POST_BYTES / 16; i += THREADS)
        cp16(buf + 16 * i, post + 16 * i);"""
LAYER = """      if (s < L) {
        const unsigned char* w1f = buf;"""
OUTPUT = """      } else {
        const unsigned char* p1f = buf;"""
ACTIVATION = "          zv[e] = tanhf(pa) * sigmoidf_(pb);"


def variants(src):
    for anchor in (COPY_LAYER, COPY_POST, LAYER, OUTPUT, ACTIVATION):
        if anchor not in src:
            raise SystemExit("probe anchor not found in the kernel source:\n"
                             + anchor)
    no_copy = src.replace(COPY_LAYER, "").replace(COPY_POST, "")
    skip_all = LAYER.replace("if (s < L) {", "if (s >= 0) {} else if (s < L) {")
    skip_layer = LAYER.replace("if (s < L) {", "if (s < L) {} else if (s < 0) {")
    skip_output = OUTPUT.replace("} else {", "} else if (s < 0) {")
    return {
        "full": src,
        "no_weight_copy": no_copy,
        "no_compute": src.replace(LAYER, skip_all),
        "no_copy_no_compute": no_copy.replace(LAYER, skip_all),
        "no_layer_compute": src.replace(LAYER, skip_layer),
        "no_output_compute": src.replace(OUTPUT, skip_output),
        "cheap_activation": src.replace(ACTIVATION,
                                        "          zv[e] = pa * pb;"),
    }


def build(workdir, nvcc, flags):
    """{variant: ctypes entry point}, one nvcc per variant, in parallel."""
    csrc = os.path.join(REPO, "idiaptts_torch", "csrc")
    with open(os.path.join(csrc, "wavenet_sampler.cu")) as f:
        src = f.read()
    procs = {}
    for name, text in variants(src).items():
        path = os.path.join(workdir, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", path[:-3] + ".so", path,
             os.path.join(csrc, "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("nvcc failed for {}:\n{}".format(name, out))
        fn = ctypes.CDLL(os.path.join(workdir, name + ".so")) \
            .idt_wavenet_sampler
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_wavenet_sampler: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    from idiaptts_torch.ops import dispatch
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",), num_layers=20,
                                num_stacks=2, cond_channels=23)
    w = cfg.create_model(torch.Generator().manual_seed(0)).to(dev) \
        .sampler().weights
    layers, post, dil, offs, Cp = w.kernel_args()
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": card, "T": T_STEPS, "us_per_step": {}}
    with tempfile.TemporaryDirectory() as workdir:
        fns = build(workdir, dispatch.nvcc_path(), dispatch.NVCC_FLAGS)
        for B in BATCHES:
            cond = torch.zeros(T_STEPS, B, Cp, dtype=torch.bfloat16,
                               device=dev)
            cond[:, :, :w.C] = 0.3 * torch.randn(T_STEPS, B, w.C,
                                                 generator=gen, device=dev)
            u = torch.rand(T_STEPS, B, generator=gen, device=dev)
            samples = torch.empty(T_STEPS, B, dtype=torch.int32, device=dev)
            ring = torch.zeros(w.slots, B, w.R, dtype=torch.bfloat16,
                               device=dev)
            per_b = result["us_per_step"][B] = {}
            for name, fn in fns.items():
                def run():
                    err = fn(cond.data_ptr(), u.data_ptr(), None,
                             w.embed.data_ptr(), layers.data_ptr(),
                             post.data_ptr(), dil.data_ptr(),
                             offs.data_ptr(), ring.data_ptr(),
                             samples.data_ptr(), None, T_STEPS, B, Cp,
                             len(w.dilations), w.out_channels, 0, 0, 1.0,
                             torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError("{}: cuda error {}".format(
                            name, err))
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                run()
                end.record()
                torch.cuda.synchronize()
                per_b[name] = start.elapsed_time(end) / 2 * 1e3 / T_STEPS
                print("B={:<4d} {:<20s} {:8.3f} us/step [{}]".format(
                    B, name, per_b[name], card), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
