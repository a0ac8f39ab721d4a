#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``idiaptts_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds and serves on the card.

    python3 chip_smoke.py          # from the repository root

Phases (any failure raises, so the exit code is non-zero):

1. Environment: torch/CUDA versions, nvcc, the Triton version or its
   absence, the card's name and power limit.  No CUDA device: exit 2.
2. Build the hand kernels from ``idiaptts_torch/csrc/`` (nvcc, ctypes).
3. Each kernel against its plain PyTorch version on the card at the
   serving path's shapes (T = 512 frames; fixture batch B = 6 and the 8x
   capacity batch B = 48), with CUDA-event times for both.
4. The full-width slice: the Interspeech'18 acoustic model
   ``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67`` (141 question inputs,
   random weights from a seeded ``torch.Generator``; the repository holds
   no trained weights), MLPG variances from the fixture corpus, served by
   ``SynthesisServer`` over the port's pipeline on ``cuda`` for the six
   fixture utterances submitted concurrently.  Launch counters are reset
   just before and read just after, and every kernel must have launched.
   The card's result is held against the port's CPU path on one
   utterance, then the slice is timed (label -> waveform xRT at B = 6 and
   B = 48, and per-stage ms).

The last three lines of standard output are the kernels JSON, the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device": ...}``.
"""

import copy
import importlib.metadata
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
MODEL_STRING = "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67"
NUM_SPS = 20
FS = 16000
T_BUCKET = 512
BATCHES = (6, 48)
D_IN, F_HIDDEN = 1024, 512       # BiLSTM input and hidden width
# Recurrence kernel vs plain recurrence, absolute on h in (-1, 1);
# measured 8.7e-4 (B=6) and 1.1e-3 (B=48) on an H100.
REC_TOL = 5e-3

# Where each hand kernel comes from, for the kernels JSON line.
KERNEL_SOURCES = {
    "banded_solve": ("idiaptts_torch/csrc/banded_solve.cu",
                     "idiaptts_tpu/ops/pallas_mlpg.py:170"),
    "bilstm_recurrence": ("idiaptts_torch/csrc/bilstm_recurrence.cu",
                          "idiaptts_tpu/ops/pallas_lstm.py:76"),
    "bilstm_proj": ("idiaptts_torch/csrc/bilstm_proj.cu",
                    "idiaptts_tpu/ops/pallas_lstm.py:590"),
}


def log(*args):
    print(*args, flush=True)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, reps):
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` launches,
    after one warm-up call."""
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


# -- phase 1 -----------------------------------------------------------------

def environment(torch):
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "torch.version.cuda", torch.version.cuda)
    try:
        log("triton", importlib.metadata.version("triton"),
            "(installed; the port uses no Triton kernel)")
    except importlib.metadata.PackageNotFoundError:
        log("triton: not installed")
    from idiaptts_torch.ops import dispatch
    nvcc = dispatch.nvcc_path()
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    log("nvcc", nvcc, "|", out.strip().splitlines()[-1])
    card = gpu_name_and_limit()
    log("card:", card, "| devices:", torch.cuda.device_count())
    # Full float32 for the plain versions and the mcep basis matmuls;
    # bf16 GEMMs accumulate in float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    return card


# -- phase 2 -----------------------------------------------------------------

def build():
    from idiaptts_torch.ops import dispatch
    t0 = time.perf_counter()
    dispatch.library()
    info = dispatch.build_info
    log("kernel build: {:.2f} s (nvcc {:.2f} s) -> {}".format(
        time.perf_counter() - t0, info["seconds"],
        os.path.relpath(info["path"], REPO)))
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log("  ptxas:", line.strip())


# -- phase 3 -----------------------------------------------------------------

def _check(name, err, tol, what):
    log("  {:<18s} {:<34s} max|d| = {:.3e}  (tol {:.1e})".format(
        name, what, err, tol))
    if not err <= tol:
        raise AssertionError("{} {}: max|d| {:.3e} > tol {:.1e}".format(
            name, what, err, tol))


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significand bits)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def kernel_checks(torch, pipeline, device):
    """Each kernel against its plain version at the serving shapes.
    Returns {kernel name: {B: measurements}}."""
    from idiaptts_torch.ops import cuda_lstm, cuda_mlpg
    gen = torch.Generator(device=device).manual_seed(1234)
    T, F, D = T_BUCKET, F_HIDDEN, D_IN
    results = {k: {} for k in KERNEL_SOURCES}
    factors, _ = pipeline.factors_for(T)
    n_feat = factors.shape[-1]

    for B in BATCHES:
        # K2: the MLPG substitutions, L = B * 22 lanes, real factors.
        L = B * n_feat
        l0, l1, l2 = (factors[i].repeat(1, B).contiguous()
                      for i in range(3))
        b = torch.randn(T, L, generator=gen, device=device)
        x_k = cuda_mlpg.solve_banded(b, l0, l1, l2)
        x_p = cuda_mlpg.solve_banded_plain(b, l0, l1, l2)
        err = (x_k - x_p).abs().max().item()
        scale = max(1.0, x_p.abs().max().item())
        # Same operations in the same order; only nvcc's FMA contraction
        # differs (a few float32 ulps per step, amplified by the system's
        # conditioning; measured 2.5e-5 and 3.8e-5 on an H100).
        _check("banded_solve", err, 1e-5 * scale,
               "T={} L={}".format(T, L))
        results["banded_solve"][B] = dict(
            shape="T={},L={}".format(T, L), max_abs_err=err,
            ms=cuda_ms(torch, lambda: cuda_mlpg.solve_banded(
                b, l0, l1, l2), 20),
            plain_ms=cuda_ms(torch, lambda: cuda_mlpg.solve_banded_plain(
                b, l0, l1, l2), 2))

        # K6, projection half: bf16(x . Wx) + b.
        xin = torch.randn(T, 2 * B, D, generator=gen,
                          device=device).to(torch.bfloat16)
        wx = (torch.randn(2, D, 4 * F, generator=gen, device=device)
              / np.sqrt(D)).to(torch.bfloat16)
        bias = 0.1 * torch.randn(2, 4 * F, generator=gen, device=device)
        xp_k = cuda_lstm.bilstm_projection_tmajor(xin, wx, bias)
        xp_p = cuda_lstm.projection_tmajor_plain(xin, wx, bias)
        diff = (xp_k - xp_p).abs()
        # Both accumulate in float32 and round to bf16; summation order
        # differs, so a product near a rounding midpoint can land on the
        # neighbouring bf16 value.  With a zero bias the outputs are the
        # bf16 products themselves: at most one bf16 ulp apart (plus 1e-5
        # for sums that cancel to near zero, where float32 summation
        # noise exceeds the ulp), and rarely.
        zero = torch.zeros_like(bias)
        p_k = cuda_lstm.bilstm_projection_tmajor(xin, wx, zero)
        p_p = cuda_lstm.projection_tmajor_plain(xin, wx, zero)
        d_p = (p_k - p_p).abs()
        excess = (d_p - bf16_ulp(torch, torch.maximum(p_k.abs(), p_p.abs()))
                  - 1e-5).max().item()
        flips = (d_p > 0).float().mean().item()
        bias_rows = bias[None, :, None, :].expand(T, 2, B, 4 * F).reshape(
            T, 2 * B, 4 * F)
        log("  bilstm_proj        T={} R={} D={} N={}: max|d| = {:.3e}, "
            "{:.4%} of products one bf16 ulp apart".format(
                T, 2 * B, D, 4 * F, diff.max().item(), flips))
        if excess > 0 or flips > 1e-2:
            raise AssertionError("bilstm_proj products differ by more than "
                                 "rare one-ulp bf16 rounding flips")
        # The bias is one float32 add, the same in both.
        if not torch.equal(xp_k, p_k + bias_rows):
            raise AssertionError("bilstm_proj bias add differs")
        results["bilstm_proj"][B] = dict(
            shape="T={},R={},D={},N={}".format(T, 2 * B, D, 4 * F),
            max_abs_err=diff.max().item(),
            ms=cuda_ms(torch, lambda: cuda_lstm.bilstm_projection_tmajor(
                xin, wx, bias), 20),
            plain_ms=cuda_ms(torch, lambda: cuda_lstm
                             .projection_tmajor_plain(xin, wx, bias), 20))

        # K3: the recurrence over the projections just made.
        wh_cat = (torch.randn(2 * F, 4 * F, generator=gen, device=device)
                  / np.sqrt(F)).to(torch.bfloat16)
        h_k = cuda_lstm.bilstm_recurrence_tmajor(xp_p, wh_cat)
        h_p = cuda_lstm.recurrence_tmajor_plain(xp_p, wh_cat)
        # Float32 sums in another order; h feeds the next step rounded to
        # bf16, so a rare rounding flip moves a gate by one bf16 ulp of
        # h times |w| and the state carries it on.
        rec_err = (h_k - h_p).abs().max().item()
        _check("bilstm_recurrence", rec_err, REC_TOL,
               "T={} R={} F={}".format(T, 2 * B, F))
        results["bilstm_recurrence"][B] = dict(
            shape="T={},R={},F={}".format(T, 2 * B, F),
            max_abs_err=rec_err,
            ms=cuda_ms(torch, lambda: cuda_lstm.bilstm_recurrence_tmajor(
                xp_p, wh_cat), 5),
            plain_ms=cuda_ms(torch, lambda: cuda_lstm
                             .recurrence_tmajor_plain(xp_p, wh_cat), 1))

        # K6 whole: projection kernel then recurrence kernel, against the
        # plain layer.  On top of the recurrence's tolerance, each
        # projection flip moves one gate pre-activation by one bf16 ulp,
        # and h moves by at most as much (|dh/dgate| <= 1).
        lay_err = (cuda_lstm.bilstm_layer_tmajor(xin, wx, wh_cat, bias)
                   - cuda_lstm.scan_layer_tmajor(xin, wx, wh_cat, bias)
                   ).abs().max().item()
        _check("bilstm_layer", lay_err, REC_TOL + diff.max().item(),
               "T={} R={} D={} F={}".format(T, 2 * B, D, F))
        results["bilstm_proj"][B]["layer_max_abs_err"] = lay_err
        results["bilstm_proj"][B]["layer_ms"] = cuda_ms(
            torch, lambda: cuda_lstm.bilstm_layer_tmajor(
                xin, wx, wh_cat, bias), 5)
        results["bilstm_proj"][B]["layer_plain_ms"] = cuda_ms(
            torch, lambda: cuda_lstm.scan_layer_tmajor(
                xin, wx, wh_cat, bias), 1)
    for name, by_b in results.items():
        for B, r in by_b.items():
            log("  {:<18s} B={:<3d} {:<28s} kernel {:9.4f} ms | plain "
                "{:9.4f} ms".format(name, B, r["shape"], r["ms"],
                                    r["plain_ms"]))
    return results


# -- phase 4 -----------------------------------------------------------------

def load_corpus():
    """The six fixture utterances' question matrices and the MLPG
    variances, read with numpy (raw float32 question files; npz
    covariances).  As in bench.py, the model output is not
    denormalised: with random weights, fixture statistics would give
    unvoiced, fully periodic (silent) frames."""
    with open(os.path.join(FIXTURES, "questions-gen_dnn.hed")) as f:
        num_q = sum(1 for line in f if len(line.rstrip("\n")) > 5
                    and line.split()[0] in ("QS", "CQS"))
    num_q += 9                                       # subphone features
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    questions = [np.fromfile(os.path.join(FIXTURES, "questions",
                                          i + ".questions"),
                             dtype=np.float32).reshape(-1, num_q)
                 for i in ids]

    def diag(name):
        with np.load(os.path.join(FIXTURES, "WORLD", "cmp_mcep20",
                                  name + "-mean-covariance.npz")) as f:
            return np.diagonal(f["covariance"]).astype(np.float32)

    variances = {"sp": diag("mcep20"), "lf0": diag("lf0"),
                 "bap": diag("bap")}
    return questions, variances, num_q


def build_slice(torch, device, model_string=MODEL_STRING):
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    questions, variances, num_q = load_corpus()
    cfg = convert_legacy_string(model_string, num_q)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    model = cfg.create_model(torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    def model_apply(m, questions_b, lengths_b):
        return m({"questions": questions_b}, lengths=lengths_b)["pred"]

    def make_pipeline(dev):
        return FusedAcousticPipeline(model_apply, variances,
                                     num_coded_sps=NUM_SPS, fs=FS,
                                     bucket=256, device=dev)

    return questions, model, make_pipeline


def serve(pipeline, model, questions):
    """Submit every utterance concurrently to a SynthesisServer over the
    pipeline; return the waveforms and the server's stats."""
    from idiaptts_torch.synth.server import SynthesisServer
    server = SynthesisServer(pipeline, model, max_batch=8, max_wait_ms=200)
    try:
        with ThreadPoolExecutor(len(questions)) as pool:
            futures = [pool.submit(server.synth, q) for q in questions]
            wavs = [f.result(timeout=900) for f in futures]
    finally:
        server.shutdown()
    return wavs, server.stats()


def check_waveforms(wavs, questions, hop):
    for i, (w, q) in enumerate(zip(wavs, questions)):
        if w.shape != (len(q) * hop,):
            raise AssertionError("utterance {}: waveform shape {} != "
                                 "({},)".format(i, w.shape, len(q) * hop))
        if not np.all(np.isfinite(w)):
            raise AssertionError("utterance {}: non-finite samples".format(i))
        rms = float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
        if not rms > 1e-4:
            raise AssertionError("utterance {}: silent (rms {})".format(
                i, rms))
        log("  utt {}: {} frames -> {} samples, rms {:.4f}, peak {:.4f}"
            .format(i, len(q), w.size, rms, float(np.abs(w).max())))


def check_against_cpu(torch, pipeline, cpu_pipe, model, questions):
    """The card's stages against the port's CPU path (plain versions) on
    one utterance: the model output at bf16 scale, then MLPG and the
    vocoder on the card's model output with one shared noise draw."""
    from idiaptts_torch.ops.world.synthesis import noise_draw
    q = questions[0]
    cpu_model = copy.deepcopy(model).to("cpu")
    batch, lengths, f0c = pipeline.prepare([q])
    T = batch.shape[1]
    nb_small = max(min(pipeline.num_bins, 129),
                   pipeline.hop // 2 + 1 + (pipeline.hop % 2))
    z = noise_draw(T, nb_small, torch.Generator().manual_seed(7), "cpu")
    with torch.inference_mode():
        out_g = pipeline.model_stage(model, batch, lengths)
        out_c = cpu_pipe.model_stage(cpu_model, batch.cpu(), lengths.cpu())
        err = (out_g.cpu() - out_c).abs().max().item()
        top = out_c.abs().max().item()
        # The FC output is bf16: 4 bf16 ulps at the output's magnitude.
        _check("model_stage", err, top * 2.0 ** -6, "B=1 T={}".format(T))
        sm_g, vuv_g = pipeline.mlpg_stage(out_g, lengths,
                                          *pipeline.factors_for(T))
        sm_c, vuv_c = cpu_pipe.mlpg_stage(out_g.cpu(), lengths.cpu(),
                                          *cpu_pipe.factors_for(T))
        _check("mlpg_stage", (sm_g.cpu() - sm_c).abs().max().item(),
               1e-4 * max(1.0, sm_c.abs().max().item()), "B=1")
        if not torch.equal(vuv_g.cpu(), vuv_c):
            raise AssertionError("mlpg_stage voicing differs from CPU")
        w_g = pipeline.vocoder_stage(sm_g, vuv_g, f0c, z=z.to(sm_g.device))
        w_c = cpu_pipe.vocoder_stage(sm_c, vuv_c, f0c.cpu(), z=z)
        # Same inputs and draw: float32 transcendental and FFT rounding
        # only, relative to the waveform's peak.
        _check("vocoder_stage", (w_g.cpu() - w_c).abs().max().item(),
               1e-3 * max(1.0, w_c.abs().max().item()), "B=1")


def time_slice(torch, pipeline, model, questions, card):
    """CUDA-event label -> waveform xRT at the fixture batch and the 8x
    capacity batch, plus per-stage ms."""
    out = {}
    for rep in (1, 8):
        qs = list(questions) * rep
        batch, lengths, f0c = pipeline.prepare(qs)
        B, T = batch.shape[0], batch.shape[1]
        factors, tau = pipeline.factors_for(T)
        audio_s = float(sum(len(q) for q in qs)) * pipeline.hop / FS
        with torch.inference_mode():
            total = cuda_ms(torch, lambda: pipeline.run(
                model, batch, lengths, f0c), 5)
            o = pipeline.model_stage(model, batch, lengths)
            sm, vuv = pipeline.mlpg_stage(o, lengths, factors, tau)
            stages = {
                "model_ms": cuda_ms(torch, lambda: pipeline.model_stage(
                    model, batch, lengths), 5),
                "mlpg_ms": cuda_ms(torch, lambda: pipeline.mlpg_stage(
                    o, lengths, factors, tau), 5),
                "vocoder_ms": cuda_ms(torch, lambda: pipeline
                                      .vocoder_stage(sm, vuv, f0c), 5),
            }
        out[B] = dict(T=T, audio_s=audio_s, total_ms=total,
                      xrt=audio_s / (total / 1e3), **stages)
        log("  B={} T={} audio {:.2f} s: label->wav {:.3f} ms = {:.1f}x "
            "realtime | model {:.3f} ms, mlpg {:.3f} ms, vocoder {:.3f} ms "
            "[{}]".format(B, T, audio_s, total, out[B]["xrt"],
                          stages["model_ms"], stages["mlpg_ms"],
                          stages["vocoder_ms"], card))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import cuda_lstm, cuda_mlpg, dispatch  # noqa: F401

    log("== phase 1: environment")
    card = environment(torch)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    log("== phase 2: build")
    build()

    log("== phase 3: kernels against their plain versions [{}]".format(
        card))
    questions, model, make_pipeline = build_slice(torch, device)
    pipeline = make_pipeline(device)
    kres = kernel_checks(torch, pipeline, device)

    log("== phase 4: full-width slice {} through SynthesisServer on {}"
        .format(MODEL_STRING, device))
    # Warm the bucket's MLPG factors outside the counted run.
    pipeline.factors_for(T_BUCKET)
    dispatch.reset_counts()
    wavs, stats = serve(pipeline, model, questions)
    torch.cuda.synchronize()
    launches = dispatch.counts()
    log("  launches during the served run:", json.dumps(launches))
    log("  server stats:", json.dumps(stats))
    missing = [k for k in KERNEL_SOURCES if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError("kernels not launched on the main path: "
                             + ", ".join(missing))
    check_waveforms(wavs, questions, pipeline.hop)
    check_against_cpu(torch, pipeline, make_pipeline("cpu"), model,
                      questions)
    timing = time_slice(torch, pipeline, model, questions, card)
    log("  slice timing:", json.dumps({str(k): v for k, v in
                                        timing.items()}))

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = kres[name][BATCHES[0]]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "shape": r["shape"],
                 "card": card}
        entry["capacity_batch"] = {
            k: v for k, v in kres[name][BATCHES[1]].items()}
        if "layer_ms" in r:
            entry.update(layer_max_abs_err=r["layer_max_abs_err"],
                         layer_ms=r["layer_ms"],
                         layer_plain_ms=r["layer_plain_ms"])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
