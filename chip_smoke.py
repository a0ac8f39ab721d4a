#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``idiaptts_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, serves and trains on
the card.

    python3 chip_smoke.py          # from the repository root

Phases (a failed check is logged and recorded; the script ends with a
non-zero exit code and no result line if any check failed, and any
other error raises at once):

1. Environment: torch/CUDA versions, nvcc, the Triton version or its
   absence, the card's name and power limit.  No CUDA device: exit 2.
2. Build the hand kernels from ``idiaptts_torch/csrc/`` (one nvcc per
   source, in parallel, then a link; loaded with ctypes).
3. The serving kernels against their plain PyTorch versions on the card
   at the serving path's shapes (T = 512 frames; fixture batch B = 6 and
   the 8x capacity batch B = 48), with CUDA-event times for both and for
   the PyTorch library call that computes the same function.
4. The serving path at full width: the Interspeech'18 acoustic model
   ``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67`` (141 question inputs,
   random weights from a seeded ``torch.Generator``; the repository holds
   no trained weights), MLPG variances from the fixture corpus, served by
   ``SynthesisServer`` over the port's pipeline on ``cuda`` for the six
   fixture utterances submitted concurrently.  Launch counters are reset
   just before and read just after, and every serving kernel must have
   launched.  The card's result is held against the port's CPU path on
   one utterance, then the slice is timed (label -> waveform xRT at
   B = 6 and B = 48, and per-stage ms).
5. The training kernels against their plain versions at the training
   benchmark's shapes (T = 1024, D = 1024, F = 512, B = 8 and 32): the
   training recurrence's h bit-identical to the inference kernel's, its
   gates and cells, the reverse-time backward's dz (float32 and bf16
   residuals), and one layer's autograd gradients against autograd
   through the plain layer; CUDA-event times beside cuDNN's LSTM.
6. The training path at full width: ``AcousticModelTrainer`` on the
   fixture corpus on ``cuda`` (3 epochs, batch 2, 25% validation), with
   the launch counters reset just before ``train`` and read just after;
   every training kernel must have launched, the training loss must be
   finite and fall, and the last checkpoint must reload to the same
   parameters.  One train step's loss and gradients are held against the
   port's CPU path on one utterance.  Then the handler's train step is
   timed at B = 8 and 32, T = 1024, on seeded random data (CUDA events;
   frames/s, TFLOP/s, and device time per kernel from torch.profiler).
7. The WaveNet sampler kernel against its plain version at the
   production widths (``WaveNetWrapper.Config`` defaults: 20 layers in 2
   stacks, 64 residual/skip channels, 256 classes; random weights from a
   seeded ``torch.Generator``) with 23 conditioning channels, over
   T = 2048 samples at B = 1 and 16: forced-mode logits, greedy samples
   against the argmax of the kernel's own forced logits, and a free run
   with the plain version's uniforms.  CUDA-event times of the kernel for
   1 s of audio (T = 16000) at B = 1, 16, 64 and 256; the plain version is
   timed at T = 2048 only.
8. The WaveNet vocoding path at full width: a port checkpoint in a
   temporary directory, then ``Synthesiser.run_r9y9wavenet_mulaw_world_
   feats_synth`` on ``cuda`` for the six fixture utterances' WORLD
   features (20 mcep + lf0 + vuv + bap, x80 to 16 kHz) in one padded
   batch, launch counters reset just before and read just after; six wav
   files of the right length, finite and not constant.  One utterance's
   first 800 samples in forced mode against the port's CPU path.
9. The trainer's evaluation and WORLD synthesis path.  (a) The one-shot
   MLPG kernel (K1) against its plain version on systems assembled on
   the card from seeded window means and variances, at T = 512 with
   L = 20 and 1 lanes, T = 2048 with L = 60 and T = 1, 2, 3 with L = 20;
   CUDA-event times beside the dense library solve (``torch.linalg.
   cholesky`` and ``torch.cholesky_solve`` on the (L, T, T) matrices).
   (b) Phase 6's trained ``AcousticModelTrainer`` on ``cuda``, launch
   counters reset just before and read just after: ``benchmark`` on the
   six utterances (four finite scores, K1 launched 3 x 6 times), the
   modular ``synth`` (six wav files of the right length, finite; 18 more
   K1 launches), the modular ``synth`` with the original spectrum and
   voicing (``synth_load_org_sp``/``_vuv``: six wav files, finite, not
   constant, peak above 1e-5; 18 more), ``copy_synth`` of two utterances
   (RMS > 0.01) and the fused ``synth`` (the same lengths; its PCM16
   difference to the modular synth is logged).  Against the port's CPU
   path from the same weights: the network output of the six utterances
   and, per utterance, the denormalised c0, voiced share and unvoiced
   frames' bap that decide how loud the 3-epoch model's synth is (and,
   on the card, its statics vocoded with bap 0 in the unvoiced frames,
   as WORLD does: peak above 1e-5); the MLPG post-processing of
   one utterance; ``BatchedWorldSynth`` of two; and the modular synth
   with the original sp and vuv rebuilt from its parts (against the
   written wavs, and card against CPU by frame energy).  Wall seconds of
   each call and of the modular path's parts.

The last three lines of standard output are the kernels JSON (every
kernel with its bound, its plain version's and the library call's time),
the ``nvidia-smi`` name/power-limit line and ``{"ok": true, "device": ...}``.
"""

import copy
import importlib.metadata
import json
import os
import shutil
import subprocess
import sys
import tempfile
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

# Training benchmark shapes (bench_training.py:35-114): bucket T, batches,
# question width; the full-width model's output width.
TRAIN_T = 1024
TRAIN_BATCHES = (8, 32)
TRAIN_D_IN, TRAIN_D_OUT = 409, 67
TRAIN_EPOCHS = 3

# Where each hand kernel comes from, for the kernels JSON line.  The
# projection kernel is the projection half of both _bilstm_layer_kernel
# (K6, :590) and _bilstm_layer_kernel_train (K7, :742); the training
# recurrence is _bilstm_kernel_train (K4) and the recurrence half of K7.
KERNEL_SOURCES = {
    "mlpg_oneshot": ("idiaptts_torch/csrc/mlpg_oneshot.cu",
                     "idiaptts_tpu/ops/pallas_mlpg.py:33"),
    "banded_solve": ("idiaptts_torch/csrc/banded_solve.cu",
                     "idiaptts_tpu/ops/pallas_mlpg.py:170"),
    "bilstm_recurrence": ("idiaptts_torch/csrc/bilstm_recurrence.cu",
                          "idiaptts_tpu/ops/pallas_lstm.py:76"),
    "bilstm_proj": ("idiaptts_torch/csrc/bilstm_proj.cu",
                    "idiaptts_tpu/ops/pallas_lstm.py:590"),
    "bilstm_recurrence_train": ("idiaptts_torch/csrc/bilstm_recurrence.cu",
                                "idiaptts_tpu/ops/pallas_lstm.py:161"),
    "bilstm_bwd": ("idiaptts_torch/csrc/bilstm_bwd.cu",
                   "idiaptts_tpu/ops/pallas_lstm.py:264"),
    "wavenet_sampler": ("idiaptts_torch/csrc/wavenet_sampler.cu",
                        "idiaptts_tpu/ops/pallas_wavenet.py:54"),
}
SERVE_KERNELS = ("banded_solve", "bilstm_proj", "bilstm_recurrence")
TRAIN_KERNELS = ("bilstm_proj", "bilstm_recurrence_train", "bilstm_bwd",
                 "bilstm_recurrence")
VOCODE_KERNELS = ("wavenet_sampler",)
EVAL_KERNELS = ("mlpg_oneshot", "bilstm_proj", "bilstm_recurrence")

# One-shot MLPG (K1) shapes (T, L): one fixture utterance's coded
# spectrum and lf0 at the serving bucket, the default 60 coefficients at
# the longest bucket, and the short-T edge cases.
MLPG_SHAPES = ((512, 20), (512, 1), (2048, 60), (1, 20), (2, 20), (3, 20))
# K1 vs its plain version, relative to the plain result's largest
# magnitude: the same float32 operations, FMA contraction aside, whose
# few ulps the system's conditioning amplifies.
MLPG_ONESHOT_TOL = 1e-5
# The MLPG post-processing of one utterance on the card against the CPU
# path, relative to each stream's largest magnitude: K1 against its
# plain version plus the on-device system assembly.
MLPG_STREAM_TOL = 1e-4
# The modular synth with the original sp and vuv on the card against the
# CPU path, by 5 ms frame energy with one noise draw: the predicted lf0
# and bap differ at bf16 scale.  Measured 1.6e-5 dB on an H100.
ORG_SP_VUV_DB_TOL = 0.05

# WaveNet vocoder at the production widths (WaveNetWrapper.Config
# defaults), conditioned on the fixture WORLD features (20 mcep + lf0 +
# vuv + bap = 23 channels) upsampled from 5 ms frames to 16 kHz.
WN_LAYERS = 20
WN_COND = 23
WN_HOP = FS // 200
WN_T_CHECK = 2048
WN_CHECK_BATCHES = (1, 16)
WN_T_TIME = FS                   # one second of audio
WN_TIME_BATCHES = (1, 16, 64, 256)
WN_T_CPU = 800
# Sampler kernel vs its plain version, relative to the logits' largest
# magnitude: bf16 operands and float32 sums in both, summed in other
# orders, so z (rounded to bf16) can land one bf16 ulp apart and move
# the later layers and logits; 4 bf16 ulps (2**-6).
WN_TOL = 2.0 ** -6
# The sampler (float32 sums) vs the teacher-forced parallel net, which
# rounds every layer's outputs and the running skip sum to bf16: one bf16
# rounding (2**-9 relative) per layer, relative to the logits' largest
# magnitude.
WN_NET_TOL = WN_LAYERS * 2.0 ** -9

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the least time the card could take for a kernel's work is the larger of
# its bytes over the HBM rate and its operations over the peak rate of
# their type.
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 operands
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Checks that failed; the script exits non-zero if any did.
FAILURES = []


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

def fail(message):
    """Record a failed check and go on, so one run shows every failure."""
    log("  FAIL:", message)
    FAILURES.append(message)


def _check(name, err, tol, what):
    log("  {:<18s} {:<34s} max|d| = {:.3e}  (tol {:.1e})".format(
        name, what, err, tol))
    if not err <= tol:
        fail("{} {}: max|d| {:.3e} > tol {:.1e}".format(name, what, err,
                                                         tol))


def bound(flops, flop_peak, nbytes):
    """(bound_ms, bound_by): the least time for ``flops`` operations at
    ``flop_peak`` and ``nbytes`` of HBM traffic, and which one sets it."""
    ops_ms = flops / flop_peak * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def lstm_bound(T, R, D, F, what, res_bytes=4):
    """Bound of one BiLSTM kernel's work over T steps of R rows (2*Bp):
    the bf16 products it needs and each input read and output written
    once.  ``what``: "proj" (bf16(x Wx) + b), "rec" (inference
    recurrence), "rec_train" (plus the gates and cells in
    ``res_bytes``-byte residuals), "bwd" (dz from the residuals, the
    upstream dL/dh and Wh)."""
    G = 4 * F
    if what == "proj":
        return bound(2.0 * T * R * D * G, PEAK_BF16_FLOPS,
                     T * R * D * 2 + 2 * D * G * 2 + 2 * G * 4
                     + T * R * G * 4)
    rec_flops = 2.0 * T * R * F * G
    wh_bytes = 2 * F * G * 2
    if what == "rec":
        return bound(rec_flops, PEAK_BF16_FLOPS,
                     T * R * G * 4 + wh_bytes + T * R * F * 4)
    if what == "rec_train":
        return bound(rec_flops, PEAK_BF16_FLOPS,
                     T * R * G * 4 + wh_bytes + T * R * F * 4
                     + T * R * (G + F) * res_bytes)
    if what == "bwd":
        return bound(rec_flops, PEAK_BF16_FLOPS,
                     T * R * (G + 2 * F) * res_bytes + wh_bytes
                     + T * R * G * 4)
    raise ValueError(what)


def cudnn_lstm(torch, D, F, device):
    """cuDNN's bidirectional LSTM in bf16 with the forget-gate bias +1
    folded into its bias: the library call that computes a BiLSTM layer
    (input projection included, as cuDNN always does).  Timed as a
    yardstick only; the port never calls it.  PyTorch keeps bf16 weights
    out of cuDNN's flat buffer, so each call also compacts them (12.6 MB
    at D=1024, F=512), inside the time taken."""
    lstm = torch.nn.LSTM(D, F, bidirectional=True).to(device,
                                                      torch.bfloat16)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            if name.startswith("bias_ih"):
                p[F:2 * F] += 1.0
            p.requires_grad_(False)
    lstm.flatten_parameters()
    return lstm


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
    results = {k: {} for k in SERVE_KERNELS}
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
        # Per element: forward and back substitution, 5 float32
        # operations each; b and three factor rows in, x out.
        bound_ms, bound_by = bound(10.0 * T * L, PEAK_F32_FLOPS,
                                   5 * T * L * 4)
        results["banded_solve"][B] = dict(
            shape="T={},L={}".format(T, L), max_abs_err=err,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
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
            fail("bilstm_proj products differ by more than rare one-ulp "
                 "bf16 rounding flips (B={})".format(B))
        # The bias is one float32 add, the same in both.
        if not torch.equal(xp_k, p_k + bias_rows):
            fail("bilstm_proj bias add differs (B={})".format(B))
        # Library yardstick: one bf16 batched GEMM over the directions.
        x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
            2, T * B, D).contiguous()
        results["bilstm_proj"][B] = dict(
            shape="T={},R={},D={},N={}".format(T, 2 * B, D, 4 * F),
            max_abs_err=diff.max().item(),
            library_ms=cuda_ms(torch, lambda: torch.bmm(x_dir, wx), 20),
            **dict(zip(("bound_ms", "bound_by"),
                       lstm_bound(T, 2 * B, D, F, "proj"))),
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
        lstm = cudnn_lstm(torch, D, F, device).eval()
        x_seq = xin[:, :B].contiguous()
        with torch.no_grad():
            lib_ms = cuda_ms(torch, lambda: lstm(x_seq), 5)
        results["bilstm_recurrence"][B] = dict(
            shape="T={},R={},F={}".format(T, 2 * B, F),
            max_abs_err=rec_err, library_ms=lib_ms,
            **dict(zip(("bound_ms", "bound_by"),
                       lstm_bound(T, 2 * B, D, F, "rec"))),
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


# -- phase 5 -----------------------------------------------------------------

def _rel(x, ref):
    """max|x - ref| over max(1, max|ref|)."""
    x, ref = x.float(), ref.float()
    return (x - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def train_kernel_checks(torch, device, T=TRAIN_T, batches=TRAIN_BATCHES,
                        D=D_IN, F=F_HIDDEN, reps=5):
    """The training kernels against their plain versions at the training
    benchmark's shapes.  Returns {kernel name: {B: measurements}} for the
    training recurrence, the backward and (at these shapes) the
    projection."""
    from idiaptts_torch.ops import cuda_lstm
    gen = torch.Generator(device=device).manual_seed(4321)
    G = 4 * F
    out = {"bilstm_recurrence_train": {}, "bilstm_bwd": {},
           "bilstm_proj": {}}
    lstm = cudnn_lstm(torch, D, F, device)
    for B in batches:
        R = 2 * B
        shape = "T={},R={},F={}".format(T, R, F)
        xin = torch.randn(T, R, D, generator=gen,
                          device=device).to(torch.bfloat16)
        wx = (torch.randn(2, D, G, generator=gen, device=device)
              / np.sqrt(D)).to(torch.bfloat16)
        bias = 0.1 * torch.randn(2, G, generator=gen, device=device)
        wh = (torch.randn(2 * F, G, generator=gen, device=device)
              / np.sqrt(F)).to(torch.bfloat16)
        xp = cuda_lstm.bilstm_projection_tmajor(xin, wx, bias)
        h_inf = cuda_lstm.bilstm_recurrence_tmajor(xp, wh)

        # K4: training recurrence.  h shares the inference kernel's
        # template body and float32 carries: bit-identical.  Gates and
        # cells against the plain version: the recurrence's tolerance
        # (float32 sums in another order, rare bf16 flips of h), plus one
        # bf16 ulp of a value in (-1, 1) for bf16 residuals; cells
        # relative to their largest magnitude.
        res = {}
        for res_bf16 in ((False, True) if B == batches[0] else (False,)):
            h, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh,
                                                               res_bf16)
            tag = "bf16 res" if res_bf16 else "f32 res"
            if not torch.equal(h, h_inf):
                fail("bilstm_recurrence_train h differs from the inference "
                     "kernel's h (B={}, {})".format(B, tag))
            else:
                log("  bilstm_recurrence_train B={} {}: h torch.equal to "
                    "bilstm_recurrence's h".format(B, tag))
            h_p, a_p, c_p = cuda_lstm.recurrence_train_tmajor_plain(
                xp, wh, res_bf16)
            tol = REC_TOL + (2.0 ** -8 if res_bf16 else 0.0)
            errs = {"h": (h - h_p).abs().max().item(),
                    "a": (a.float() - a_p.float()).abs().max().item(),
                    "c": _rel(c, c_p)}
            for k, e in errs.items():
                _check("rec_train " + k, e, tol, "{} {}".format(shape, tag))
            res[res_bf16] = (a, c, errs)
        a, c, errs = res[False]
        rb_ms = cuda_ms(torch, lambda: cuda_lstm
                        .bilstm_recurrence_train_tmajor(xp, wh), reps)
        lstm.train()
        x_seq = xin[:, :B].detach().contiguous().requires_grad_()
        lib_fwd = cuda_ms(torch, lambda: lstm(x_seq), reps)
        out["bilstm_recurrence_train"][B] = dict(
            shape=shape, max_abs_err=max(errs.values()), ms=rb_ms,
            plain_ms=cuda_ms(torch, lambda: cuda_lstm
                             .recurrence_train_tmajor_plain(xp, wh), 1),
            library_ms=lib_fwd,
            **dict(zip(("bound_ms", "bound_by"),
                       lstm_bound(T, R, D, F, "rec_train"))))

        # K5: reverse-time backward on the kernel's own residuals.  dz
        # feeds the next step rounded to bf16, so a rounding flip moves
        # dh by one bf16 ulp of dz times |w|; relative to dz's largest
        # entry.
        gout = 0.1 * torch.randn(T, R, F, generator=gen, device=device)
        bwd_errs = {}
        for res_bf16, (ra, rc, _) in res.items():
            dz = cuda_lstm.dz_bwd_tmajor(ra, rc, gout, wh)
            dz_p = cuda_lstm.dz_bwd_tmajor_plain(ra, rc, gout, wh)
            e = _rel(dz, dz_p)
            _check("bilstm_bwd dz", e, 1e-3, "{} {}".format(
                shape, "bf16 res" if res_bf16 else "f32 res"))
            bwd_errs[res_bf16] = (dz - dz_p).abs().max().item()
        y_seq, _ = lstm(x_seq)
        gy = torch.randn(y_seq.shape, generator=gen, device=device,
                         dtype=y_seq.dtype)
        out["bilstm_bwd"][B] = dict(
            shape=shape, max_abs_err=bwd_errs[False],
            ms=cuda_ms(torch, lambda: cuda_lstm.dz_bwd_tmajor(
                a, c, gout, wh), reps),
            plain_ms=cuda_ms(torch, lambda: cuda_lstm.dz_bwd_tmajor_plain(
                a, c, gout, wh), 1),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                y_seq, x_seq, gy, retain_graph=True), reps),
            **dict(zip(("bound_ms", "bound_by"),
                       lstm_bound(T, R, D, F, "bwd"))))
        if True in bwd_errs:
            out["bilstm_bwd"][B]["max_abs_err_bf16_residuals"] = \
                bwd_errs[True]
        del y_seq, x_seq

        # K7 = the projection kernel at these shapes, then K4.
        x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
            2, T * B, D).contiguous()
        out["bilstm_proj"][B] = dict(
            shape="T={},R={},D={},N={}".format(T, R, D, G),
            ms=cuda_ms(torch, lambda: cuda_lstm.bilstm_projection_tmajor(
                xin, wx, bias), 10),
            plain_ms=cuda_ms(torch, lambda: cuda_lstm
                             .projection_tmajor_plain(xin, wx, bias), 10),
            library_ms=cuda_ms(torch, lambda: torch.bmm(x_dir, wx), 10),
            **dict(zip(("bound_ms", "bound_by"),
                       lstm_bound(T, R, D, F, "proj"))))

        if B == batches[0]:
            layer_gradients(torch, xin, wx, wh, bias, gen)
        del xp, h_inf, res, a, c
    for name, by_b in out.items():
        for B, r in by_b.items():
            log("  {:<24s} B={:<3d} {:<24s} kernel {:9.4f} ms | plain "
                "{:9.4f} ms | library {:9.4f} ms | bound {:8.4f} ms ({})"
                .format(name, B, r["shape"], r["ms"], r["plain_ms"],
                        r["library_ms"], r["bound_ms"], r["bound_by"]))
    return out


def layer_gradients(torch, xin, wx, wh, bias, gen):
    """One layer's gradients through BiLSTMLayerFn (projection kernel,
    training recurrence, backward kernel, bf16 GEMMs) against autograd
    through the plain layer, for a random loss weighting of h.  Bound:
    2e-2 of each gradient's largest entry (bf16 operands in both; the
    plain path rounds in other places)."""
    from idiaptts_torch.ops import cuda_lstm
    T, R, _ = xin.shape
    F = wh.shape[0] // 2
    wgt = torch.randn(T, R, F, generator=gen, device=xin.device)
    args = (xin, wx.float(), wh.float(), bias)
    ours = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    (cuda_lstm.BiLSTMLayerFn.apply(*ours, False) * wgt).sum().backward()
    (cuda_lstm.scan_layer_tmajor(*plain) * wgt).sum().backward()
    for name, o, p in zip(("dxin", "dWx", "dWh", "db"), ours, plain):
        err = (o.grad.float() - p.grad.float()).abs().max().item() \
            / p.grad.float().abs().max().item()
        _check("layer grad " + name, err, 2e-2,
               "T={} R={} (relative to max)".format(T, R))


# -- phase 6 -----------------------------------------------------------------

def make_trainer(torch, device, workdir, epochs=TRAIN_EPOCHS):
    """AcousticModelTrainer on the fixture corpus with its default model,
    the full-width Interspeech'18 model."""
    from idiaptts_torch.train.acoustic import AcousticModelTrainer
    _, _, num_q = load_corpus()
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    hp = AcousticModelTrainer.create_hparams()
    hp.device = str(device)
    hp.num_questions = num_q
    hp.num_coded_sps = NUM_SPS
    hp.epochs = epochs
    hp.batch_size_train = 2
    hp.batch_size_val = 2
    hp.val_set_perc = 0.25
    hp.test_set_perc = 0.0
    hp.seed = 1
    hp.out_dir = workdir
    hp.model_name = "acoustic"
    trainer = AcousticModelTrainer(
        hp, ids, dir_question_labels=os.path.join(FIXTURES, "questions"),
        dir_world_features=os.path.join(FIXTURES, "WORLD"))
    trainer.init(hp)
    return trainer, hp


def check_training(torch, trainer, hp, train_loss, val_loss):
    """Loss finite and falling; the last checkpoint reloads to the same
    parameters."""
    from idiaptts_torch.train.handler import ModularModelHandler
    log("  train loss per epoch:", train_loss, "| validation:", val_loss)
    if not (np.all(np.isfinite(train_loss)) and np.all(np.isfinite(
            val_loss))):
        fail("non-finite training or validation loss")
    if not train_loss[-1] < train_loss[0]:
        fail("training loss did not fall: {}".format(train_loss))
    fresh = ModularModelHandler(device=trainer.model_handler.device)
    fresh.load_checkpoint(hp.out_dir, hp.model_name, last=True)
    ours = trainer.model_handler.model.state_dict()
    theirs = fresh.model.state_dict()
    same = sorted(ours) == sorted(theirs) and all(
        torch.equal(ours[k], theirs[k]) for k in ours)
    if not same:
        fail("checkpoint params_last does not reload to the same "
             "parameters")
    else:
        log("  checkpoint params_last reloads to the same {} tensors"
            .format(len(ours)))


def train_step_against_cpu(torch, trainer):
    """One training forward/backward on the card against the port's CPU
    path (plain versions) on one fixture utterance, from the same
    weights.  Loss within 1e-2 relative; each gradient within 2e-2 of
    its norm (bf16 operands on both sides, rounded in other places)."""
    from idiaptts_torch.data.dataset import collate_batch
    from idiaptts_torch.train.handler import ModularModelHandler
    card = trainer.model_handler
    cpu = ModularModelHandler(device="cpu")
    cpu.model = copy.deepcopy(card.model).to("cpu")
    cpu.losses = card.losses
    uid = trainer.id_list_train[0]
    batch = collate_batch([trainer.dataset_train.get_id_name(uid)[0]])
    totals, grads = [], []
    for h in (card, cpu):
        h.model.train()
        for p in h.model.parameters():
            p.grad = None
        data, lengths = h._batch_to_model_input(batch)
        total, _ = h._losses_total(h._apply_model(data, lengths, True), 0)
        total.backward()
        totals.append(total.item())
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in h.model.named_parameters()})
    T = batch["questions"].shape[1]
    _check("train step loss", abs(totals[0] - totals[1]) / abs(totals[1]),
           1e-2, "B=1 T={} (relative)".format(T))
    worst = max((torch.linalg.vector_norm(grads[0][n] - g)
                 / torch.linalg.vector_norm(g)).item()
                for n, g in grads[1].items())
    _check("train step grads", worst, 2e-2,
           "B=1 T={} (worst |dg|/|g|)".format(T))
    for p in card.model.parameters():
        p.grad = None


def fwd_flops_per_frame(D_in, D_out, F=F_HIDDEN):
    """bench_training.py:139-143: dense layers, three BiLSTMs (projection
    and recurrence per direction) and the FC head."""
    return (2 * (D_in * 1024 + 1024 * 1024)
            + 3 * 2 * (2 * 1024 * 4 * F + 2 * F * 4 * F)
            + 2 * 1024 * D_out)


def profile_step(torch, step, steps=2):
    """Device time per step by kernel name, from torch.profiler over
    ``steps`` steps; {} when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        if ms > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + ms
    return per_kernel


def time_train_step(torch, device, card, batches=TRAIN_BATCHES, T=TRAIN_T,
                    reps=5):
    """The handler's train step (forward, masked MSE, backward, global
    norm, Adam) at full width on seeded random data already on the card
    (set-up, as a data loader's prefetch would place it)."""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.handler import ModularModelHandler
    handler = ModularModelHandler(device=device)
    cfg = convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(TRAIN_D_OUT),
        TRAIN_D_IN)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    handler.create_model(cfg)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    handler.set_optimiser(hp)
    handler.set_losses([NamedLoss.Config(
        "mse", "MSELoss", ("pred", "target"), seq_mask="_seq_mask",
        reduction="mean_per_frame")])
    flops = 3 * fwd_flops_per_frame(TRAIN_D_IN, TRAIN_D_OUT)
    out = {}
    for B in batches:
        batch = {
            "questions": torch.from_numpy(np.random.RandomState(0).randn(
                B, T, TRAIN_D_IN).astype(np.float32)).to(device),
            "target": torch.from_numpy(np.random.RandomState(1).randn(
                B, T, TRAIN_D_OUT).astype(np.float32)).to(device),
            "_seq_mask": torch.ones(B, T, 1, device=device),
            "_lengths": {"questions": [T] * B}}

        def step():
            handler.process_batches([batch])

        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(torch, step, reps)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        fps = B * T / (ms / 1e3)
        kernels = profile_step(torch, step)
        busy = sum(kernels.values())
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
        # Demangled kernel names; the training recurrence is the
        # template instance with TRAIN = true.
        ours = {name: sum(v for n, v in kernels.items() if pattern in n)
                for name, pattern in (
                    ("bilstm_proj", "bilstm_proj_kernel"),
                    ("bilstm_recurrence_train",
                     "bilstm_recurrence_kernel<true"),
                    ("bilstm_bwd", "bilstm_bwd_kernel"))}
        out[B] = dict(T=T, step_ms=ms, frames_per_s=fps,
                      tflops_per_s=flops * fps / 1e12,
                      device_busy_ms=busy if kernels else None,
                      idle_share=1.0 - busy / ms if kernels else None,
                      port_kernels_ms=ours if kernels else None,
                      top_kernels_ms=top, peak_memory_gb=peak_gb)
        log("  train step B={} T={}: {:.3f} ms, {:.0f} frames/s, {:.2f} "
            "TFLOP/s, peak {:.1f} GB [{}]".format(
                B, T, ms, fps, out[B]["tflops_per_s"], peak_gb, card))
        if kernels:
            log("    device busy {:.3f} ms/step (idle {:.1%}); port "
                "kernels ms/step: {}".format(busy, 1.0 - busy / ms,
                                            json.dumps(ours)))
            for name, v in top.items():
                log("    {:9.3f} ms  {:5.1%}  {}".format(v, v / busy,
                                                        name[:100]))
        else:
            log("    torch.profiler recorded no device time: per-kernel "
                "ms not measured")
    return out


# -- phase 7 -----------------------------------------------------------------

def wavenet_model(torch, layers=WN_LAYERS, cond_channels=WN_COND, seed=0):
    """The WaveNet at the production widths (``WaveNetWrapper.Config``
    defaults) with random weights from a seeded generator, on the CPU."""
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                num_layers=layers, num_stacks=2,
                                cond_channels=cond_channels)
    return cfg.create_model(torch.Generator().manual_seed(seed)).eval()


def timed_once(torch, fn):
    """(fn(), CUDA-event milliseconds of that one call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wavenet_bound(w, T, B):
    """Bound of T sampling steps for B rows: the bf16 products (gate,
    skip/res and post1), post2's float32 products, and the weights read
    once with the conditioning, the uniforms and the samples."""
    R, Ca, S, C = w.R, w.Ca, w.S, w.C
    G = 2 * Ca
    L = len(w.dilations)
    bf16_ops = 2.0 * T * B * (L * (2 * R * G + C * G + Ca * (S + R))
                              + S * S)
    f32_ops = 2.0 * T * B * S * 256
    weight_bytes = sum(t.numel() * t.element_size() for t in (
        w.embed, w.w1, w.b1, w.w2, w.b2, w.p1, w.p1b, w.p2, w.p2b))
    nbytes = weight_bytes + T * B * C * 4 + 2 * T * B * 4
    ops_ms = max(bf16_ops / PEAK_BF16_FLOPS, f32_ops / PEAK_F32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def wavenet_kernel_checks(torch, device, layers=WN_LAYERS, T=WN_T_CHECK,
                          batches=WN_CHECK_BATCHES, t_time=WN_T_TIME,
                          time_batches=WN_TIME_BATCHES, reps=2):
    """The sampler kernel against its plain version over T steps at each
    of ``batches``, then the kernel's time for ``t_time`` steps at each
    of ``time_batches``.  Returns ({B: measurements at T}, {B: timing at
    t_time})."""
    from idiaptts_torch.ops import cuda_wavenet as cw
    w = wavenet_model(torch, layers).to(device).sampler().weights
    gen = torch.Generator(device=device).manual_seed(2024)
    out = {}
    for B in batches:
        shape = "T={},B={},L={},C={}".format(T, B, len(w.dilations), w.C)
        cond = 0.3 * torch.randn(T, B, w.C, generator=gen, device=device)
        teacher = torch.randint(0, 256, (T, B), generator=gen,
                                device=device, dtype=torch.int32)
        u = torch.rand(T, B, generator=gen, device=device)

        # Forced mode: the logits for a random teacher signal.
        _, lk = cw.sample(w, cond, forced=teacher, want_logits=True)
        _, lp = cw.sample_plain(w, cond, forced=teacher, want_logits=True)
        scale = lp.abs().max().item()
        err = (lk - lp).abs().max().item()
        _check("wavenet_sampler", err / scale, WN_TOL,
               "forced logits {} (rel)".format(shape))

        # Greedy: each sample is the first argmax of the logits the kernel
        # gives for that history in forced mode.
        greedy, _ = cw.sample(w, cond, temperature=0.0)
        _, lg = cw.sample(w, cond, forced=greedy, want_logits=True)
        if not torch.equal(greedy.long(), torch.argmax(lg, dim=-1)):
            fail("wavenet_sampler greedy samples are not the argmax of its "
                 "forced logits ({})".format(shape))
        else:
            log("  wavenet_sampler    greedy {}: every sample is the argmax "
                "of the kernel's forced logits".format(shape))

        # Free run, the same uniforms in both.  A draw may differ only
        # where U lies near a CDF boundary: logits that differ by at most
        # d move each boundary by less than exp(2 d) - 1 in probability.
        sk, _ = cw.sample(w, cond, uniforms=u)
        sp, plain_ms = timed_once(torch, lambda: cw.sample_plain(
            w, cond, uniforms=u)[0])
        ms = cuda_ms(torch, lambda: cw.sample(w, cond, uniforms=u), 3)
        _, lk_hist = cw.sample(w, cond, forced=sk, want_logits=True)
        _, lp_hist = cw.sample_plain(w, cond, forced=sk, want_logits=True)
        d_hist = (lk_hist - lp_hist).abs().max().item()
        _check("wavenet_sampler", d_hist / scale, WN_TOL,
               "logits on the free run {} (rel)".format(shape))
        tie = float(np.expm1(2.0 * max(d_hist, 1e-6)))
        flat = lp_hist.reshape(T * B, -1)
        redraw = cw.draw(flat, u.reshape(-1), 1.0, w.out_channels
                         ).reshape(T, B)
        margin = cw.cdf_margin(flat, u.reshape(-1)).reshape(T, B)
        off = sk != redraw
        worst = margin[off].max().item() if off.any() else 0.0
        same_rows = int((sk == sp).all(dim=0).sum().item())
        first = [int(torch.nonzero(sk[:, b] != sp[:, b])[0])
                 for b in range(B) if not torch.equal(sk[:, b], sp[:, b])]
        log("  wavenet_sampler    free run {}: {}/{} rows identical to the "
            "plain run (first divergence at steps {}); {} of {} kernel draws "
            "differ from the plain draw on the same history, largest CDF "
            "margin among them {:.3e} (tol {:.3e}); smallest margin over "
            "all draws {:.3e}; {} distinct classes".format(
                shape, same_rows, B, first, int(off.sum()), T * B, worst,
                tie, margin.min().item(), len(torch.unique(sk))))
        if worst > tie:
            fail("wavenet_sampler free run {}: a draw differs from the plain "
                 "draw at CDF margin {:.3e} > {:.3e}".format(shape, worst,
                                                             tie))
        if len(torch.unique(sk)) < 16:
            fail("wavenet_sampler free run {}: only {} distinct classes"
                 .format(shape, len(torch.unique(sk))))
        bound_ms, bound_by = wavenet_bound(w, T, B)
        out[B] = dict(shape=shape, max_abs_err=err, logits_scale=scale,
                      ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None,
                      free_run_rows_identical=same_rows,
                      free_run_draws_off=int(off.sum()),
                      free_run_worst_margin=worst)
        log("  wavenet_sampler    {}: kernel {:.3f} ms ({:.2f} us/step) | "
            "plain {:.1f} ms ({:.3f} ms/step) | bound {:.5f} ms ({})".format(
                shape, ms, ms * 1e3 / T, plain_ms, plain_ms / T, bound_ms,
                bound_by))
        del lk, lp, lg, lk_hist, lp_hist

    timing = {}
    for B in time_batches:
        cond = 0.3 * torch.randn(t_time, B, w.C, generator=gen,
                                 device=device)
        u = torch.rand(t_time, B, generator=gen, device=device)
        ms = cuda_ms(torch, lambda: cw.sample(w, cond, uniforms=u), reps)
        bound_ms, bound_by = wavenet_bound(w, t_time, B)
        audio_s = B * t_time / FS
        timing[B] = dict(T=t_time, ms=ms, us_per_step=ms * 1e3 / t_time,
                         xrt=audio_s / (ms / 1e3), bound_ms=bound_ms,
                         bound_by=bound_by)
        log("  wavenet_sampler    T={} B={:<3d}: {:9.3f} ms = {:.2f} us/step"
            " = {:.1f}x realtime | bound {:.5f} ms ({}) [plain version not "
            "timed at this T]".format(t_time, B, ms, ms * 1e3 / t_time,
                                      timing[B]["xrt"], bound_ms, bound_by))
        del cond, u
    return out, timing


# -- phase 8 -----------------------------------------------------------------

def write_wavenet_checkpoint(torch, model, directory):
    """config.json and params_last in the port's checkpoint format."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(model.config.to_json())
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           model.state_dict().items()}},
               os.path.join(directory, "params_last"))


def fixture_world_features():
    """{id: (frames, 23)} WORLD features of the fixture utterances, read
    with the port's reader."""
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    return {i: WorldFeatLabelGen.load_sample(
        i, os.path.join(FIXTURES, "WORLD"), num_coded_sps=NUM_SPS)
        for i in ids}


def vocode(torch, device, workdir, model, feats):
    """The Synthesiser's WaveNet backend on ``device`` for every utterance
    of ``feats``; returns (launches, stats)."""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.ops import audio_io, dispatch
    from idiaptts_torch.synth.synthesiser import Synthesiser
    ckpt = os.path.join(workdir, "wavenet")
    write_wavenet_checkpoint(torch, model, ckpt)
    hp = ExtendedHParams.create_hparams()
    hp.device = str(device)
    hp.add_hparams(synth_vocoder_path=ckpt)
    hp.synth_dir = os.path.join(workdir, "synth")
    hp.synth_fs = FS
    hp.num_coded_sps = NUM_SPS
    dispatch.reset_counts()
    t0 = time.perf_counter()
    paths = Synthesiser.run_r9y9wavenet_mulaw_world_feats_synth(feats, hp)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dispatch.counts()
    log("  launches during vocoding:", json.dumps(launches))
    require_launches(launches, VOCODE_KERNELS, "vocoding")
    if sorted(paths) != sorted(feats):
        fail("vocoding wrote {} files for {} utterances".format(
            len(paths), len(feats)))
    for name, f in feats.items():
        raw, fs = audio_io.get_raw(paths[name])
        want = len(f) * WN_HOP
        ok = (fs == FS and raw.shape == (want,)
              and np.all(np.isfinite(raw)) and np.abs(raw).max() <= 1.0
              and np.ptp(raw) > 0)
        log("  {}: {} frames -> {} samples at {} Hz, peak {:.4f}, {} "
            "distinct values".format(name, len(f), raw.size, fs,
                                     float(np.abs(raw).max()),
                                     len(np.unique(raw))))
        if not ok:
            fail("vocoding {}: want {} finite, non-constant samples in "
                 "[-1, 1] at {} Hz".format(name, want, FS))
    frames = [len(f) for f in feats.values()]
    audio_s = sum(frames) * WN_HOP / FS
    stats = dict(batch=len(frames), T=max(frames) * WN_HOP,
                 audio_s=audio_s, wall_s=wall_s, xrt=audio_s / wall_s)
    log("  vocoded {} utterances ({:.2f} s of audio, padded T={}) in "
        "{:.3f} s wall (checkpoint load, packing, one sampler launch, wav "
        "writes) = {:.2f}x realtime".format(len(frames), audio_s, stats["T"],
                                           wall_s, stats["xrt"]))
    return launches, stats


def vocode_against_cpu(torch, device, model, feats, T=WN_T_CPU):
    """One utterance's first T samples in forced mode, with the teacher
    drawn on the card: the card's sampler logits against the port's CPU
    path (the plain sampler) and against the teacher-forced parallel net
    on the CPU."""
    from idiaptts_torch.ops.interpolation import sample_linearly
    cond = torch.from_numpy(sample_linearly(feats, WN_HOP)[:T])[None]
    card = copy.deepcopy(model).to(device)
    teacher, _ = card.sampler()(cond.to(device), generator=torch.Generator(
        device=device).manual_seed(3))
    _, lk = card.sampler()(cond.to(device), forced=teacher)
    cpu = copy.deepcopy(model).to("cpu")
    _, lc = cpu.sampler()(cond, forced=teacher.cpu())
    with torch.no_grad():
        net = cpu({"cond": cond, "target_quantised": teacher.cpu()})["logits"]
    scale = lc.abs().max().item()
    _check("vocode forced", (lk.cpu() - lc).abs().max().item() / scale,
           WN_TOL, "card vs CPU sampler, B=1 T={} (rel)".format(T))
    _check("vocode forced", (lk.cpu() - net).abs().max().item() / scale,
           WN_NET_TOL, "card vs CPU parallel net, T={} (rel)".format(T))


# -- phase 9 -----------------------------------------------------------------

def mlpg_system(torch, device, T, L, seed):
    """A one-shot MLPG system (b, ab0, ab1, ab2), each (T, L), assembled
    on ``device`` by the port's ``_banded_system`` from seeded window
    means and variances, as ``mlpg_torch`` assembles it."""
    from idiaptts_torch.ops import mlpg
    rs = np.random.RandomState(seed)
    var = mlpg._boundary_variances(
        (rs.rand(3 * L) * 0.5 + 0.05).astype(np.float32), L, T).to(device)
    feats = torch.from_numpy(rs.randn(T, 3, L).astype(np.float32)).to(device)
    bands, b = mlpg._banded_system(feats, var)
    return [b.contiguous()] + [a.contiguous() for a in bands]


def dense_spd(torch, ab0, ab1, ab2):
    """The (L, T, T) symmetric matrices of the lower-banded rows."""
    T = ab0.shape[0]
    a = torch.diag_embed(ab0.t())
    for k, band in ((1, ab1), (2, ab2)):
        if T > k:
            off = torch.diag_embed(band[:T - k].t(), offset=-k)
            a = a + off + off.transpose(1, 2)
    return a


def mlpg_kernel_checks(torch, device, shapes=MLPG_SHAPES, reps=20):
    """K1 against its plain version at each (T, L) of ``shapes``, with
    CUDA-event times of the kernel, the plain version and the dense
    library solve.  Returns {(T, L): measurements}."""
    from idiaptts_torch.ops import cuda_mlpg
    out = {}
    for seed, (T, L) in enumerate(shapes):
        args = mlpg_system(torch, device, T, L, seed)
        x_k = cuda_mlpg.mlpg_oneshot(*args)
        x_p = cuda_mlpg.mlpg_oneshot_plain(*args)
        scale = x_p.abs().max().item()
        err = (x_k - x_p).abs().max().item()
        _check("mlpg_oneshot", err / scale, MLPG_ONESHOT_TOL,
               "T={} L={} (rel)".format(T, L))
        # Library yardstick: dense Cholesky and solve, O(T^3) per lane.
        a = dense_spd(torch, *args[1:])
        rhs = args[0].t().unsqueeze(-1).contiguous()

        def library():
            chol, _ = torch.linalg.cholesky_ex(a)
            return torch.cholesky_solve(rhs, chol)

        lib_x = library().squeeze(-1).t()
        lib_err = (lib_x - x_p).abs().max().item() / scale
        # Four (T, L) float32 inputs read once and the output written
        # once; the kernel also writes and reads back a (4, T, L)
        # scratch.  About 20 float32 operations per element.
        bound_ms, bound_by = bound(20.0 * T * L, PEAK_F32_FLOPS,
                                   5 * T * L * 4)
        out[(T, L)] = dict(
            shape="T={},L={}".format(T, L), max_abs_err=err,
            max_rel_err=err / scale, bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_with_scratch=bound(20.0 * T * L, PEAK_F32_FLOPS,
                                        13 * T * L * 4)[0],
            ms=cuda_ms(torch, lambda: cuda_mlpg.mlpg_oneshot(*args), reps),
            plain_ms=cuda_ms(torch, lambda: cuda_mlpg.mlpg_oneshot_plain(
                *args), 1),
            library_ms=cuda_ms(torch, library, 3),
            library_rel_err=lib_err,
            library="dense torch.linalg.cholesky_ex + torch.cholesky_solve "
                    "on (L, T, T) float32, O(T^3)")
        r = out[(T, L)]
        log("  mlpg_oneshot       T={:<5d} L={:<3d} kernel {:9.4f} ms "
            "({:.3f} us/step) | plain {:9.3f} ms | library {:9.4f} ms "
            "(rel err {:.1e}) | bound {:.6f} ms ({})".format(
                T, L, r["ms"], r["ms"] * 1e3 / (2 * T), r["plain_ms"],
                r["library_ms"], lib_err, bound_ms, bound_by))
        del a, rhs
    return out


def _wav_ok(path, frames):
    """(samples, ok): a 16 kHz wav of 80 samples a frame, finite."""
    from idiaptts_torch.ops import audio_io
    raw, fs = audio_io.get_raw(path)
    return raw, (fs == FS and raw.shape == (frames * 80,)
                 and bool(np.all(np.isfinite(raw))))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def evaluate(torch, device, trainer, hp, workdir, org_feats):
    """benchmark, modular synth (predicted streams, then the original
    spectrum and voicing), copy_synth and fused synth of phase 6's
    trained model on ``device``, with the launch counters reset just
    before and read just after; then the card against the CPU path and
    the modular path's parts timed.  Returns (launches, stats)."""
    from idiaptts_torch.ops import dispatch
    ids = sorted(org_feats)
    frames = {i: len(f) for i, f in org_feats.items()}
    hp.batch_size_benchmark = len(ids)
    hp.batch_size_synth = len(ids)
    stats, paths, k1 = {}, {}, []
    dispatch.reset_counts()
    scores, stats["benchmark_s"] = _timed(
        torch, lambda: trainer.benchmark(hp, ids))
    k1.append(dispatch.counts()["mlpg_oneshot"])
    hp.use_fused_synth = False
    hp.synth_dir = os.path.join(workdir, "synth_modular")
    paths["modular"], stats["modular_synth_s"] = _timed(
        torch, lambda: trainer.synth(hp, ids))
    k1.append(dispatch.counts()["mlpg_oneshot"] - sum(k1))
    # The same path with the original spectrum and voicing: audible
    # whatever the 3-epoch model predicts, with its pitch and
    # aperiodicity.
    hp.synth_dir = os.path.join(workdir, "synth_org_sp_vuv")
    hp.synth_load_org_sp = hp.synth_load_org_vuv = True
    try:
        paths["org_sp_vuv"], stats["org_sp_vuv_synth_s"] = _timed(
            torch, lambda: trainer.synth(hp, ids))
    finally:
        hp.synth_load_org_sp = hp.synth_load_org_vuv = False
    k1.append(dispatch.counts()["mlpg_oneshot"] - sum(k1))
    hp.synth_dir = os.path.join(workdir, "copy_synth")
    paths["copy"], stats["copy_synth_s"] = _timed(
        torch, lambda: trainer.copy_synth(hp, ids[:2]))
    hp.use_fused_synth = True
    hp.synth_dir = os.path.join(workdir, "synth_fused")
    paths["fused"], stats["fused_synth_s"] = _timed(
        torch, lambda: trainer.synth(hp, ids))
    launches = dispatch.counts()
    k1.append(launches["mlpg_oneshot"] - sum(k1))
    log("  launches during evaluation:", json.dumps(launches))
    require_launches(launches, EVAL_KERNELS, "evaluation")
    stats["scores"] = dict(zip(hp.metrics, (float(v) for v in scores)))
    log("  benchmark scores:", json.dumps(stats["scores"]))
    if not (len(scores) == 4 and np.all(np.isfinite(scores))):
        fail("benchmark gave {} (want four finite scores)".format(scores))
    log("  mlpg_oneshot launches: benchmark {}, modular synth {}, modular "
        "synth with original sp and vuv {}, copy and fused synth {}"
        .format(*k1))
    n = 3 * len(ids)
    if k1 != [n, n, n, 0]:
        fail("mlpg_oneshot launches {} != [{n}, {n}, {n}, 0] (3 per "
             "utterance per call)".format(k1, n=n))
    wavs = {}
    for kind, by_id in paths.items():
        want = ids[:2] if kind == "copy" else ids
        if sorted(by_id) != want:
            fail("{} synth wrote {} for {}".format(kind, sorted(by_id), want))
            continue
        for i in want:
            raw, ok = _wav_ok(by_id[i], frames[i])
            wavs[kind, i] = raw
            rms = float(np.sqrt(np.mean(raw.astype(np.float64) ** 2)))
            peak = float(np.abs(raw).max())
            log("  {} synth {}: {} samples, rms {:.3e}, peak {:.3e}".format(
                kind, i, raw.size, rms, peak))
            if not ok:
                fail("{} synth {}: want {} finite samples at {} Hz".format(
                    kind, i, frames[i] * 80, FS))
            if kind == "copy" and not rms > 0.01:
                fail("copy_synth {}: rms {} <= 0.01".format(i, rms))
            if kind == "org_sp_vuv" and not (peak > 1e-5
                                             and np.ptp(raw) > 0):
                fail("modular synth with the original sp and vuv {}: "
                     "constant or peak {} <= 1e-5".format(i, peak))
    # Fused and modular synth share the model output and the noise seed;
    # they differ by the MLPG solve (K2 over the padded bucket, K1 per
    # utterance), within PCM16 rounding.
    stats["fused_vs_modular_lsb"] = {
        i: int(np.abs(np.round((wavs["fused", i] - wavs["modular", i])
                               * 32768.0)).max())
        for i in ids if ("fused", i) in wavs and ("modular", i) in wavs}
    log("  fused vs modular synth, max |d| in PCM16 steps:",
        json.dumps(stats["fused_vs_modular_lsb"]))
    parts, post = modular_parts_s(torch, trainer, hp, ids, workdir)
    stats.update(parts)
    stats.update(evaluate_against_cpu(torch, trainer, hp, ids, org_feats,
                                      post, wavs))
    audio_s = sum(frames.values()) * 80 / FS
    stats["audio_s"] = audio_s
    log("  wall s for {} utterances ({:.2f} s of audio): benchmark {:.3f}, "
        "modular synth {:.3f} (original sp and vuv {:.3f}), fused synth "
        "{:.3f}, copy_synth(2) {:.3f}".format(
            len(ids), audio_s, stats["benchmark_s"],
            stats["modular_synth_s"], stats["org_sp_vuv_synth_s"],
            stats["fused_synth_s"], stats["copy_synth_s"]))
    return launches, stats


def modular_parts_s(torch, trainer, hp, ids, workdir):
    """The modular synth's parts, timed one after another on the host
    clock: forward (batched inference), MLPG post-processing (three
    solves and host round trips per utterance), vocoder
    (``BatchedWorldSynth``) and wav writes.  Checks that the vocoder's
    float waveforms are finite and not constant.  Returns ({part: s},
    {id: post-processed statics})."""
    from idiaptts_torch.ops import audio_io
    from idiaptts_torch.synth.synthesiser import Synthesiser
    results, fwd_s = _timed(torch, lambda: trainer._forward_batched(
        hp, ids, len(ids), post_process=False, input_only=True))
    post, post_s = _timed(torch, lambda: {
        i: trainer._postprocess_sample(s) for i, s in results.items()})
    synth = Synthesiser._batched_world_synth(
        NUM_SPS, FS, hp.get("frame_size_ms", 5), hp.get("num_bap", 1),
        False, None, hp.device)
    feats = [np.asarray(post[i]["pred_acoustic_features"], np.float32)
             for i in ids]
    wavs, voc_s = _timed(torch, lambda: synth(feats))
    for i, w in zip(ids, wavs):
        if not (np.all(np.isfinite(w)) and np.ptp(w) > 0):
            fail("modular synth {}: vocoder output not finite or constant"
                 .format(i))
    log("  modular synth vocoder peaks:", ", ".join(
        "{:.3e}".format(float(np.abs(w).max())) for w in wavs))
    out_dir = os.path.join(workdir, "parts")

    def write():
        for i, w in zip(ids, wavs):
            audio_io.raw_to_file(os.path.join(out_dir, i + ".wav"), w, FS)

    _, write_s = _timed(torch, write)
    parts = dict(modular_forward_s=fwd_s, modular_postprocess_mlpg_s=post_s,
                 modular_vocoder_s=voc_s, modular_wav_write_s=write_s)
    log("  modular synth parts (s):", json.dumps(parts))
    return parts, {i: post[i]["pred_acoustic_features"] for i in ids}


def cpu_trainer(trainer):
    """A shallow copy of ``trainer`` whose model and readers are on the
    CPU: the port's CPU path (plain versions) from the same weights."""
    from idiaptts_torch.train.handler import ModularModelHandler
    card = trainer.model_handler
    handler = ModularModelHandler(device="cpu")
    handler.model = copy.deepcopy(card.model).to("cpu")
    handler.model_config = card.model_config
    handler.losses = card.losses
    cpu = copy.copy(trainer)
    cpu.model_handler = handler
    cpu.datareaders = {}
    for name, reader in trainer.datareaders.items():
        reader = copy.copy(reader)
        if hasattr(reader, "device"):
            reader.device = "cpu"
        cpu.datareaders[name] = reader
    return cpu


def _witness(feats):
    """(c0 mean, c0 max, voiced share, mean bap of the unvoiced frames) of
    [coded_sp | lf0 | vuv | bap]."""
    unvoiced = feats[:, NUM_SPS + 1] < 0.5
    return (float(feats[:, 0].mean()), float(feats[:, 0].max()),
            float(feats[:, NUM_SPS + 1].mean()),
            float(feats[unvoiced, NUM_SPS + 2].mean()) if unvoiced.any()
            else 0.0)


def _unvoiced_full_noise(feats):
    """Statics with bap 0 (aperiodicity 1) in the unvoiced frames, as
    WORLD synthesises unvoiced frames; BatchedWorldSynth, like the JAX
    package's, scales their noise by the decoded bap."""
    out = np.array(feats, np.float32, copy=True)
    out[out[:, NUM_SPS + 1] < 0.5, NUM_SPS + 2] = 0.0
    return out


def _with_org_sp_vuv(feats, org):
    """Predicted statics with the original spectrum and voicing, as
    ``gen_waveform`` assembles them for ``synth_load_org_sp/_vuv``."""
    out = np.array(feats, np.float32, copy=True)
    n = min(len(org), len(out))
    out[:n, :NUM_SPS] = org[:n, :NUM_SPS]
    out[:n, NUM_SPS + 1] = org[:n, NUM_SPS + 1]
    return out


def _max_frame_db(wavs_a, wavs_b):
    """Largest 5 ms frame-energy difference over the frames within 60 dB
    of each reference utterance's loudest."""
    db = 0.0
    for a, b in zip(wavs_a, wavs_b):
        d_a, d_b = _frame_db(a), _frame_db(b)
        loud = d_b > d_b.max() - 60.0
        db = max(db, float(np.abs(d_a[loud] - d_b[loud]).max()))
    return db


def evaluate_against_cpu(torch, trainer, hp, ids, org_feats, post, wavs):
    """The evaluation path on the card against the port's CPU path from
    the same weights: the network output of all six utterances in one
    padded batch (and, per utterance, the denormalised c0, voiced share
    and unvoiced bap that decide how loud the synth is, ROADMAP fault
    3.7, with the statics vocoded on the card without that bap); one
    utterance's output
    post-processed by the card's reader and by a CPU reader (MLPG per
    stream); BatchedWorldSynth of two utterances' original features with
    one noise draw, by 5 ms frame energy (the harmonic phase drifts by
    summation order, ROADMAP fault 3.5); and the modular synth with the
    original sp and vuv, rebuilt from its parts on the card (against the
    written wavs) and on the CPU (frame energy, one noise draw)."""
    from idiaptts_torch.ops.world.synthesis import noise_draw
    from idiaptts_torch.synth.pipeline import BatchedWorldSynth
    from idiaptts_torch.ops.audio_io import float_to_pcm16
    from idiaptts_torch.synth.synthesiser import _norm_loudness
    cpu = cpu_trainer(trainer)
    raw_card = trainer._forward_batched(hp, ids, len(ids),
                                        post_process=False, input_only=True)
    raw_cpu = cpu._forward_batched(hp, ids, len(ids), post_process=False,
                                   input_only=True)
    model_rel = max(
        float(np.abs(raw_card[i]["pred_acoustic_features"]
                     - raw_cpu[i]["pred_acoustic_features"]).max()
              / np.abs(raw_cpu[i]["pred_acoustic_features"]).max())
        for i in ids)
    # The FC output is bf16: 4 bf16 ulps at the output's magnitude.
    _check("forward", model_rel, 2.0 ** -6,
           "{} utts, one padded batch, card vs CPU (rel)".format(len(ids)))
    post_cpu = {i: cpu._postprocess_sample(raw_cpu[i])[
        "pred_acoustic_features"] for i in ids}
    witness = {}
    for i in ids:
        card_w, cpu_w = _witness(post[i]), _witness(post_cpu[i])
        org_w = _witness(org_feats[i])
        witness[i] = dict(card=card_w, cpu=cpu_w, org=org_w, peak=float(
            np.abs(wavs["modular", i]).max()) if ("modular", i) in wavs
            else None)
        log("  {} c0 mean/max, voiced share, unvoiced bap: card {:.2f}/"
            "{:.2f}, {:.3f}, {:.2f} | CPU {:.2f}/{:.2f}, {:.3f}, {:.2f} | "
            "original {:.2f}/{:.2f}, {:.3f}, {:.2f} | modular synth peak "
            "{:.3e}".format(i, *card_w, *cpu_w, *org_w,
                            witness[i]["peak"] or 0.0))
        # Voicing is a decision at 0.5: a prediction within bf16 noise of
        # it may flip.
        if abs(card_w[2] - cpu_w[2]) > 0.01:
            fail("{}: voiced share {} on the card, {} on the CPU".format(
                i, card_w[2], cpu_w[2]))
    c0_abs = max(float(np.abs(post[i][:, 0] - post_cpu[i][:, 0]).max())
                 for i in ids)
    log("  post-processed c0 card vs CPU: max|d| {:.3e}".format(c0_abs))
    # The cause of the silent files, on the card: the same statics with
    # the unvoiced frames' noise unscaled by their predicted bap.
    synth_card = BatchedWorldSynth(NUM_SPS, FS, device=hp.device)
    synth_cpu = BatchedWorldSynth(NUM_SPS, FS, device="cpu")
    full_noise = [float(np.abs(w).max()) for w in synth_card(
        [_unvoiced_full_noise(post[i]) for i in ids])]
    log("  vocoder peaks of the predicted statics with bap 0 in unvoiced "
        "frames:", ", ".join("{:.3e}".format(p) for p in full_noise))
    if not min(full_noise) > 1e-5:
        fail("predicted statics with bap 0 in unvoiced frames: peaks {}"
             .format(full_noise))

    reader = trainer.datareaders["cmp_features"]
    out = np.asarray(raw_card[ids[0]]["pred_acoustic_features"])
    card = reader.postprocess_sample(out)
    one = cpu.datareaders["cmp_features"].postprocess_sample(out)
    errs = {}
    for name, cols in (("sp", slice(0, NUM_SPS)),
                       ("lf0", slice(NUM_SPS, NUM_SPS + 1)),
                       ("bap", slice(NUM_SPS + 2, NUM_SPS + 3))):
        errs[name] = float(np.abs(card[:, cols] - one[:, cols]).max()
                           / np.abs(one[:, cols]).max())
        _check("mlpg " + name, errs[name], MLPG_STREAM_TOL,
               "{} T={} card vs CPU (rel)".format(ids[0], len(out)))
    if not np.array_equal(card[:, NUM_SPS + 1], one[:, NUM_SPS + 1]):
        fail("post-processed voicing differs between card and CPU")

    feats = [np.asarray(org_feats[i], np.float32) for i in ids[:2]]
    T = int(np.ceil(max(len(f) for f in feats) / 256) * 256)
    z = noise_draw(T, 129, torch.Generator().manual_seed(11), "cpu")
    w_card, w_cpu = synth_card(feats, z=z), synth_cpu(feats, z=z)
    db = _max_frame_db(w_card, w_cpu)
    _check("world synth", db, 0.05, "2 utts card vs CPU (frame dB)")
    head = float(max(np.abs(a[:64 * 80] - b[:64 * 80]).max()
                     / np.abs(b).max() for a, b in zip(w_card, w_cpu)))
    log("  world synth first 64 frames card vs CPU: max|d| {:.3e} of peak"
        .format(head))

    org_card = [_with_org_sp_vuv(post[i], org_feats[i]) for i in ids]
    org_cpu = [_with_org_sp_vuv(post_cpu[i], org_feats[i]) for i in ids]
    # The trainer's modular synth draws its noise from seed 0 on the
    # card: its parts, rebuilt here, give the wavs it wrote.
    rebuilt = synth_card(org_card)
    lsb = max(int(np.abs(
        float_to_pcm16(_norm_loudness(w)).astype(np.int64)
        - np.round(wavs["org_sp_vuv", i] * 32768.0).astype(np.int64)).max())
        for i, w in zip(ids, rebuilt) if ("org_sp_vuv", i) in wavs)
    _check("synth org sp+vuv", lsb, 1, "{} utts written wavs vs parts on "
           "the card (PCM16 steps)".format(len(ids)))
    T = int(np.ceil(max(len(f) for f in org_card) / 256) * 256)
    z = noise_draw(T, 129, torch.Generator().manual_seed(13), "cpu")
    org_db = _max_frame_db(synth_card(org_card, z=z),
                           synth_cpu(org_cpu, z=z))
    _check("synth org sp+vuv", org_db, ORG_SP_VUV_DB_TOL,
           "{} utts card vs CPU (frame dB)".format(len(ids)))
    return dict(forward_card_vs_cpu_rel=model_rel,
                c0_card_vs_cpu_abs=c0_abs, witness=witness,
                unvoiced_full_noise_peaks=full_noise,
                mlpg_card_vs_cpu_rel=errs, world_synth_card_vs_cpu_db=db,
                world_synth_head_rel=head, org_sp_vuv_parts_lsb=lsb,
                org_sp_vuv_card_vs_cpu_db=org_db)


def require_launches(launches, names, path):
    """Every kernel of a path must have launched during its run."""
    missing = [k for k in names if launches.get(k, 0) < 1]
    if missing:
        fail("kernels not launched on the {} path: {}".format(
            path, ", ".join(missing)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import (cuda_lstm, cuda_mlpg,  # noqa: F401
                                    cuda_wavenet, dispatch)

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
    serve_launches = dispatch.counts()
    log("  launches during the served run:", json.dumps(serve_launches))
    log("  server stats:", json.dumps(stats))
    require_launches(serve_launches, SERVE_KERNELS, "serving")
    check_waveforms(wavs, questions, pipeline.hop)
    check_against_cpu(torch, pipeline, make_pipeline("cpu"), model,
                      questions)
    timing = time_slice(torch, pipeline, model, questions, card)
    log("  slice timing:", json.dumps({str(k): v for k, v in
                                        timing.items()}))
    del pipeline, model

    log("== phase 5: training kernels against their plain versions, T={} "
        "D={} F={} [{}]".format(TRAIN_T, D_IN, F_HIDDEN, card))
    tres = train_kernel_checks(torch, device)
    torch.cuda.empty_cache()

    log("== phase 6: AcousticModelTrainer at full width on {} ({} epochs, "
        "batch 2, 25% validation)".format(device, TRAIN_EPOCHS))
    # The trained model and its workdir serve phase 9 too.
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _phases_6_to_9(torch, device, card, workdir, kres, tres,
                              serve_launches)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _phases_6_to_9(torch, device, card, workdir, kres, tres,
                   serve_launches):
    from idiaptts_torch.ops import dispatch
    trainer, hp = make_trainer(torch, device, workdir)
    dispatch.reset_counts()
    val_loss, train_loss = trainer.train(hp)
    torch.cuda.synchronize()
    train_launches = dispatch.counts()
    log("  launches during training:", json.dumps(train_launches))
    require_launches(train_launches, TRAIN_KERNELS, "training")
    check_training(torch, trainer, hp, train_loss, val_loss)
    train_step_against_cpu(torch, trainer)
    torch.cuda.empty_cache()
    step_timing = time_train_step(torch, device, card)
    log("  train step timing:", json.dumps({str(k): v for k, v in
                                             step_timing.items()}))
    torch.cuda.empty_cache()

    log("== phase 7: WaveNet sampler kernel against its plain version, "
        "{} layers, C={} [{}]".format(WN_LAYERS, WN_COND, card))
    wres, wtime = wavenet_kernel_checks(torch, device)
    torch.cuda.empty_cache()

    log("== phase 8: WaveNet vocoding path at full width through "
        "Synthesiser on {}".format(device))
    wn_model = wavenet_model(torch)
    feats = fixture_world_features()
    vocode_launches, vstats = vocode(torch, device, workdir, wn_model,
                                     feats)
    vocode_against_cpu(torch, device, wn_model, next(iter(feats.values())))
    del wn_model
    torch.cuda.empty_cache()

    log("== phase 9: one-shot MLPG kernel against its plain version [{}]"
        .format(card))
    mres = mlpg_kernel_checks(torch, device)
    torch.cuda.empty_cache()
    log("== phase 9: evaluation and WORLD synthesis through "
        "AcousticModelTrainer on {}".format(device))
    eval_launches, estats = evaluate(torch, device, trainer, hp, workdir,
                                     feats)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        if name in kres:        # serving shapes (phase 3)
            first, second = kres[name][BATCHES[0]], kres[name][BATCHES[1]]
        elif name in tres:      # training shapes (phase 5)
            first = tres[name][TRAIN_BATCHES[0]]
            second = tres[name][TRAIN_BATCHES[1]]
        elif name == "mlpg_oneshot":    # evaluation shapes (phase 9)
            first = mres[MLPG_SHAPES[0]]
            second = {"T={},L={}".format(*k): v for k, v in mres.items()
                      if k != MLPG_SHAPES[0]}
        else:                   # sampler shapes (phase 7)
            first = wres[WN_CHECK_BATCHES[0]]
            second = wres[WN_CHECK_BATCHES[-1]]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name],
                   "vocode": vocode_launches[name],
                   "evaluate": eval_launches[name]}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: first[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "shape")},
                 "card": card, "second_batch": second}
        if name == "bilstm_proj":
            entry["train_shapes"] = tres[name]
            entry["also_replaces"] = "idiaptts_tpu/ops/pallas_lstm.py:742"
        if name == "bilstm_recurrence_train":
            entry["also_replaces"] = "idiaptts_tpu/ops/pallas_lstm.py:742"
        if name == "wavenet_sampler":
            entry["one_second_of_audio"] = wtime
            entry["vocode_path"] = vstats
        if name == "mlpg_oneshot":
            entry["evaluate_path"] = estats
        for k in ("layer_max_abs_err", "layer_ms", "layer_plain_ms"):
            if k in first:
                entry[k] = first[k]
        kernels.append(entry)
    if FAILURES:
        log("== {} check(s) failed:".format(len(FAILURES)))
        for message in FAILURES:
            log("  ", message)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
