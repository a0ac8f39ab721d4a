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
   the PyTorch library call that computes the same function (K2: the
   dense ``torch.cholesky_solve``; the projection: a bf16 ``torch.bmm``,
   with the kernel's TFLOP/s and share of its bound; the recurrence:
   cuDNN's LSTM, and its µs a step).  K2 as the served MLPG stage
   launches it (``mlpg_served``: the model output's window means through
   the pipeline's column map, b assembled in the kernel), with its µs a
   sequential step, also at T = 2048, B = 48 (``SOLVE_LONG``), past a
   block's 4096 rows (``SOLVE_SUPER``), at T = 1, 2, 3 (``SOLVE_SHORT``),
   and in its lane-wise mode (``solve_banded``).  The projection also at ragged
   shapes (``PROJ_RAGGED``); the recurrence also at the narrow width
   F = 64 (``NARROW``, B = 6).
4. The serving path at full width: the Interspeech'18 acoustic model
   ``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67`` (141 question inputs,
   random weights from a seeded ``torch.Generator``; the repository holds
   no trained weights), MLPG variances from the fixture corpus, served by
   ``SynthesisServer`` over the port's pipeline on ``cuda`` for the six
   fixture utterances submitted concurrently.  Launch counters are reset
   just before and read just after, and every serving kernel must have
   launched.  The card's result is held against the port's CPU path on
   one utterance, then the slice is timed (label -> waveform xRT at
   B = 6 and B = 48, per-stage ms, and the device split of one batch
   from torch.profiler, with K2's share of the device time).
5. The training kernels against their plain versions at the training
   benchmark's shapes (T = 1024, D = 1024, F = 512, B = 8, 32 and 64):
   the training recurrence's h bit-identical to the inference kernel's,
   its gates and cells, the reverse-time backward's dz (float32 and bf16
   residuals), the projection, and one layer's autograd gradients
   against autograd through the plain layer; CUDA-event times beside
   cuDNN's LSTM (the projection: beside ``torch.bmm``).  The training
   recurrence and the backward also at the narrow width F = 64
   (``NARROW``, B = 8).
6. The training path at full width: ``AcousticModelTrainer`` on the
   fixture corpus on ``cuda`` (3 epochs, batch 2, 25% validation), with
   the launch counters reset just before ``train`` and read just after;
   every training kernel must have launched, the training loss must be
   finite and fall, and the last checkpoint must reload to the same
   parameters.  One train step's loss and gradients are held against the
   port's CPU path on one utterance.  Then the handler's train step is
   timed at B = 8 and 32, T = 1024, on seeded random data (CUDA events;
   frames/s, TFLOP/s, and device time per kernel from torch.profiler).
   Then the quality-pin recipe ``RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67``
   (F = 64) takes ``NARROW_TRAIN_STEPS`` handler train steps on one
   seeded batch (B = 8, T = 1024), counters reset just before and read
   just after: the backward must launch once per BiLSTM layer and step,
   and the loss must be finite and fall.
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
   MLPG kernel (K1) against its plain version as ``MLPG.generation``
   launches it (``mlpg_utterance``: seeded window means and variances
   in, the system assembled in the kernel) and on the system assembled
   on the card outside it (``mlpg_oneshot``), at T = 512 with L = 20
   and 1 lanes, T = 2048 with L = 60 and T = 1, 2, 3 with L = 20;
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
10. The text front door.  (a) The duration pin recipe
   (tests/integration/test_quality_pins.py:118-162): phone-level
   questions from the port's ``QuestionLabelGen.gen_data``,
   ``DurationModelTrainer`` with its full-width default model for 12
   epochs from the JAX package's initial weights (``models/flax_init.py``
   repeats the draw without JAX); Dur RMSE one-sided against the pin.
   (b) The acoustic pin recipe ``RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67``
   (:76-107), 12 epochs from the JAX draw, counters reset just before
   training and read just after (K7's projection, K4 and K5 must
   launch); MCD, F0-RMSE, VDE and BAP one-sided against the pins; its
   own synth's loudness (ROADMAP fault 3.7).  (c) ``TTSModel.run_DM_AM``
   on the six fixture label files with phase 6's acoustic model and a
   duration model trained on run_DM_AM's own phone questions, fused and
   modular, counters and the native question matcher's count reset just
   before each run and read just after: every duration at least 1
   frame, each wav sum(durations) x 80 samples and finite, K3, the
   projection and K2 (fused) or K1 (modular) launched, the matcher used;
   wall seconds split into the front half and the synth.
   (d) ``TTSModel.serve``: eight texts submitted at once through the
   built-in front end; every future resolves, requests share batches,
   and one request matches the port's CPU path on the same weights with
   the card's noise draw by frame energy; latency per request and the
   host/device split.
11. The rest of rnn_dyn.  (a) The ICASSP'19 preset
   ``RNNDYN-2_RELU_1024-3_BiGRU_427-1_FC_67`` at full width (the fixture
   questions zero-padded to 409 columns, the JAX draw from
   ``models/flax_init.py``) through ``FusedAcousticPipeline`` on the six
   utterances, counters reset just before and read just after (K2, and
   no BiLSTM kernel), held against the CPU path (model output, then
   the whole path by frame energy), timed at B = 6 and 48 with the
   model / MLPG / vocoder split; trained one epoch through
   ``AcousticModelTrainer`` (the validation loss falls, no BiLSTM
   kernel launches) and its train step timed (B = 8, T = 512).  (b) The
   speaker-embedding preset ``RNNDYN-129x128_EMB_(-1)-2_RELU_1024-3_
   BiLSTM_512-1_FC_67`` with a speaker index from a CategoryDataReader
   as the second input: one epoch (K7's projection, K4, K5 must launch)
   with ``profiler_dir`` set and TensorBoard on (e: the trace and, with
   tensorboardX, the event file), then ``build_serving`` and ``serve``
   (K6's projection, K3, K2 must launch), held against the CPU path and
   timed.  (c) One small model per remaining layer type (Conv1d +
   BatchNorm + unidirectional LSTM + pooling, a unidirectional LSTM,
   ``RNNTANH``) on the card against the CPU on the same converted
   weights, a VAE trained a few steps with ``VAEKLDLoss``, and
   AlwaysDropout with a seeded generator.  (d) The full-width train
   step at T = 1024, B = 64 from one seeded init with float32 and bf16
   BiLSTM residuals: the loss after 20 steps and the ms a step.
12. WORLD feature extraction.  (a) ``WorldFeatLabelGen.gen_data`` on
   ``cuda`` over the fixture corpora, 16 kHz (six wavs, 9.93 s) and
   48 kHz (two, 3.35 s), at 20 coded coefficients with deltas (the
   recipes' width) and 60 without: wall s and xRT, the files and
   feature widths; one utterance of each rate through ``world_analysis``
   on the card against the port's CPU path (the bounds of
   tests/unit/test_torch_world_analysis.py); the F0 of the card's
   corpus against the contours the fixture wavs were synthesised from.
   (b) The extraction's split for one wav of each rate and for the 16
   kHz wavs concatenated to 60 s (12,000 frames): ``world_analysis`` end
   to end (xRT), the device analysis, its Viterbi loop alone, the host's
   ``refine_vuv``, and the device's idle share from torch.profiler; the
   60 s utterance's F0 against the concatenated contours.  (c) Phase 6's
   trainer (the Interspeech'18 model) trained on the card's own 20-mcep
   corpus and its statistics, counters reset just before and read just
   after (K7's projection, K4 and K5 must launch, the loss finite and
   falling), then its modular ``synth`` (K1 must launch).  (d) One
   utterance's amplitude spectrum through ``run_world_synth`` (``sp_type
   = "amp_sp"``) and its STFT magnitude through ``run_griffin_lim`` on
   the card: finite and audible.
13. The remaining models and trainers.  (a) ``WaveNetVocoderTrainer``
   at ``WaveNetWrapper.Config``'s defaults (20 layers, R = 64, 256
   classes) on the six fixture wavs with their 20-mcep WORLD
   conditioning (23 channels upsampled to 16 kHz) in 0.5 s windows,
   ``WN_TRAIN_EPOCHS`` epochs: the validation loss falls, the train step
   is timed; ``save_for_vocoding`` -> ``WaveNetVocoder.load`` gives the
   same parameters and the same draw; ``synth`` of two utterances
   launches K8 (xRT).  (b) ``AtomVUVDistPosModelTrainer`` with its
   default model ``RNNDYN-2_RELU_1024-1_BiLSTM_512-1_FC_7`` on the
   questions zero-padded to 409 columns, 3 epochs (K7's projection, K4
   and K5 in training; K6's projection and K3 in ``benchmark``), then
   ``AtomNeuralFilterModelTrainer`` and
   ``PhraseAtomNeuralFilterModelTrainer`` adopt it and train: F0-RMSE,
   VDE, the step ms and the IIR filter loops' ms.  (c) VTLN at full
   width: the Interspeech'18 pre-net under ``AllPassWarpLayer`` in a
   ``Sequential`` with the pin recipe's speaker input, trained (K7's
   projection, K4, K5), then ``benchmark`` (K3, K1) with the MCD sweep.
   (d) The atom, flat, phrase and VTLN pin recipes
   (tests/integration/test_quality_pins.py:165-320) as published, from
   the JAX draw, one-sided at 1% to the pins read from that file's text.
   (e) ``EncDecMonophoneModelTrainer`` at its defaults (encoder
   256-256, two frames a step, fixed attention) two epochs, its train
   step timed with the device's idle share from torch.profiler, then
   teacher-forced and free-running forwards card against CPU;
   ``ClassificationTrainer`` on the fixture questions; a
   ``WindowingWrapper`` around a small BiLSTM model card against CPU.
   Every model of (a)-(c) is also held against a CPU copy on one
   utterance (``ATOM_TOL``, ``WN_TOL``, ``ENC_DEC_TOL``).
14. The rest of the port's surface.  (a) Data-parallel training of
   ``MODEL_STRING`` (409 inputs, seed 1234, SGD) on a global batch of 8
   variable-length utterances at T = 1024 (``DP_LENGTHS``): two ranks
   sharing the card through gloo and a one-rank NCCL world, each spawned
   by this script (``--dp-worker``), held to the one-process step on the
   card (losses ``DP_LOSS_RTOL``, parameters ``DP_PARAM_RTOL`` /
   ``DP_PARAM_ATOL``); K7's projection, K4 and K5 counted on each rank;
   the step's ms for each.  (b) ``egs.ljspeech_demo`` stages 1-8 at full
   width on the fixtures, one stage a call with the counters reset just
   before and read just after (K7/K4/K5 in 4, K6/K3/K1 in 5, K6/K3/K2 in
   6 and 7, K8 in 8); the benchmark scores; each served wav finite and
   non-silent.  (c) ``egs.intonation_demo`` stages 1-6 at its default
   epochs: finite benchmarks.  (d) ``FusedAcousticPipeline(devices=
   [card, card])`` at B = 6 against one device: the PCM equal, the
   padded tails silent.
   (e) ``enhance`` of a fixture wav plus seeded noise, card against CPU
   in float64 (``ENHANCE_TOL`` of the peak).
15. Tensor parallelism.  (a) The one-direction instances of the
   projection, K3, K4 and K5 (``*_onedir``) on each direction's inputs
   at T = 1024, B = 8 and 32, F = 512 and at F = 64: ``torch.equal`` to
   that half of the two-direction launch, within the two-direction
   tolerances of their plain versions, timed beside them and a
   unidirectional cuDNN LSTM.  (b) ``MODEL_STRING`` trained at
   ``model_parallel=2`` by two gloo ranks that share the card, spawned
   as ``--tp-worker``, on phase 14's batch: 3 steps held to the
   one-process step (losses, the gathered parameters, the grad norm), 3
   timed; where the machine has the cards, NCCL one rank a card at
   model 2, data 2 x model 2 and model 4.  (c) Every rank launches the
   one-direction projection, K4 and K5 ``TP_LAUNCHES`` times each and
   no two-direction kernel, and holds the parameter bytes that
   ``make_param_shardings`` gives.  (d) A TP evaluation and inference
   (one-direction projection and K3).  (e) The TP checkpoint (rank 0
   wrote it) loaded into a one-process handler: the same parameters,
   its forward against the TP forward.  ``chip_smoke.py --phase15``
   runs phases 1, 2 and 15 alone.
16. The WaveNet training kernels at the ``wavenet.train`` benchmark
   cell's shapes (32 crops in the 8192 bucket, r9y9 widths: R = G = 512,
   S = 256, kernel 3; ``WN_TRAIN_SHAPES``): the gate (``wavenet_gate_fwd``
   / ``_bwd``), the taps (``wavenet_taps`` / ``_bwd``) and the
   skip/residual update (``wavenet_residual`` / ``_bwd``) through their
   wrappers against their plain versions on the same card tensors (the
   gate's z and dh within one bf16 ulp, everything else ``torch.equal``),
   with CUDA-event times for both and each kernel's bytes bound.  Then
   ``ModularModelHandler`` steps of the r9y9 WaveNet (24 layers) on 32
   crops of 8000 samples, the block stack as CUDA graphs: one step
   captures, the next replays with the counters reset just before and
   read just after (each kernel launches once a block, credited from
   the replays); the graphed step's ms beside the eager step's, the
   captures and replays, and the peak memory.  ``chip_smoke.py
   --phase16`` runs phases 1, 2 and 16 alone.

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
# The narrow BiLSTM (input, hidden) width that phase 3 also checks K3 at:
# tests/integration/test_quality_pins.py's RNNDYN-2_RELU_128-1_BiLSTM_64.
NARROW = (128, 64)
# Recurrence kernel vs plain recurrence, absolute on h in (-1, 1);
# measured 8.7e-4 (B=6) and 1.1e-3 (B=48) on an H100.
REC_TOL = 5e-3
# Projection shapes (T, B, D, F) that leave the kernel's 128 x 256 x 64
# tiling ragged everywhere: Bp = 7 (tiles of 128 steps of one row, 37 of
# them filled), K = 1000 (not a multiple of the 64-deep stage), N = 384
# (a half-empty column tile); and D = 409, the question width, padded
# along K to 416.
PROJ_RAGGED = ((37, 7, 1000, 96), (50, 6, 409, 128))
# K2 (served MLPG) also at the longest bucket the card tests hold (T, B).
SOLVE_LONG = (2048, 48)
# K2 past the 4096 rows a block holds, as a long served request reaches
# it: five super-chunks, each earlier one's y through the output buffer.
SOLVE_SUPER = (16640, 2)
# K2 at the shortest lanes: T below one chunk, the zero carries at both
# ends (T, B).
SOLVE_SHORT = ((1, 1), (2, 1), (3, 3))

# Training benchmark shapes (bench_training.py:35-114): bucket T, batches,
# question width; the full-width model's output width.  Phase 5 also holds
# the training kernels at B = 64 (128 rows, the largest training batch
# the JAX package runs in its kernel, pallas_lstm.py:train_viable).
TRAIN_T = 1024
TRAIN_BATCHES = (8, 32)
KERNEL_TRAIN_BATCHES = TRAIN_BATCHES + (64,)
# The quality-pin recipe (tests/integration/test_quality_pins.py:98),
# whose BiLSTM is NARROW: phase 6 trains it for a few handler steps.
NARROW_MODEL_STRING = "RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67"
NARROW_TRAIN_STEPS = 8
NARROW_TRAIN_B = 8
TRAIN_D_IN, TRAIN_D_OUT = 409, 67
TRAIN_EPOCHS = 3

# The WaveNet training kernels replace no TPU kernel: XLA fused the gate,
# the taps and the skip/residual update of the JAX package's
# teacher-forced ResidualBlock into its convolutions.
WN_XLA = "none (XLA fusion in idiaptts_tpu/models/wavenet.py:25)"
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
    # The one-direction instances (ndir = 1) that a tensor-parallel rank
    # launches on its BiLSTM direction.
    "bilstm_proj_onedir": ("idiaptts_torch/csrc/bilstm_proj.cu",
                           "idiaptts_tpu/ops/pallas_lstm.py:590"),
    "bilstm_recurrence_onedir": ("idiaptts_torch/csrc/bilstm_recurrence.cu",
                                 "idiaptts_tpu/ops/pallas_lstm.py:76"),
    "bilstm_recurrence_train_onedir": (
        "idiaptts_torch/csrc/bilstm_recurrence.cu",
        "idiaptts_tpu/ops/pallas_lstm.py:161"),
    "bilstm_bwd_onedir": ("idiaptts_torch/csrc/bilstm_bwd.cu",
                          "idiaptts_tpu/ops/pallas_lstm.py:264"),
    "wavenet_gate_fwd": ("idiaptts_torch/csrc/wavenet_gate.cu", WN_XLA),
    "wavenet_gate_bwd": ("idiaptts_torch/csrc/wavenet_gate.cu", WN_XLA),
    "wavenet_taps": ("idiaptts_torch/csrc/wavenet_block.cu", WN_XLA),
    "wavenet_taps_bwd": ("idiaptts_torch/csrc/wavenet_block.cu", WN_XLA),
    "wavenet_residual": ("idiaptts_torch/csrc/wavenet_block.cu", WN_XLA),
    "wavenet_residual_bwd": ("idiaptts_torch/csrc/wavenet_block.cu",
                             WN_XLA),
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
# The WaveNetWrapper.Config default conditioning width (Cp = 64, the
# largest layer blob, 3 layers a CTA in 227 KB of shared memory).
WN_COND_WIDE = 63
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

# Phase 10, the text front door.  The quality-pin recipes
# (tests/integration/test_quality_pins.py:76-162) at their published
# settings: 12 epochs, batch 2, learning rate 0.002, 25% validation, the
# best model kept, started from the JAX package's initial weights
# (models/flax_init.py repeats its draw without JAX).  Scores are held
# one-sided against the pins, read from that file's text, with the
# tolerance the CPU tests hold the port to (tests/unit/
# test_torch_quality_pins.py: RTOL).
PIN_FILE = os.path.join(REPO, "tests", "integration", "test_quality_pins.py")
PIN_TOL = 0.01
PIN_EPOCHS = 12
PIN_KERNELS = ("bilstm_proj", "bilstm_recurrence_train", "bilstm_bwd")
QUESTION_FILE = os.path.join(FIXTURES, "questions-gen_dnn.hed")
TEXT_FUSED_KERNELS = ("banded_solve", "bilstm_proj", "bilstm_recurrence")
TEXT_MODULAR_KERNELS = ("mlpg_oneshot", "bilstm_proj", "bilstm_recurrence")
# Texts served at once through TextToSpeechServer (the built-in front end):
# those of tests/integration/test_tts_model.py.
SERVE_TEXTS = ("the quick brown fox jumps over the lazy dog",
               "speech synthesis with no external front end",
               "a stitch in time saves nine",
               "pack my box with five dozen jugs",
               "how vexingly quick daft zebras jump",
               "numbers like 42 are spelled out",
               "hello world this is online serving",
               "another request at the same time")
# One served request on the card against the port's CPU path with the
# card's noise draw, by 5 ms frame energy over the frames within 60 dB
# of the loudest.  The model's outputs are bf16 and differ between the
# two by an ulp (2**-7 at magnitudes below 2) of the normalised c0, which
# the denormalisation scales by c0's standard deviation (8.35 on the
# fixtures): the bound is that many nepers in dB, 20 log10(e) x 2**-7 x
# std(c0), 0.57 dB.  Measured 0.047 dB on an H100.
SERVE_C0_ULPS = 2.0 ** -7

# Phase 11.  The ICASSP'19 preset (idiaptts_tpu/models/rnn_dyn.py:686-689)
# at the production question width: the fixtures' 141 question columns
# zero-padded to 409.
ICASSP19_MODEL_STRING = "RNNDYN-2_RELU_1024-3_BiGRU_427-1_FC_67"
ICASSP19_D_IN = 409
GRU_TRAIN_B = 8
# The Interspeech'18 model with a table of 129 speakers (rnn_dyn.py:560).
EMB_MODEL_STRING = "RNNDYN-129x128_EMB_(-1)-2_RELU_1024-3_BiLSTM_512-1_FC_67"
NUM_SPEAKERS = 129
BILSTM_KERNELS = ("bilstm_proj", "bilstm_recurrence",
                  "bilstm_recurrence_train", "bilstm_bwd")
# One small model per remaining layer type, card against CPU.
SMALL_MODELS = (
    "RNNDYN-2_Conv1dRELU_64_3x1_s1_d2-1_BatchNorm1dLSTM_32-1_PoolLast_1",
    "RNNDYN-2_LSTM_64-1_FC_67",
    "RNNDYN-2_RNNTANH_64-1_FC_67")
SMALL_D_IN, SMALL_T, SMALL_B = 48, 200, 4
VAE_MODEL_STRING = "RNNDYN-1_RELU_64-1_VAE_16-1_FC_67"
VAE_STEPS = 6
ALWAYS_DROPOUT = 0.2
RESIDUAL_B, RESIDUAL_STEPS = 64, 20
# Card against CPU in phase 11, relative to the output's magnitude (model
# outputs) or in dB of 5 ms frame energy (whole paths), measured on an
# H100 at 700 W.  The recurrent cells' bf16 products round at other
# points under cuBLAS than on the CPU, and the difference rides the
# recurrence: the BiGRU model output 5.9e-3 of its magnitude (1.5 bf16
# ulps; bound 4 ulps, as phase 4's), its whole path 0.18 dB; the EMB
# preset's 0.033 dB; the small models up to 6.5e-3 (the simple RNN),
# 3.4e-3 (the unidirectional LSTM), 5.3e-6 (Conv1d, BatchNorm).  The
# dB bound is phase 10 (d)'s 0.57 dB rounded down.
ICASSP19_MODEL_TOL = 2.0 ** -6
ICASSP19_DB_TOL = 0.5
EMB_DB_TOL = 0.5
SMALL_TOL = 2.0 ** -6

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the least time the card could take for a kernel's work is the larger of
# its bytes over the HBM rate and its operations over the peak rate of
# their type.
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 operands
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Phase 16: the wavenet.train cell's model (port_bench/configs/
# r9y9_wavenet_mulaw.json) and its shapes (B, T, dilation): 32 crops in
# the 8192 bucket at the last stack's widest dilation, and the card
# tests' B = 2 at the first block's.  Crops of 8000 samples a row.
WN_R9Y9 = dict(out_channels=256, residual_channels=512, gate_channels=512,
               skip_channels=256, num_layers=24, num_stacks=4,
               kernel_size=3, cond_channels=23)
WN_TRAIN_SHAPES = ((32, 8192, 32), (2, 8192, 1))
WN_TRAIN_CROP = 8000
WN_TRAIN_KERNELS = ("wavenet_gate_fwd", "wavenet_gate_bwd", "wavenet_taps",
                    "wavenet_taps_bwd", "wavenet_residual",
                    "wavenet_residual_bwd")

# Phase 12 (feature extraction): the corpora (wav directory, sample
# rate), the coded-spectrum widths (the recipes' NUM_SPS with deltas, the
# default without), the long utterance's length, the kernels the
# extracted corpus's training and modular synth must launch, and the
# card-against-CPU bounds of tests/unit/test_torch_world_analysis.py.
EXTRACT_CORPORA = (("wav", 16000), ("wav48", 48000))
EXTRACT_SPS = ((20, True), (60, False))
EXTRACT_LONG_S = 60.0
EXTRACT_TRAIN_KERNELS = ("bilstm_proj", "bilstm_recurrence_train",
                         "bilstm_bwd")
EXTRACT_SYNTH_KERNELS = ("mlpg_oneshot",)
EXTRACT_TOL = {"voicing": 0.99, "f0_rel": 5e-4, "coded_max": 0.2,
               "coded_mean": 5e-3, "bap_max": 1.5, "bap_mean": 0.05}

# Phase 13 (the remaining models and trainers): the fixtures' wcad atoms
# and their thetas; the production question width (the fixture columns
# zero-padded, as phase 11 pads them); the VTLN pre-net, the
# Interspeech'18 model; the trainers' epochs; the WaveNet recipe's Noam
# warm-up cut to the run's dozen steps (the trainer's default is 4000).
WCAD_DIR = os.path.join(FIXTURES, "wcad-0.030_0.060_0.090_0.120_0.150")
ATOM_THETAS = (0.03, 0.06, 0.09, 0.12, 0.15)
ATOM_D_IN = ICASSP19_D_IN
ATOM_EPOCHS = 3
VTLN_PRE_NET = MODEL_STRING
VTLN_EPOCHS = 3
WN_TRAIN_EPOCHS = 4
WN_TRAIN_WARMUP = 8
ENC_DEC_EPOCHS = 2
# Card against CPU in phase 13, relative to the output's magnitude.  The
# atom, neural-filter, VTLN and windowed models run bf16 Dense layers and
# the BiLSTM kernels, whose outputs may sit one bf16 ulp from the CPU's
# plain versions and ride the recurrence: phase 4's 4 bf16 ulps
# (measured on an H100 at 700 W: the atom model 4.95e-3, VTLN 3.58e-3,
# the windowing wrapper 2.79e-3, the flat and phrase models 4.4e-4 and
# 2.4e-5; the WaveNet logits 0).  The encoder-decoder is float32
# throughout (TF32 off): cuBLAS and the CPU sum in other orders and the
# decoder carries the difference through its chunks, teacher-forced and
# free-running (measured 7.1e-7 and 8.5e-7).
ATOM_TOL = 2.0 ** -6
ENC_DEC_TOL = 1e-3

# Checks that failed; the script exits non-zero if any did.
# Phase 14 (a): the data-parallel train step.  A global batch of 8
# utterances of the full-width model's 409 questions, cropped to T = 1024
# frames with variable lengths (per-rank mask sums differ, so only the
# gathered loss equals the one-process step's), SGD for 3 steps; the
# one-process step on the card is the reference at the CPU test's bounds
# (tests/unit/test_torch_data_parallel.py): losses rtol 1e-4, parameters
# rtol 1e-3 atol 1e-5.
DP_MODEL = MODEL_STRING
DP_LENGTHS = (1024, 917, 803, 1000, 611, 1024, 733, 950)
DP_STEPS = 3
DP_TIME_REPS = 3
DP_LR = 0.01
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-4, 1e-3, 1e-5
DP_KERNELS = ("bilstm_proj", "bilstm_recurrence_train", "bilstm_bwd")
# The spawned worlds: (name, ranks, backend).  Two ranks share the card,
# which NCCL refuses, so they use gloo; NCCL runs a world of one.
DP_WORLDS = (("gloo_2", 2, "gloo"), ("nccl_1", 1, "nccl"))
# Phase 15: tensor parallelism.  (a) The one-direction kernel instances
# at the training shapes (T, B, D, F) and at the narrow width.  (b) The
# phase 14 batch and SGD steps of the Interspeech'18 model at
# model_parallel = M, against the one-process step at phase 14's bounds
# (tests/unit/test_torch_tensor_parallel.py), the grad norm at rtol 1e-3;
# K7's projection, K4 and K5 in their one-direction instances, once a
# layer and step on every rank: TP_LAUNCHES each.  (e) The TP
# checkpoint's one-process forward against the TP forward, relative to
# the output's magnitude: a column-parallel Dense layer's local GEMM is
# narrower than the one-process GEMM, so a bf16 product may round the
# other way and ride the recurrence (phase 11/13's 2**-6).
TP_MODEL = MODEL_STRING
TP_ONEDIR_SHAPES = ((TRAIN_T, 8, D_IN, F_HIDDEN), (TRAIN_T, 32, D_IN,
                                                   F_HIDDEN),
                    (TRAIN_T, NARROW_TRAIN_B) + NARROW)
TP_KERNELS = ("bilstm_proj_onedir", "bilstm_recurrence_train_onedir",
              "bilstm_bwd_onedir")
TP_LAUNCHES = DP_STEPS * 3
TP_NORM_RTOL = 1e-3
TP_FORWARD_TOL = 2.0 ** -6
# (name, ranks, model_parallel, backend, cards needed): two gloo ranks
# share one card; NCCL takes one card a rank.
TP_WORLDS = (("gloo_m2", 2, 2, "gloo", 1), ("nccl_m2", 2, 2, "nccl", 2),
             ("nccl_d2m2", 4, 2, "nccl", 4), ("nccl_m4", 4, 4, "nccl", 4))
# Phase 14 (b): egs.ljspeech_demo at full width.  Stages 1-7 with the
# recipe's default 8 epochs for the duration and acoustic models: after
# fewer, the Interspeech'18 model's served audio stays below one PCM
# step in some utterances (on the card after 4 epochs one of the six
# was silent), so the served wavs could not be checked for sound.
# Stage 8 (WaveNet) with RECIPE_EPOCHS_WAVENET.
RECIPE_EPOCHS = 8
RECIPE_EPOCHS_WAVENET = 2
# A served wav passes as audible when its RMS level is at most this many
# dB below the fixture recording of the same utterance (the recordings
# sit at -16.7 to -27.3 dB RMS of full scale).
RECIPE_LOUDNESS_DB = 40.0
RECIPE_STAGE_KERNELS = {
    4: ("bilstm_proj", "bilstm_recurrence_train", "bilstm_bwd"),
    5: ("bilstm_proj", "bilstm_recurrence", "mlpg_oneshot"),
    6: ("bilstm_proj", "bilstm_recurrence", "banded_solve"),
    7: ("bilstm_proj", "bilstm_recurrence", "banded_solve"),
    8: ("wavenet_sampler",),
}
# Phase 14 (d): the in-place weight change before a split call scales
# every parameter by SPLIT_WEIGHT_SCALE behind a spin of the caller's
# stream (torch.cuda._sleep: about 60 ms at the H100's 1.7 GHz), long
# enough for unordered side streams to read the old weights.
SPLIT_WEIGHT_SCALE = 0.75
SPLIT_SPIN_CYCLES = 100_000_000
# Phase 14 (e): enhance on the card against the CPU path, float64; bound
# relative to the waveform's peak.
ENHANCE_TOL = 1e-9

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


def lstm_bound(T, R, D, F, what, res_bytes=4, ndir=2):
    """Bound of one BiLSTM kernel's work over T steps of R rows (ndir*Bp,
    ``ndir`` directions): the bf16 products it needs and each input read
    and output written once.  ``what``: "proj" (bf16(x Wx) + b), "rec"
    (inference recurrence), "rec_train" (plus the gates and cells in
    ``res_bytes``-byte residuals), "bwd" (dz from the residuals, the
    upstream dL/dh and Wh)."""
    G = 4 * F
    if what == "proj":
        return bound(2.0 * T * R * D * G, PEAK_BF16_FLOPS,
                     T * R * D * 2 + ndir * D * G * 2 + ndir * G * 4
                     + T * R * G * 4)
    rec_flops = 2.0 * T * R * F * G
    wh_bytes = ndir * F * G * 2
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


def cudnn_lstm(torch, D, F, device, bidirectional=True):
    """cuDNN's bidirectional LSTM in bf16 with the forget-gate bias +1
    folded into its bias: the library call that computes a BiLSTM layer
    (input projection included, as cuDNN always does).  Timed as a
    yardstick only; the port never calls it.  PyTorch keeps bf16 weights
    out of cuDNN's flat buffer, so each call also compacts them (12.6 MB
    at D=1024, F=512), inside the time taken."""
    lstm = torch.nn.LSTM(D, F, bidirectional=bidirectional).to(
        device, torch.bfloat16)
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


def projection_inputs(torch, gen, T, B, D, F):
    """Seeded projection inputs on the generator's device: xin (T, 2B, D)
    bf16, Wx (2, D, 4F) bf16 and the bias (2, 4F) float32."""
    device = gen.device
    xin = torch.randn(T, 2 * B, D, generator=gen,
                      device=device).to(torch.bfloat16)
    wx = (torch.randn(2, D, 4 * F, generator=gen, device=device)
          / np.sqrt(D)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(2, 4 * F, generator=gen, device=device)
    return xin, wx, bias


def projection_entry(torch, xin, wx, bias, reps):
    """The projection kernel (K6/K7's first half) against its plain
    version on the same inputs, then CUDA-event times of the kernel, the
    plain version and the library yardstick (one bf16 ``torch.bmm`` over
    the directions; it writes bf16 with no bias, half the kernel's
    output bytes).  Returns the measurements."""
    from idiaptts_torch.ops import cuda_lstm
    T, R, D = xin.shape
    G = wx.shape[-1]
    B = R // 2
    shape = "T={},R={},D={},N={}".format(T, R, D, G)
    xp_k = cuda_lstm.bilstm_projection_tmajor(xin, wx, bias)
    xp_p = cuda_lstm.projection_tmajor_plain(xin, wx, bias)
    err = (xp_k - xp_p).abs().max().item()
    # Both accumulate in float32 and round to bf16; summation order
    # differs, so a product near a rounding midpoint can land on the
    # neighbouring bf16 value.  With a zero bias the outputs are the bf16
    # products themselves: at most one bf16 ulp apart (plus 1e-5 for sums
    # that cancel to near zero, where float32 summation noise exceeds the
    # ulp), and rarely.
    zero = torch.zeros_like(bias)
    p_k = cuda_lstm.bilstm_projection_tmajor(xin, wx, zero)
    p_p = cuda_lstm.projection_tmajor_plain(xin, wx, zero)
    d_p = (p_k - p_p).abs()
    excess = (d_p - bf16_ulp(torch, torch.maximum(p_k.abs(), p_p.abs()))
              - 1e-5).max().item()
    flips = (d_p > 0).float().mean().item()
    bias_rows = bias[None, :, None, :].expand(T, 2, B, G).reshape(T, R, G)
    log("  bilstm_proj        {}: max|d| = {:.3e}, {:.4%} of products one "
        "bf16 ulp apart".format(shape, err, flips))
    if excess > 0 or flips > 1e-2:
        fail("bilstm_proj products differ by more than rare one-ulp bf16 "
             "rounding flips ({})".format(shape))
    # The bias is one float32 add, the same in both.
    if not torch.equal(xp_k, p_k + bias_rows):
        fail("bilstm_proj bias add differs ({})".format(shape))
    del xp_k, xp_p, p_k, p_p, d_p, bias_rows
    x_dir = xin.reshape(T, 2, B, D).transpose(0, 1).reshape(
        2, T * B, D).contiguous()
    bound_ms, bound_by = lstm_bound(T, R, D, G // 4, "proj")
    ms = cuda_ms(torch, lambda: cuda_lstm.bilstm_projection_tmajor(
        xin, wx, bias), reps)
    r = dict(shape=shape, max_abs_err=err, ms=ms, bound_ms=bound_ms,
             bound_by=bound_by, tflops_per_s=2.0 * T * R * D * G / ms / 1e9,
             bound_share=bound_ms / ms,
             library_ms=cuda_ms(torch, lambda: torch.bmm(x_dir, wx), reps),
             plain_ms=cuda_ms(torch, lambda: cuda_lstm
                              .projection_tmajor_plain(xin, wx, bias), reps))
    log("  bilstm_proj        {}: kernel {:.4f} ms, {:.1f} TFLOP/s, {:.1%} "
        "of its bound {:.4f} ms ({}) | bmm {:.4f} ms | plain {:.4f} ms"
        .format(shape, ms, r["tflops_per_s"], r["bound_share"], bound_ms,
                bound_by, r["library_ms"], r["plain_ms"]))
    return r


def dense_factor(torch, l0, l1, l2):
    """The (L, T, T) lower-triangular MLPG factor of the bands:
    F[t, t] = l0[t], F[t, t-1] = l1[t-1], F[t, t-2] = l2[t-2]."""
    T = l0.shape[0]
    f = torch.diag_embed(l0.t())
    for k, band in ((1, l1), (2, l2)):
        if T > k:
            f = f + torch.diag_embed(band[:T - k].t(), offset=-k)
    return f


def served_mlpg_entry(torch, pipeline, gen, B, T, library):
    """K2 in its fused mode (``mlpg_served``: the model output's window
    means through the pipeline's column map, the bucket's cached factor)
    against its plain version at (B, T), with CUDA-event times, µs per
    sequential step (2T of them) and, with ``library``, the dense
    ``torch.cholesky_solve`` on the assembled right-hand side."""
    from idiaptts_torch.ops import cuda_mlpg
    factors, tau = pipeline.factors_for(T)
    D = factors.shape[-1]
    C = 3 * pipeline.num_coded_sps + 4 + 3 * pipeline.num_bap
    out = torch.randn(B, T, C, generator=gen, device=factors.device)
    args = (out, pipeline._colmap, factors, tau)
    x_k = cuda_mlpg.mlpg_served(*args)
    x_p = cuda_mlpg.mlpg_served_plain(*args)
    err = (x_k - x_p).abs().max().item()
    scale = max(1.0, x_p.abs().max().item())
    # The right-hand side assembled in the plain version's float32 order;
    # the substitutions in chunks of 16 rows with FMAs and a multiply by
    # the rounded 1/l0 (a few ulps a step, amplified by the system's
    # conditioning).
    _check("banded_solve", err, 1e-5 * scale,
           "served T={} B={} L={}".format(T, B, B * D))
    # Bytes: the 3D window-mean columns, tau, the factor and the statics;
    # about 21 float32 operations a lane and row (b, two substitutions).
    bound_ms, bound_by = bound(21.0 * B * T * D, PEAK_F32_FLOPS,
                               (4 * B * T * D + 6 * T * D) * 4)
    ms = cuda_ms(torch, lambda: cuda_mlpg.mlpg_served(*args), 50)
    r = dict(shape="T={},B={},L={}".format(T, B, B * D), max_abs_err=err,
             bound_ms=bound_ms, bound_by=bound_by, ms=ms,
             us_per_step=ms * 1e3 / (2 * T),
             plain_ms=cuda_ms(torch, lambda: cuda_mlpg.mlpg_served_plain(
                 *args), 1), library_ms=None)
    if library:
        # Library yardstick: torch.cholesky_solve on the dense (L, T, T)
        # factor, O(T^2) per lane, for the right-hand side the kernel
        # assembles.  Another algorithm in float32: within 1e-3 of the
        # largest |x|.
        feats = out.index_select(-1, pipeline._colmap.long()).reshape(
            B, T, 3, D)
        rhs = cuda_mlpg.b_vector(feats * tau).permute(0, 2, 1).reshape(
            B * D, T, 1).contiguous()
        factor = dense_factor(torch, *(factors[i].repeat(1, B)
                                       for i in range(3)))
        lib_x = torch.cholesky_solve(rhs, factor).reshape(B, D, T) \
            .permute(0, 2, 1)
        lib_err = (lib_x - x_k).abs().max().item()
        _check("banded_solve lib", lib_err, 1e-3 * scale,
               "cholesky_solve vs kernel, L={}".format(B * D))
        r.update(library_ms=cuda_ms(torch, lambda: torch.cholesky_solve(
                     rhs, factor), 5),
                 library="torch.cholesky_solve on the dense (L, T, T) "
                         "factor",
                 library_abs_err=lib_err)
        del factor, rhs
    return r


def lanewise_solve_entry(torch, factors, gen, B, T):
    """K2 in its lane-wise mode (``solve_banded``: b given, the factor
    tiled to L = B * 22 lanes) against its plain version."""
    from idiaptts_torch.ops import cuda_mlpg
    l0, l1, l2 = (factors[i].repeat(1, B).contiguous() for i in range(3))
    b = torch.randn(T, B * factors.shape[-1], generator=gen,
                    device=factors.device)
    x_k = cuda_mlpg.solve_banded(b, l0, l1, l2)
    x_p = cuda_mlpg.solve_banded_plain(b, l0, l1, l2)
    err = (x_k - x_p).abs().max().item()
    # As in served_mlpg_entry (measured 3.4e-5 and 4.2e-5 at a scale of
    # about 50-60 on an H100).
    _check("banded_solve", err, 1e-5 * max(1.0, x_p.abs().max().item()),
           "lane-wise T={} L={}".format(T, b.shape[1]))
    ms = cuda_ms(torch, lambda: cuda_mlpg.solve_banded(b, l0, l1, l2), 50)
    return dict(max_abs_err=err, ms=ms, us_per_step=ms * 1e3 / (2 * T),
                plain_ms=cuda_ms(torch, lambda: cuda_mlpg
                                 .solve_banded_plain(b, l0, l1, l2), 2))


def kernel_checks(torch, pipeline, device):
    """Each kernel against its plain version at the serving shapes, and
    the projection at PROJ_RAGGED.  Returns {kernel name: {B or shape
    label: measurements}}."""
    from idiaptts_torch.ops import cuda_lstm, cuda_mlpg
    gen = torch.Generator(device=device).manual_seed(1234)
    T, F, D = T_BUCKET, F_HIDDEN, D_IN
    results = {k: {} for k in SERVE_KERNELS}
    factors, _ = pipeline.factors_for(T)

    for B in BATCHES:
        # K2 as the served MLPG stage launches it (fused mode), with the
        # dense library yardstick; then its lane-wise mode.
        results["banded_solve"][B] = served_mlpg_entry(
            torch, pipeline, gen, B, T, library=True)
        results["banded_solve"][B]["lanewise"] = lanewise_solve_entry(
            torch, factors, gen, B, T)

        # K6, projection half: bf16(x . Wx) + b.
        xin, wx, bias = projection_inputs(torch, gen, T, B, D, F)
        results["bilstm_proj"][B] = projection_entry(torch, xin, wx, bias,
                                                     20)
        proj_err = results["bilstm_proj"][B]["max_abs_err"]
        xp_p = cuda_lstm.projection_tmajor_plain(xin, wx, bias)

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
        results["bilstm_recurrence"][B]["us_per_step"] = \
            results["bilstm_recurrence"][B]["ms"] * 1e3 / T

        # K6 whole: projection kernel then recurrence kernel, against the
        # plain layer.  On top of the recurrence's tolerance, each
        # projection flip moves one gate pre-activation by one bf16 ulp,
        # and h moves by at most as much (|dh/dgate| <= 1).
        lay_err = (cuda_lstm.bilstm_layer_tmajor(xin, wx, wh_cat, bias)
                   - cuda_lstm.scan_layer_tmajor(xin, wx, wh_cat, bias)
                   ).abs().max().item()
        _check("bilstm_layer", lay_err, REC_TOL + proj_err,
               "T={} R={} D={} F={}".format(T, 2 * B, D, F))
        results["bilstm_proj"][B]["layer_max_abs_err"] = lay_err
        results["bilstm_proj"][B]["layer_ms"] = cuda_ms(
            torch, lambda: cuda_lstm.bilstm_layer_tmajor(
                xin, wx, wh_cat, bias), 5)
        results["bilstm_proj"][B]["layer_plain_ms"] = cuda_ms(
            torch, lambda: cuda_lstm.scan_layer_tmajor(
                xin, wx, wh_cat, bias), 1)

    # K2 at the longest bucket the card tests hold (the dense yardstick's
    # (L, T, T) factor would take 17.7 GB: not timed).
    results["banded_solve"]["T={},B={}".format(*SOLVE_LONG)] = \
        served_mlpg_entry(torch, pipeline, gen, SOLVE_LONG[1], SOLVE_LONG[0],
                          library=False)
    for T_s, B_s in (SOLVE_SUPER,) + SOLVE_SHORT:
        results["banded_solve"]["T={},B={}".format(T_s, B_s)] = \
            served_mlpg_entry(torch, pipeline, gen, B_s, T_s, library=False)
    # The projection at shapes that leave every edge of its tiling ragged.
    for T_r, B_r, D_r, F_r in PROJ_RAGGED:
        results["bilstm_proj"]["T={},B={},D={},F={}".format(
            T_r, B_r, D_r, F_r)] = projection_entry(
                torch, *projection_inputs(torch, gen, T_r, B_r, D_r, F_r), 5)
    results["bilstm_recurrence"]["narrow"] = narrow_recurrence(torch, gen)
    for name, by_b in results.items():
        for B, r in by_b.items():
            log("  {:<18s} {:<6s} {:<28s} kernel {:9.4f} ms | plain "
                "{:9.4f} ms".format(
                    name, "B={}".format(B) if isinstance(B, int)
                    else "ragged" if name == "bilstm_proj" else B,
                    r["shape"], r["ms"], r["plain_ms"]))
    return results


def narrow_recurrence(torch, gen, T=T_BUCKET, B=BATCHES[0], D=NARROW[0],
                      F=NARROW[1]):
    """K3 at a narrow BiLSTM width (the quality-pin recipe's
    ``RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67``: F = 64, 16 blocks)
    against its plain version, with the tolerance of the full width, and
    its time beside cuDNN's LSTM of that width."""
    from idiaptts_torch.ops import cuda_lstm
    xin, wx, bias = projection_inputs(torch, gen, T, B, D, F)
    xp = cuda_lstm.projection_tmajor_plain(xin, wx, bias)
    wh = (torch.randn(2 * F, 4 * F, generator=gen, device=xp.device)
          / np.sqrt(F)).to(torch.bfloat16)
    err = (cuda_lstm.bilstm_recurrence_tmajor(xp, wh)
           - cuda_lstm.recurrence_tmajor_plain(xp, wh)).abs().max().item()
    _check("bilstm_recurrence", err, REC_TOL,
           "T={} R={} F={}".format(T, 2 * B, F))
    lstm = cudnn_lstm(torch, D, F, xp.device).eval()
    x_seq = xin[:, :B].contiguous()
    with torch.no_grad():
        lib_ms = cuda_ms(torch, lambda: lstm(x_seq), 5)
    ms = cuda_ms(torch, lambda: cuda_lstm.bilstm_recurrence_tmajor(xp, wh),
                 5)
    return dict(shape="T={},R={},F={}".format(T, 2 * B, F),
                max_abs_err=err, ms=ms, us_per_step=ms * 1e3 / T,
                plain_ms=cuda_ms(torch, lambda: cuda_lstm
                                 .recurrence_tmajor_plain(xp, wh), 1),
                library_ms=lib_ms,
                **dict(zip(("bound_ms", "bound_by"),
                           lstm_bound(T, 2 * B, D, F, "rec"))))


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


def build_slice(torch, device, model_string=MODEL_STRING, d_in=None,
                jax_draw=False):
    """The fixture questions (zero-padded to ``d_in`` columns if given),
    the model (seeded weights, or the JAX package's initial draw from
    ``models/flax_init.py``) and a pipeline factory."""
    from idiaptts_torch.models import convert, flax_init
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    questions, variances, num_q = load_corpus()
    if d_in is not None:
        questions = [np.pad(q, ((0, 0), (0, d_in - q.shape[1])))
                     for q in questions]
        num_q = d_in
    cfg = convert_legacy_string(model_string, num_q)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    model = cfg.create_model(torch.Generator().manual_seed(0))
    if jax_draw:
        convert.load_flax_params(model, flax_init.rnn_dyn_params(cfg))
    model = model.to(device).eval()

    def model_apply(m, questions_b, lengths_b):
        return m({"questions": questions_b}, lengths=lengths_b)["pred"]

    def make_pipeline(dev, devices=None):
        return FusedAcousticPipeline(model_apply, variances,
                                     num_coded_sps=NUM_SPS, fs=FS,
                                     bucket=256, device=dev,
                                     devices=devices)

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


def check_against_cpu(torch, pipeline, cpu_pipe, model, questions,
                      model_tol=2.0 ** -6, frame_db_tol=None):
    """The card's stages against the port's CPU path (plain versions) on
    one utterance: the model output within ``model_tol`` of its
    magnitude, then MLPG and the vocoder on the card's model output with
    one shared noise draw.  With ``frame_db_tol``, also the whole CPU
    path (its own model output, MLPG and vocoder, the same draw) against
    the card's by 5 ms frame energy over the frames within 60 dB of the
    loudest; returns that largest difference in dB."""
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
        # Phase 4: the FC output is bf16, 4 bf16 ulps at its magnitude.
        _check("model_stage", err, top * model_tol, "B=1 T={}".format(T))
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
        if frame_db_tol is None:
            return None
        sm_o, vuv_o = cpu_pipe.mlpg_stage(out_c, lengths.cpu(),
                                          *cpu_pipe.factors_for(T))
        w_o = cpu_pipe.vocoder_stage(sm_o, vuv_o, f0c.cpu(), z=z)
    n = int(lengths[0]) * pipeline.hop
    db_g = _frame_db(w_g.cpu().numpy()[0, :n])
    db_c = _frame_db(w_o.numpy()[0, :n])
    loud = db_c > db_c.max() - 60.0
    db = float(np.abs(db_g[loud] - db_c[loud]).max())
    _check("whole path", db, frame_db_tol, "frame energy, dB")
    return db


def time_slice(torch, pipeline, model, questions, card, reps=5):
    """CUDA-event label -> waveform xRT at the fixture batch and the 8x
    capacity batch (means over ``reps`` runs), plus per-stage ms and the
    device split of a batch (torch.profiler: busy ms, idle share, ms by
    kernel)."""
    out = {}
    for rep in (1, 8):
        qs = list(questions) * rep
        batch, lengths, f0c = pipeline.prepare(qs)
        B, T = batch.shape[0], batch.shape[1]
        factors, tau = pipeline.factors_for(T)
        audio_s = float(sum(len(q) for q in qs)) * pipeline.hop / FS
        with torch.inference_mode():
            total = cuda_ms(torch, lambda: pipeline.run(
                model, batch, lengths, f0c), reps)
            o = pipeline.model_stage(model, batch, lengths)
            sm, vuv = pipeline.mlpg_stage(o, lengths, factors, tau)
            stages = {
                "model_ms": cuda_ms(torch, lambda: pipeline.model_stage(
                    model, batch, lengths), reps),
                "mlpg_ms": cuda_ms(torch, lambda: pipeline.mlpg_stage(
                    o, lengths, factors, tau), 5),
                "vocoder_ms": cuda_ms(torch, lambda: pipeline
                                      .vocoder_stage(sm, vuv, f0c), 5),
            }
            kernels = profile_step(torch, lambda: pipeline.run(
                model, batch, lengths, f0c))
        busy = sum(kernels.values())
        ours = port_kernel_ms(kernels)
        out[B] = dict(T=T, audio_s=audio_s, total_ms=total,
                      xrt=audio_s / (total / 1e3), **stages,
                      device_busy_ms=busy if kernels else None,
                      idle_share=1.0 - busy / total if kernels else None,
                      port_kernels_ms=ours,
                      banded_solve_share=(ours["banded_solve"] / busy
                                          if kernels else None),
                      top_kernels_ms=dict(sorted(
                          kernels.items(), key=lambda kv: -kv[1])[:10]))
        log("  B={} T={} audio {:.2f} s: label->wav {:.3f} ms = {:.1f}x "
            "realtime | model {:.3f} ms, mlpg {:.3f} ms, vocoder {:.3f} ms "
            "[{}]".format(B, T, audio_s, total, out[B]["xrt"],
                          stages["model_ms"], stages["mlpg_ms"],
                          stages["vocoder_ms"], card))
        if kernels:
            log("    device busy {:.3f} ms a batch (idle {:.1%}); port "
                "kernels ms: {}; K2 {:.2%} of the device time".format(
                    busy, 1.0 - busy / total, json.dumps(ours),
                    out[B]["banded_solve_share"]))
            for name, v in out[B]["top_kernels_ms"].items():
                log("    {:9.3f} ms  {:5.1%}  {}".format(v, v / busy,
                                                        name[:100]))
        else:
            log("    torch.profiler recorded no device time: device split "
                "not measured")
    return out


# -- phase 5 -----------------------------------------------------------------

def _rel(x, ref):
    """max|x - ref| over max(1, max|ref|)."""
    x, ref = x.float(), ref.float()
    return (x - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def train_kernel_checks(torch, device, T=TRAIN_T,
                        batches=KERNEL_TRAIN_BATCHES, D=D_IN, F=F_HIDDEN,
                        reps=5):
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
            us_per_step=rb_ms * 1e3 / T,
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
        bwd_ms = cuda_ms(torch, lambda: cuda_lstm.dz_bwd_tmajor(
            a, c, gout, wh), reps)
        out["bilstm_bwd"][B] = dict(
            shape=shape, max_abs_err=bwd_errs[False], ms=bwd_ms,
            us_per_step=bwd_ms * 1e3 / T,
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
        out["bilstm_proj"][B] = projection_entry(torch, xin, wx, bias, 10)

        if B == batches[0]:
            layer_gradients(torch, xin, wx, wh, bias, gen)
        del xp, h_inf, res, a, c
    out["bilstm_recurrence_train"]["narrow"], out["bilstm_bwd"]["narrow"] = \
        narrow_training_kernels(torch, gen, T, reps=reps)
    for name, by_b in out.items():
        for B, r in by_b.items():
            log("  {:<24s} {:<6s} {:<24s} kernel {:9.4f} ms | plain "
                "{:9.4f} ms | library {:9.4f} ms | bound {:8.4f} ms ({})"
                .format(name, "B={}".format(B) if isinstance(B, int) else B,
                        r["shape"], r["ms"], r["plain_ms"], r["library_ms"],
                        r["bound_ms"], r["bound_by"]))
    return out


def narrow_training_kernels(torch, gen, T=TRAIN_T, B=NARROW_TRAIN_B,
                            D=NARROW[0], F=NARROW[1], reps=5):
    """K4 and K5 at the quality-pin recipe's BiLSTM width (F = 64: 16
    blocks) against their plain versions with the full width's
    tolerances, timed beside cuDNN's LSTM of that width (training
    forward; backward to the input).  Returns (K4's, K5's)
    measurements."""
    from idiaptts_torch.ops import cuda_lstm
    R = 2 * B
    shape = "T={},R={},F={}".format(T, R, F)
    xin, wx, bias = projection_inputs(torch, gen, T, B, D, F)
    xp = cuda_lstm.projection_tmajor_plain(xin, wx, bias)
    wh = (torch.randn(2 * F, 4 * F, generator=gen, device=xp.device)
          / np.sqrt(F)).to(torch.bfloat16)
    h, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh)
    h_p, a_p, c_p = cuda_lstm.recurrence_train_tmajor_plain(xp, wh)
    errs = {"h": (h - h_p).abs().max().item(),
            "a": (a - a_p).abs().max().item(), "c": _rel(c, c_p)}
    for k, e in errs.items():
        _check("rec_train " + k, e, REC_TOL, shape + " f32 res")
    gout = 0.1 * torch.randn(T, R, F, generator=gen, device=xp.device)
    dz = cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
    dz_p = cuda_lstm.dz_bwd_tmajor_plain(a, c, gout, wh)
    _check("bilstm_bwd dz", _rel(dz, dz_p), 1e-3, shape + " f32 res")
    lstm = cudnn_lstm(torch, D, F, xp.device).train()
    x_seq = xin[:, :B].detach().contiguous().requires_grad_()
    lib_fwd = cuda_ms(torch, lambda: lstm(x_seq), reps)
    y_seq, _ = lstm(x_seq)
    gy = torch.randn(y_seq.shape, generator=gen, device=xp.device,
                     dtype=y_seq.dtype)
    rec_ms = cuda_ms(torch, lambda: cuda_lstm.bilstm_recurrence_train_tmajor(
        xp, wh), reps)
    bwd_ms = cuda_ms(torch, lambda: cuda_lstm.dz_bwd_tmajor(a, c, gout, wh),
                     reps)
    rec = dict(shape=shape, max_abs_err=max(errs.values()), ms=rec_ms,
               us_per_step=rec_ms * 1e3 / T,
               plain_ms=cuda_ms(torch, lambda: cuda_lstm
                                .recurrence_train_tmajor_plain(xp, wh), 1),
               library_ms=lib_fwd,
               **dict(zip(("bound_ms", "bound_by"),
                          lstm_bound(T, R, D, F, "rec_train"))))
    bwd = dict(shape=shape, max_abs_err=(dz - dz_p).abs().max().item(),
               ms=bwd_ms, us_per_step=bwd_ms * 1e3 / T,
               plain_ms=cuda_ms(torch, lambda: cuda_lstm
                                .dz_bwd_tmajor_plain(a, c, gout, wh), 1),
               library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                   y_seq, x_seq, gy, retain_graph=True), reps),
               **dict(zip(("bound_ms", "bound_by"),
                          lstm_bound(T, R, D, F, "bwd"))))
    return rec, bwd


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

def make_trainer(torch, device, workdir, epochs=TRAIN_EPOCHS,
                 world_dir=os.path.join(FIXTURES, "WORLD")):
    """AcousticModelTrainer on the fixture corpus with its default model,
    the full-width Interspeech'18 model; the WORLD features and their
    statistics come from ``world_dir``."""
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
        dir_world_features=world_dir)
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


def port_kernel_ms(kernels):
    """Device ms of the LSTM kernels and K2 in a profile_step result, by
    demangled name; the recurrence's template instances are
    <m-tiles, TRAIN, residual type>."""
    def recurrence(train):
        return lambda n: ("bilstm_recurrence_kernel<" in n
                          and (", true" in n) == train)
    picks = (("banded_solve", lambda n: "banded_solve_kernel" in n),
             ("bilstm_proj", lambda n: "bilstm_proj_kernel" in n),
             ("bilstm_recurrence", recurrence(False)),
             ("bilstm_recurrence_train", recurrence(True)),
             ("bilstm_bwd", lambda n: "bilstm_bwd_kernel" in n))
    return {name: sum(v for n, v in kernels.items() if pick(n))
            for name, pick in picks}


def train_handler(device, model_string):
    """A ModularModelHandler for ``model_string`` at the question width,
    Adam at 1e-3 and the masked per-frame MSE."""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.handler import ModularModelHandler
    handler = ModularModelHandler(device=device)
    cfg = convert_legacy_string(model_string, TRAIN_D_IN)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    handler.create_model(cfg)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    handler.set_optimiser(hp)
    handler.set_losses([NamedLoss.Config(
        "mse", "MSELoss", ("pred", "target"), seq_mask="_seq_mask",
        reduction="mean_per_frame")])
    return handler


def random_batch(torch, device, B, T):
    """Seeded random questions and targets of B full-length utterances,
    already on the card (set-up, as a data loader's prefetch would place
    them)."""
    return {
        "questions": torch.from_numpy(np.random.RandomState(0).randn(
            B, T, TRAIN_D_IN).astype(np.float32)).to(device),
        "target": torch.from_numpy(np.random.RandomState(1).randn(
            B, T, TRAIN_D_OUT).astype(np.float32)).to(device),
        "_seq_mask": torch.ones(B, T, 1, device=device),
        "_lengths": {"questions": [T] * B}}


def narrow_train_steps(torch, device, card, steps=NARROW_TRAIN_STEPS,
                       B=NARROW_TRAIN_B, T=TRAIN_T):
    """The quality-pin recipe (``NARROW_MODEL_STRING``, BiLSTM F = 64)
    through the handler's train step on one seeded batch, counters reset
    just before and read just after: every training kernel launched, the
    backward once per BiLSTM layer and step, the loss finite and falling.
    Then the step's CUDA-event time."""
    from idiaptts_torch.ops import dispatch
    handler = train_handler(device, NARROW_MODEL_STRING)
    batch = random_batch(torch, device, B, T)
    layers = sum(int(part.split("_")[0])
                 for part in NARROW_MODEL_STRING.split("-")
                 if "_BiLSTM_" in part)
    dispatch.reset_counts()
    losses = [handler.process_batches([batch])[0] for _ in range(steps)]
    torch.cuda.synchronize()
    launches = dispatch.counts()
    log("  {} B={} T={}: loss per step {} | launches {}".format(
        NARROW_MODEL_STRING, B, T, ["{:.5f}".format(x) for x in losses],
        json.dumps(launches)))
    require_launches(launches, ("bilstm_proj", "bilstm_recurrence_train",
                                "bilstm_bwd"), "narrow training")
    if launches.get("bilstm_bwd", 0) != layers * steps:
        fail("narrow training: bilstm_bwd launched {} times, expected {} "
             "({} BiLSTM layer(s) x {} steps)".format(
                 launches.get("bilstm_bwd", 0), layers * steps, layers,
                 steps))
    if not np.all(np.isfinite(losses)):
        fail("narrow training: non-finite loss {}".format(losses))
    if not losses[-1] < losses[0]:
        fail("narrow training: loss did not fall: {}".format(losses))
    ms = cuda_ms(torch, lambda: handler.process_batches([batch]), 3)
    log("  narrow train step B={} T={}: {:.3f} ms, {:.0f} frames/s [{}]"
        .format(B, T, ms, B * T / (ms / 1e3), card))
    return dict(model=NARROW_MODEL_STRING, B=B, T=T, losses=losses,
                launches=launches, step_ms=ms,
                frames_per_s=B * T / (ms / 1e3))


def time_train_step(torch, device, card, batches=TRAIN_BATCHES, T=TRAIN_T,
                    reps=5):
    """The handler's train step (forward, masked MSE, backward, global
    norm, Adam) at full width on seeded random data already on the card
    (set-up, as a data loader's prefetch would place it)."""
    handler = train_handler(
        device, "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(TRAIN_D_OUT))
    flops = 3 * fwd_flops_per_frame(TRAIN_D_IN, TRAIN_D_OUT)
    out = {}
    for B in batches:
        batch = random_batch(torch, device, B, T)

        def step():
            handler.process_batches([batch])

        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(torch, step, reps)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        fps = B * T / (ms / 1e3)
        kernels = profile_step(torch, step)
        busy = sum(kernels.values())
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
        ours = port_kernel_ms(kernels)
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
                          time_batches=WN_TIME_BATCHES, reps=2,
                          conds=(WN_COND, WN_COND_WIDE)):
    """The sampler kernel against its plain version over T steps at each
    of ``batches`` and each conditioning width of ``conds``, then the
    kernel's time for ``t_time`` steps at each of ``time_batches`` (at
    the first width).  Returns ({B: measurements at T} for the first
    width, with {"C=c,B=b": ...} for the others, {B: timing at
    t_time})."""
    from idiaptts_torch.ops import cuda_wavenet as cw
    out = {}
    for C in conds:
        w = wavenet_model(torch, layers, C).to(device).sampler().weights
        for B in batches:
            key = B if C == conds[0] else "C={},B={}".format(C, B)
            out[key] = _wavenet_check(torch, device, cw, w, T, B)
        if C != conds[0]:
            del w
    w = wavenet_model(torch, layers, conds[0]).to(device).sampler().weights
    gen = torch.Generator(device=device).manual_seed(2025)
    timing = {}
    for B in time_batches:
        cond = 0.3 * torch.randn(t_time, B, w.C, generator=gen,
                                 device=device)
        u = torch.rand(t_time, B, generator=gen, device=device)
        ms = cuda_ms(torch, lambda: cw.sample(w, cond, uniforms=u), reps)
        bound_ms, bound_by = wavenet_bound(w, t_time, B)
        audio_s = B * t_time / FS
        plan = cw.launch_plan(w, B)
        timing[B] = dict(T=t_time, ms=ms, us_per_step=ms * 1e3 / t_time,
                         xrt=audio_s / (ms / 1e3), bound_ms=bound_ms,
                         bound_by=bound_by, plan=plan)
        log("  wavenet_sampler    T={} B={:<3d}: {:9.3f} ms = {:.2f} us/step"
            " = {:.1f}x realtime | bound {:.5f} ms ({}) | cluster of {} "
            "CTAs, G={} row groups a cluster, {} clusters launched, {} "
            "clusters can be resident [plain version not timed at this "
            "T]".format(t_time, B, ms, ms * 1e3 / t_time, timing[B]["xrt"],
                        bound_ms, bound_by, plan["cluster"], plan["G"],
                        plan["clusters"], plan["active_clusters"]))
        if plan["clusters"] > plan["active_clusters"]:
            fail("wavenet_sampler B={}: {} clusters launched, only {} "
                 "resident: a second wave".format(
                     B, plan["clusters"], plan["active_clusters"]))
        del cond, u
    return out, timing


def _wavenet_check(torch, device, cw, w, T, B):
    """One (C, B) of the sampler checks: forced logits, greedy, the free
    run against the plain version, and two launches bit for bit."""
    gen = torch.Generator(device=device).manual_seed(2024 + B + w.C)
    shape = "T={},B={},L={},C={}".format(T, B, len(w.dilations), w.C)
    plan = cw.launch_plan(w, B)
    log("  wavenet_sampler    {}: cluster of {} CTAs (layers {}), G={}, "
        "{} clusters launched, {} can be resident".format(
            shape, plan["cluster"], w.kernel_args()[5].part, plan["G"],
            plan["clusters"], plan["active_clusters"]))
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
    again, _ = cw.sample(w, cond, uniforms=u)
    if not torch.equal(sk, again):
        fail("wavenet_sampler free run {}: two launches on the same "
             "uniforms differ".format(shape))
    else:
        log("  wavenet_sampler    free run {}: two launches on the same "
            "uniforms are equal".format(shape))
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
    log("  wavenet_sampler    {}: kernel {:.3f} ms ({:.2f} us/step) | "
        "plain {:.1f} ms ({:.3f} ms/step) | bound {:.5f} ms ({})".format(
            shape, ms, ms * 1e3 / T, plain_ms, plain_ms / T, bound_ms,
            bound_by))
    return dict(shape=shape, max_abs_err=err, logits_scale=scale,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, plan=plan,
                free_run_rows_identical=same_rows,
                free_run_draws_off=int(off.sum()),
                free_run_worst_margin=worst)


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
    """A one-shot MLPG system from seeded window means (T, 3L) and
    variances (3L,): (means, variances, [b, ab0, ab1, ab2]), the last
    assembled on ``device`` by the port's ``_banded_system`` (1e11 delta
    variances on the boundary frames), each (T, L)."""
    from idiaptts_torch.ops import mlpg
    rs = np.random.RandomState(seed)
    var_np = (rs.rand(3 * L) * 0.5 + 0.05).astype(np.float32)
    feats_np = rs.randn(T, 3, L).astype(np.float32)
    var = mlpg._boundary_variances(var_np, L, T).to(device)
    feats = torch.from_numpy(feats_np).to(device)
    bands, b = mlpg._banded_system(feats, var)
    return (feats.reshape(T, 3 * L), torch.from_numpy(var_np).to(device),
            [b.contiguous()] + [a.contiguous() for a in bands])


def dense_spd(torch, ab0, ab1, ab2):
    """The (L, T, T) symmetric matrices of the lower-banded rows."""
    lower = dense_factor(torch, ab0, ab1, ab2)
    return lower + lower.transpose(1, 2) - torch.diag_embed(ab0.t())


def mlpg_kernel_checks(torch, device, shapes=MLPG_SHAPES, reps=20):
    """K1 against its plain version at each (T, L) of ``shapes``: as
    ``MLPG.generation`` launches it (``mlpg_utterance``: window means and
    variances in, the system assembled in the kernel), and on the system
    assembled outside (``mlpg_oneshot``); CUDA-event times of both, their
    plain versions and the dense library solve.  Returns {(T, L):
    measurements}."""
    from idiaptts_torch.ops import cuda_mlpg
    out = {}
    for seed, (T, L) in enumerate(shapes):
        means, var, args = mlpg_system(torch, device, T, L, seed)
        x_f = cuda_mlpg.mlpg_utterance(means, var)
        x_p = cuda_mlpg.mlpg_utterance_plain(means, var)
        scale = x_p.abs().max().item()
        err = (x_f - x_p).abs().max().item()
        _check("mlpg_oneshot", err / scale, MLPG_ONESHOT_TOL,
               "T={} L={} fused (rel)".format(T, L))
        x_k = cuda_mlpg.mlpg_oneshot(*args)
        x_kp = cuda_mlpg.mlpg_oneshot_plain(*args)
        thin_err = (x_k - x_kp).abs().max().item()
        _check("mlpg_oneshot", thin_err / scale, MLPG_ONESHOT_TOL,
               "T={} L={} assembled (rel)".format(T, L))
        # Library yardstick: dense Cholesky and solve, O(T^3) per lane.
        a = dense_spd(torch, *args[1:])
        rhs = args[0].t().unsqueeze(-1).contiguous()

        def library():
            chol, _ = torch.linalg.cholesky_ex(a)
            return torch.cholesky_solve(rhs, chol)

        lib_x = library().squeeze(-1).t()
        lib_err = (lib_x - x_kp).abs().max().item() / scale
        # The window means and variances read once and the trajectory
        # written once; about 45 float32 operations per element (the
        # system's rows ~25, the factor row ~10, two substitutions 10).
        bound_ms, bound_by = bound(45.0 * T * L, PEAK_F32_FLOPS,
                                   (4 * T * L + 3 * L) * 4)
        ms = cuda_ms(torch, lambda: cuda_mlpg.mlpg_utterance(means, var),
                     reps)
        thin_ms = cuda_ms(torch, lambda: cuda_mlpg.mlpg_oneshot(*args), reps)
        lc, scratch_bytes = cuda_mlpg.oneshot_plan(device, T, L)
        out[(T, L)] = dict(
            shape="T={},L={}".format(T, L), max_abs_err=err,
            max_rel_err=err / scale, bound_ms=bound_ms, bound_by=bound_by,
            ms=ms, us_per_step=ms * 1e3 / (2 * T),
            plain_ms=cuda_ms(torch, lambda: cuda_mlpg.mlpg_utterance_plain(
                means, var), 1),
            library_ms=cuda_ms(torch, library, 3),
            library_rel_err=lib_err,
            library="dense torch.linalg.cholesky_ex + torch.cholesky_solve "
                    "on (L, T, T) float32, O(T^3)",
            lanes_per_block=lc, store_in_shared_memory=scratch_bytes == 0,
            assembled=dict(
                max_abs_err=thin_err, ms=thin_ms,
                bound_ms=bound(20.0 * T * L, PEAK_F32_FLOPS,
                               5 * T * L * 4)[0],
                plain_ms=cuda_ms(torch, lambda: cuda_mlpg.mlpg_oneshot_plain(
                    *args), 1)))
        r = out[(T, L)]
        log("  mlpg_oneshot       T={:<5d} L={:<3d} kernel {:9.4f} ms "
            "({:.3f} us/step; assembled outside {:9.4f} ms) | plain "
            "{:9.3f} ms | library {:9.4f} ms (rel err {:.1e}) | bound "
            "{:.6f} ms ({}) | {} lanes a block".format(
                T, L, r["ms"], r["us_per_step"], thin_ms, r["plain_ms"],
                r["library_ms"], lib_err, bound_ms, bound_by, lc))
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


# -- phase 10 ----------------------------------------------------------------

def read_pins(names=("PINNED_ACOUSTIC", "PINNED_DURATION_RMSE")):
    """The named pins from the pin file's text (it imports the JAX
    package, so it is parsed, not imported)."""
    import ast
    with open(PIN_FILE) as f:
        tree = ast.parse(f.read())
    values = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in names:
            values[node.targets[0].id] = ast.literal_eval(node.value)
    return tuple(values[n] for n in names)


def check_pinned(key, got, pinned):
    ok = np.isfinite(got) and got <= pinned + max(abs(pinned) * PIN_TOL,
                                                  1e-3)
    log("  pin {}: {:.4f} (pin {}, one-sided tolerance {:.0%}){}".format(
        key, got, pinned, PIN_TOL, "" if ok else "  <-- FAILED"))
    if not ok:
        fail("quality pin {}: {} > {} + {:.0%}".format(key, got, pinned,
                                                       PIN_TOL))


def pin_hparams(cls, device, out_dir, model_name):
    hp = cls.create_hparams()
    hp.device = str(device)
    hp.out_dir = out_dir
    hp.model_name = model_name
    hp.epochs = PIN_EPOCHS
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.use_best_as_final_model = True
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    return hp


def from_jax_draw(trainer):
    """Load the JAX package's initial weights of the trainer's model."""
    from idiaptts_torch.models import convert, flax_init
    handler = trainer.model_handler
    convert.load_flax_params(handler.model,
                             flax_init.model_params(handler.model_config))


def fixture_ids():
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def pin_phone_questions(out_dir, ids):
    """The duration pin recipe's inputs from the port's gen_data: the
    frame questions of each phone's first frame, with min-max stats."""
    from idiaptts_torch.data.normalisation import MinMaxExtractor
    from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_torch.data.questions import QuestionLabelGen
    label_dict, _, _ = QuestionLabelGen.gen_data(
        os.path.join(FIXTURES, "labels", "label_state_align"),
        QUESTION_FILE, id_list=ids, return_dict=True)
    os.makedirs(out_dir, exist_ok=True)
    extractor = MinMaxExtractor()
    for id_name, frames in label_dict.items():
        dur = PhonemeDurationLabelGen.load_sample(
            id_name, os.path.join(FIXTURES, "dur"))
        phone_frames = dur.sum(axis=1).astype(np.int64)
        first = np.minimum(np.cumsum(phone_frames) - phone_frames,
                           len(frames) - 1)
        extractor.add_sample(frames[first])
        frames[first].astype(np.float32).tofile(
            os.path.join(out_dir, id_name + ".questions"))
    extractor.save(os.path.join(out_dir, "all"))
    return out_dir


def dm_am_phone_questions(out_dir, ids):
    """run_DM_AM's own duration inputs: the question answers of each
    phone of the fixture labels (no subphone columns), min-max stats."""
    from idiaptts_torch.data.normalisation import MinMaxExtractor
    from idiaptts_torch.data.questions import HTSLabelNormalisation
    from idiaptts_torch.synth.tts_model import TTSModel
    operator = HTSLabelNormalisation(QUESTION_FILE, add_frame_features=False,
                                     subphone_feats="none")
    os.makedirs(out_dir, exist_ok=True)
    extractor = MinMaxExtractor()
    for id_name in ids:
        with open(os.path.join(FIXTURES, "labels", "label_state_align",
                               id_name + ".lab")) as f:
            labels = TTSModel.strip_timings([l for l in f if l.strip()])
        q = TTSModel.phone_question_matrix(operator, labels)
        extractor.add_sample(q)
        q.tofile(os.path.join(out_dir, id_name + ".questions"))
    extractor.save(os.path.join(out_dir, "all"))
    return out_dir, operator.dict_size


def train_duration(torch, device, workdir, name, q_dir, num_questions):
    """DurationModelTrainer with its default full-width model on the card,
    the pin recipe's settings, from the JAX draw; (trainer, hp, train s,
    train losses)."""
    from idiaptts_torch.train.duration import DurationModelTrainer
    hp = pin_hparams(DurationModelTrainer, device, workdir, name)
    hp.num_questions = num_questions
    trainer = DurationModelTrainer(
        hp, fixture_ids(), dir_phoneme_labels=q_dir,
        dir_durations=os.path.join(FIXTURES, "dur"))
    trainer.init(hp)
    from_jax_draw(trainer)
    (_, train_loss), seconds = _timed(torch, lambda: trainer.train(hp))
    return trainer, hp, seconds, train_loss


def duration_pin(torch, device, workdir, pinned):
    """(a) The duration pin recipe on the card: Dur RMSE one-sided
    against the pin."""
    ids = fixture_ids()
    _, _, num_q = load_corpus()
    trainer, hp, seconds, losses = train_duration(
        torch, device, workdir, "pin_dur",
        pin_phone_questions(os.path.join(workdir, "pin_dur_q"), ids), num_q)
    rmse, pearson = trainer.benchmark(hp, trainer.id_list_train)
    log("  duration pin recipe: {} epochs in {:.2f} s, train loss {:.4f} "
        "-> {:.4f}; Dur RMSE {:.4f}, Pearson {}".format(
            PIN_EPOCHS, seconds, losses[0], losses[-1], float(rmse),
            np.round(pearson, 4).tolist()))
    check_pinned("dur_rmse", float(rmse), pinned)
    return {"dur_rmse": float(rmse), "train_s": seconds}


def acoustic_pin(torch, device, workdir, pinned):
    """(b) The acoustic pin recipe on the card: 12 epochs with the launch
    counters reset just before and read just after, the four scores
    one-sided against the pins, and its synth's loudness (ROADMAP fault
    3.7)."""
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.ops import dispatch
    from idiaptts_torch.train.acoustic import AcousticModelTrainer
    _, _, num_q = load_corpus()
    ids = fixture_ids()
    hp = pin_hparams(AcousticModelTrainer, device, workdir, "pin_acoustic")
    hp.num_questions = num_q
    hp.num_coded_sps = NUM_SPS
    hp.batch_size_benchmark = 6
    hp.batch_size_synth = 6
    hp.synth_fs = FS
    trainer = AcousticModelTrainer(
        hp, ids, dir_question_labels=os.path.join(FIXTURES, "questions"),
        dir_world_features=os.path.join(FIXTURES, "WORLD"))
    cfg = convert_legacy_string(NARROW_MODEL_STRING, num_q)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg)
    from_jax_draw(trainer)
    dispatch.reset_counts()
    (_, losses), seconds = _timed(torch, lambda: trainer.train(hp))
    launches = dispatch.counts()
    log("  acoustic pin recipe {}: {} epochs in {:.2f} s, train loss "
        "{:.4f} -> {:.4f}".format(NARROW_MODEL_STRING, PIN_EPOCHS, seconds,
                                  losses[0], losses[-1]))
    log("  launches during the pin recipe's training:",
        json.dumps(launches))
    require_launches(launches, PIN_KERNELS, "pin training")
    scores = trainer.benchmark(hp, trainer.id_list_train)
    got = dict(zip(("mcd", "f0_rmse", "vde", "bap"),
                   (float(v) for v in scores)))
    for key in ("mcd", "f0_rmse", "vde", "bap"):
        check_pinned(key, got[key], pinned[key])
    # Fault 3.7: is a model trained this long audible?  Its own fused
    # synth, and the statics that decide how loud it is.
    hp.synth_dir = os.path.join(workdir, "pin_synth")
    paths = trainer.synth(hp, ids)
    post = trainer.forward(hp, ids)
    loud = {}
    for i in ids:
        raw, _ = _wav_ok(paths[i], len(post[i]["pred_acoustic_features"]))
        c0, _, voiced, bap_uv = _witness(post[i]["pred_acoustic_features"])
        loud[i] = {"rms": float(np.sqrt(np.mean(raw.astype(np.float64)
                                                ** 2))),
                   "peak": float(np.abs(raw).max()), "c0_mean": c0,
                   "voiced_share": voiced, "unvoiced_bap": bap_uv}
        log("  pin model synth {}: rms {:.3e}, peak {:.3e}; c0 mean {:.2f}, "
            "voiced share {:.3f}, unvoiced bap {:.2f}".format(
                i, loud[i]["rms"], loud[i]["peak"], c0, voiced, bap_uv))
    audible = sum(v["peak"] > 1e-3 for v in loud.values())
    log("  pin model synth: {} of {} utterances audible (peak > 1e-3)"
        .format(audible, len(ids)))
    return {"scores": got, "train_s": seconds, "launches": launches,
            "loudness": loud, "audible": audible}


def _aligned_durations(path):
    """A state-aligned label file -> (P, 5) frames."""
    frames = []
    with open(path) as f:
        for line in f:
            start, end, label = line.split()
            if label.endswith("[2]"):
                frames.append([])
            frames[-1].append((int(end) - int(start)) // 50000)
    return np.array(frames)


def text_to_wav(torch, hp, workdir, ids):
    """(c) run_DM_AM on the fixture labels, fused and modular, counters
    and the native matcher's count reset just before each run and read
    just after; wall seconds split into the front half and the synth."""
    from idiaptts_torch.data import native_questions
    from idiaptts_torch.ops import dispatch
    from idiaptts_torch.synth.tts_model import TTSModel
    trainer = hp.acoustic_trainer
    plain_synth = trainer.synth
    out = {}
    for mode, fused, kernels in (("fused", True, TEXT_FUSED_KERNELS),
                                 ("modular", False, TEXT_MODULAR_KERNELS)):
        hp.use_fused_synth = fused
        hp.synth_dir = os.path.join(workdir, "text_" + mode)
        synth_s = []

        def timed_synth(*args, **kwargs):
            result, seconds = _timed(torch, lambda: plain_synth(*args,
                                                                **kwargs))
            synth_s.append(seconds)
            return result

        trainer.synth = timed_synth
        native_questions.reset_count()
        dispatch.reset_counts()
        try:
            paths, total = _timed(torch, lambda: TTSModel.run_DM_AM(
                hp, label_dir=os.path.join(FIXTURES, "labels",
                                           "label_state_align"),
                id_list=ids))
        finally:
            del trainer.synth
        launches = dispatch.counts()
        matched = native_questions.matches
        log("  run_DM_AM {}: {:.3f} s wall, front half {:.3f} s, synth "
            "{:.3f} s; native matcher: {} labels".format(
                mode, total, total - synth_s[0], synth_s[0], matched))
        log("  launches during run_DM_AM {}: {}".format(
            mode, json.dumps(launches)))
        require_launches(launches, kernels, "text ({})".format(mode))
        if not matched:
            fail("run_DM_AM {}: the native question matcher was not used"
                 .format(mode))
        if sorted(paths) != sorted(ids):
            fail("run_DM_AM {} wrote {}".format(mode, sorted(paths)))
        frames = {}
        for i in ids:
            dur = _aligned_durations(os.path.join(
                hp.synth_dir, "label_state_align", i + ".lab"))
            frames[i] = int(dur.sum())
            raw, ok = _wav_ok(paths[i], frames[i])
            if not (dur.min() >= 1 and ok):
                fail("run_DM_AM {} {}: min duration {}, {} samples (want "
                     "{} finite)".format(mode, i, dur.min(), raw.size,
                                         frames[i] * 80))
        out[mode] = {"wall_s": total, "front_half_s": total - synth_s[0],
                     "synth_s": synth_s[0], "launches": launches,
                     "native_matches": matched, "frames": frames}
    hp.use_fused_synth = True
    return out


def serve_text(torch, hp, workdir):
    """(d) TTSModel.serve: SERVE_TEXTS submitted at once, each future
    resolving to a finite waveform; requests share batches; per-request
    latency and the host/device split; one request against the port's
    CPU path on the same weights with the card's noise draw, by frame
    energy."""
    from idiaptts_torch.ops import dispatch
    from idiaptts_torch.ops.world.synthesis import noise_draw
    from idiaptts_torch.synth.tts_model import TTSModel
    hp.synth_dir = os.path.join(workdir, "text_serve")
    server = TTSModel.serve(hp, max_batch=16, max_wait_ms=200.0)

    def request(text):
        t0 = time.perf_counter()
        wav = server.submit(text).result(timeout=900)
        return wav, time.perf_counter() - t0

    dispatch.reset_counts()
    try:
        with ThreadPoolExecutor(len(SERVE_TEXTS)) as pool:
            results = list(pool.map(request, SERVE_TEXTS))
        torch.cuda.synchronize()
        launches = dispatch.counts()
        stats = server.stats()
        questions = server.front_half(SERVE_TEXTS[0])
    finally:
        server.shutdown()
    wavs = [w for w, _ in results]
    latency = [s for _, s in results]
    log("  served {} texts: {}".format(len(wavs), json.dumps(stats)))
    log("  latency per request s: {}; front half (host) {:.4f} s a "
        "request; synthesis batches {:.4f} s a batch".format(
            np.round(latency, 4).tolist(),
            stats["front_seconds"] / stats["requests"],
            stats["busy_seconds"] / max(stats["batches"], 1)))
    log("  launches while serving text:", json.dumps(launches))
    require_launches(launches, TEXT_FUSED_KERNELS, "text serving")
    if not all(w.size > 0 and np.all(np.isfinite(w)) for w in wavs):
        fail("a served text gave an empty or non-finite waveform")
    if not stats["mean_batch_occupancy"] > 1.0:
        fail("served texts did not share batches: {}".format(stats))
    # The first request on the CPU path: the same questions (the card's
    # durations), the same weights, the card's noise draw.
    trainer = hp.acoustic_trainer
    pipeline, params, _ = trainer.build_serving(hp)
    cpu = cpu_trainer(trainer)
    cpu_pipe, cpu_params, _ = cpu.build_serving(hp)
    batch, lengths, f0c = cpu_pipe.prepare([questions])
    T = batch.shape[1]
    nb_small = max(min(pipeline.num_bins, 129),
                   pipeline.hop // 2 + 1 + (pipeline.hop % 2))
    z = noise_draw(T, nb_small, torch.Generator(
        device=pipeline.device).manual_seed(0), pipeline.device).cpu()
    with torch.inference_mode():
        out = cpu_pipe.model_stage(cpu_params, batch, lengths)
        sm, vuv = cpu_pipe.mlpg_stage(out, lengths, *cpu_pipe.factors_for(T))
        w_cpu = cpu_pipe.vocoder_stage(sm, vuv, f0c, z=z)[0].numpy()
    w_cpu = w_cpu[:len(questions) * pipeline.hop]
    if w_cpu.shape != wavs[0].shape:
        fail("served text 0: {} samples on the card, {} on the CPU path"
             .format(wavs[0].shape, w_cpu.shape))
        db = float("inf")
    else:
        db = _max_frame_db([wavs[0]], [w_cpu])
    c0_std = float(np.asarray(
        trainer.datareaders["cmp_features"].norm_params[1]).reshape(-1)[0])
    _check("served text vs CPU path (frame energy, dB)", db,
           20.0 * np.log10(np.e) * SERVE_C0_ULPS * c0_std,
           "T={}".format(len(questions)))
    return {"latency_s": latency, "stats": stats, "launches": launches,
            "cpu_frame_db": db}


def text_front_door(torch, device, card, workdir, trainer, hp):
    """Phase 10: (a) the duration pin, (b) the acoustic pin, (c) run_DM_AM
    and (d) TextToSpeechServer with phase 6's acoustic model and a
    duration model trained on run_DM_AM's own phone questions."""
    pin_acoustic, pin_dur = read_pins()
    log("== phase 10 (a): duration pin recipe at full width on {} [{}]"
        .format(device, card))
    dur_pin = duration_pin(torch, device, workdir, pin_dur)
    torch.cuda.empty_cache()
    log("== phase 10 (b): acoustic pin recipe {} on {} [{}]".format(
        NARROW_MODEL_STRING, device, card))
    ac_pin = acoustic_pin(torch, device, workdir, pin_acoustic)
    torch.cuda.empty_cache()
    log("== phase 10 (c): run_DM_AM on the fixture labels with phase 6's "
        "model [{}]".format(card))
    # The pin recipe's inputs carry the 9 subphone columns of each
    # phone's first frame; run_DM_AM feeds its duration model the
    # answers alone, so (c) and (d) use one trained on those.
    ids = fixture_ids()
    q_dir, dict_size = dm_am_phone_questions(
        os.path.join(workdir, "dm_am_dur_q"), ids)
    dur_trainer, _, dur_s, _ = train_duration(
        torch, device, workdir, "dm_am_dur", q_dir, dict_size)
    log("  run_DM_AM's duration model ({} inputs): {} epochs in {:.2f} s"
        .format(dict_size, PIN_EPOCHS, dur_s))
    hp.add_hparams(duration_trainer=dur_trainer, acoustic_trainer=trainer)
    hp.question_file = QUESTION_FILE
    hp.batch_size_synth = len(ids)
    text = text_to_wav(torch, hp, workdir, ids)
    log("== phase 10 (d): TextToSpeechServer, {} texts at once [{}]".format(
        len(SERVE_TEXTS), card))
    served = serve_text(torch, hp, workdir)
    launches = {k: text["fused"]["launches"].get(k, 0)
                + text["modular"]["launches"].get(k, 0)
                + served["launches"].get(k, 0)
                for k in KERNEL_SOURCES}
    log("  phase 10 times [{}]: {}".format(card, json.dumps({
        "run_DM_AM": {m: {k: text[m][k] for k in ("wall_s", "front_half_s",
                                                   "synth_s")}
                      for m in ("fused", "modular")},
        "serve_latency_s": served["latency_s"],
        "serve_front_s_per_request": served["stats"]["front_seconds"]
        / served["stats"]["requests"],
        "serve_busy_s_per_batch": served["stats"]["busy_seconds"]
        / max(served["stats"]["batches"], 1)})))
    log("  phase 10 pins [{}]: {}".format(card, json.dumps({
        "duration": dur_pin, "acoustic": ac_pin["scores"],
        "pins": {"acoustic": pin_acoustic, "dur_rmse": pin_dur},
        "tolerance": PIN_TOL})))
    return {"launches": launches, "pin_launches": ac_pin["launches"],
            "dur_pin": dur_pin, "acoustic_pin": ac_pin, "text": text,
            "served": served}


# -- phase 11 ----------------------------------------------------------------

def model_trainer(torch, device, workdir, name, model_string, epochs,
                  speaker=False, profiler_dir=None):
    """AcousticModelTrainer on the fixture corpus with ``model_string``
    from the JAX package's initial draw; with ``speaker``, a per-utterance
    speaker index from a CategoryDataReader is the model's second input
    (``input_names = ("questions", "speaker")``)."""
    from idiaptts_torch.data.category import CategoryDataReader
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.acoustic import AcousticModelTrainer
    _, _, num_q = load_corpus()
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
    hp.model_name = name
    hp.profiler_dir = profiler_dir
    trainer = AcousticModelTrainer(
        hp, fixture_ids(),
        dir_question_labels=os.path.join(FIXTURES, "questions"),
        dir_world_features=os.path.join(FIXTURES, "WORLD"))
    readers = trainer.default_data_reader_configs(hp)
    if speaker:
        readers.append(CategoryDataReader.Config(
            name="speaker", get_category_fn=speaker_of))
    cfg = convert_legacy_string(model_string, num_q + int(speaker))
    cfg.input_names = ("questions", "speaker") if speaker \
        else ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg, data_reader_configs=readers)
    from_jax_draw(trainer)
    return trainer, hp


def speaker_of(id_name):
    """A fixed speaker index in [0, NUM_SPEAKERS) for each fixture id."""
    return [float(int(id_name.rsplit("-", 1)[-1]) * 37 % NUM_SPEAKERS)]


def counted(torch, fn):
    """fn() with the launch counters reset just before and read just
    after: (result, launches)."""
    from idiaptts_torch.ops import dispatch
    torch.cuda.synchronize()
    dispatch.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dispatch.counts()


def icassp19(torch, device, card, workdir):
    """(a) The ICASSP'19 BiGRU preset at full width: served through
    FusedAcousticPipeline (B = 6 and 48), held against the CPU path,
    timed, then trained one epoch through AcousticModelTrainer."""
    questions, model, make_pipeline = build_slice(
        torch, device, ICASSP19_MODEL_STRING, d_in=ICASSP19_D_IN,
        jax_draw=True)
    pipeline = make_pipeline(device)
    pipeline.factors_for(T_BUCKET)
    with torch.inference_mode():
        wavs, serve_launches = counted(torch, lambda: pipeline(
            model, questions))
    log("  launches serving the six utterances:", json.dumps(
        serve_launches))
    require_launches(serve_launches, ("banded_solve",), "ICASSP'19 serving")
    if any(serve_launches.get(k, 0) for k in BILSTM_KERNELS):
        fail("a BiLSTM kernel launched serving the BiGRU model")
    check_waveforms(wavs, questions, pipeline.hop)
    db = check_against_cpu(torch, pipeline, make_pipeline("cpu"), model,
                           questions, model_tol=ICASSP19_MODEL_TOL,
                           frame_db_tol=ICASSP19_DB_TOL)
    # Two runs a mean: the host-bound loop varies little (PERF.md, PR 11).
    timing = time_slice(torch, pipeline, model, questions, card, reps=2)
    del pipeline, model
    torch.cuda.empty_cache()

    trainer, hp = model_trainer(torch, device, workdir, "icassp19",
                                ICASSP19_MODEL_STRING, epochs=1)
    hp.start_with_test = False
    handler = trainer.model_handler

    def train_set_loss():
        return handler.process_batches(trainer._batches(
            trainer.dataset_train, trainer.id_list_train,
            hp.batch_size_train), training=False)[0]

    before = train_set_loss()
    (_, train_loss), train_launches = counted(
        torch, lambda: trainer.train(hp))
    after = train_set_loss()
    log("  one epoch: training-set loss {} -> {} (epoch mean {})".format(
        before, after, train_loss))
    if not (np.isfinite(after) and after < before):
        fail("ICASSP'19 training: the training-set loss did not fall: "
             "{} -> {}".format(before, after))
    if any(train_launches.get(k, 0) for k in BILSTM_KERNELS):
        fail("a BiLSTM kernel launched training the BiGRU model: {}"
             .format(train_launches))
    del trainer, handler
    handler = train_handler(device, ICASSP19_MODEL_STRING)
    batch = random_batch(torch, device, GRU_TRAIN_B, T_BUCKET)
    step_ms = cuda_ms(torch, lambda: handler.process_batches([batch]), 1)
    log("  BiGRU train step B={} T={}: {:.1f} ms, {:.0f} frames/s [{}]"
        .format(GRU_TRAIN_B, T_BUCKET, step_ms,
                GRU_TRAIN_B * T_BUCKET / (step_ms / 1e3), card))
    del handler
    torch.cuda.empty_cache()
    return dict(serve_launches=serve_launches, train_launches=train_launches,
                cpu_frame_db=db, timing=timing,
                train_set_loss=(before, after),
                train_step=dict(B=GRU_TRAIN_B, T=T_BUCKET, ms=step_ms))


def emb_preset(torch, device, card, workdir):
    """(b) The speaker-embedding BiLSTM preset at full width with a
    speaker index as the second input: trained one epoch (K7's
    projection, K4 and K5), with the profiler and TensorBoard on (e),
    then served through build_serving and serve (K6's projection, K3,
    K2), held against the CPU path and timed."""
    profiler_dir = os.path.join(workdir, "profile_emb")
    trainer, hp = model_trainer(torch, device, workdir, "emb",
                                EMB_MODEL_STRING, epochs=1, speaker=True,
                                profiler_dir=profiler_dir)
    (val_loss, train_loss), train_launches = counted(
        torch, lambda: trainer.train(hp))
    log("  launches during training:", json.dumps(train_launches))
    require_launches(train_launches, TRAIN_KERNELS, "EMB training")
    if not (np.all(np.isfinite(val_loss)) and np.all(np.isfinite(
            train_loss))):
        fail("EMB training: non-finite loss {} {}".format(val_loss,
                                                          train_loss))
    front_doors = profiler_and_tensorboard(trainer, hp, profiler_dir)

    pipeline, params, load_inputs = trainer.build_serving(hp)
    ids = fixture_ids()
    inputs = [load_inputs(i) for i in ids]
    for i, q in zip(ids, inputs):
        if not np.all(q[:, -1] == speaker_of(i)[0]):
            fail("EMB serving: speaker column of {} wrong".format(i))
    pipeline.factors_for(T_BUCKET)
    server = trainer.serve(hp, max_batch=8, max_wait_ms=200)
    try:
        def submit_all():
            futures = [server.submit(q) for q in inputs]
            return [f.result(timeout=900) for f in futures]
        wavs, serve_launches = counted(torch, submit_all)
    finally:
        server.shutdown()
    log("  launches serving the six utterances:", json.dumps(
        serve_launches))
    require_launches(serve_launches, SERVE_KERNELS, "EMB serving")
    for w, q in zip(wavs, inputs):
        if w.shape != (len(q) * pipeline.hop,) or not np.all(
                np.isfinite(w)):
            fail("EMB serving: waveform shape {} or non-finite".format(
                w.shape))
    cpu_pipe = cpu_trainer(trainer).build_serving(hp)[0]
    db = check_against_cpu(torch, pipeline, cpu_pipe, params, inputs,
                           frame_db_tol=EMB_DB_TOL)
    timing = time_slice(torch, pipeline, params, inputs, card)
    del trainer, pipeline, params, server
    torch.cuda.empty_cache()
    return dict(train_launches=train_launches, serve_launches=serve_launches,
                val_loss=val_loss, train_loss=train_loss, cpu_frame_db=db,
                timing=timing, front_doors=front_doors)


def profiler_and_tensorboard(trainer, hp, profiler_dir):
    """(e) The torch.profiler trace of ``trainer.train``, and the
    TensorBoard event file when tensorboardX is importable."""
    import glob
    traces = glob.glob(os.path.join(profiler_dir, "*.json"))
    if not traces:
        fail("train with profiler_dir wrote no trace in " + profiler_dir)
    out = {"trace_bytes": sum(os.path.getsize(t) for t in traces)}
    if trainer.summary_writer is None:
        log("  tensorboardX is not importable here: no event file written")
        out["tensorboard"] = "tensorboardX not importable"
    else:
        trainer.summary_writer.flush()
        events = glob.glob(os.path.join(hp.out_dir, hp.model_name,
                                        "tensorboard", "events.out.*"))
        if not events:
            fail("no TensorBoard event file written")
        out["tensorboard"] = "event file written"
    log("  profiler trace {} bytes; TensorBoard: {}".format(
        out["trace_bytes"], out["tensorboard"]))
    return out


def small_models(torch, device, card):
    """(c) One small model per remaining layer type on the card against
    the CPU path on the same converted weights (the JAX draw)."""
    from idiaptts_torch.models import convert, flax_init
    from idiaptts_torch.models import rnn_dyn
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(SMALL_B, SMALL_T, SMALL_D_IN).astype(
        np.float32))
    lengths = torch.tensor([SMALL_T, SMALL_T - 37, SMALL_T - 91,
                            SMALL_T - 150])
    out = {}
    for model_string in SMALL_MODELS:
        cfg = rnn_dyn.convert_legacy_string(model_string, SMALL_D_IN)
        model_c = cfg.create_model()
        model_c.load_state_dict(convert.flax_to_state_dict(
            {k: v["wrapped"]["inner"] for k, v in
             flax_init.rnn_dyn_params(cfg).items()}))
        model_g = copy.deepcopy(model_c).to(device)
        res = {}
        for training in (False, True):
            with torch.no_grad():
                ref = model_c(x, lengths=lengths, training=training)
                got = model_g(x.to(device), lengths=lengths.to(device),
                              training=training)
            err = (got.cpu() - ref).abs().max().item()
            top = ref.abs().max().item()
            res["training" if training else "inference"] = err / top
            _check("small", err, SMALL_TOL * top, "{} {}".format(
                model_string.split("-", 1)[1][:40],
                "train" if training else "eval"))
        with torch.no_grad():
            res["forward_ms"] = cuda_ms(torch, lambda: model_g(
                x.to(device), lengths=lengths.to(device)), 3)
        out[model_string] = res
    out["vae"] = vae_training(torch, device, x, lengths)
    out["always_dropout"] = always_dropout(torch, device, x)
    log("  small models [{}]: {}".format(card, json.dumps(out)))
    return out


def vae_training(torch, device, x, lengths):
    """A VAE trained a few handler steps on the card with the masked MSE
    and VAEKLDLoss (mu and logvar from the forward's intermediates): the
    KLD is positive and the summed loss falls; its inference forward
    matches the CPU's."""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.handler import ModularModelHandler
    cfg = convert_legacy_string(VAE_MODEL_STRING, SMALL_D_IN)
    cfg.input_names, cfg.output_names = ("questions",), ("pred",)
    handler = ModularModelHandler(device=device)
    handler.create_model(cfg)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    handler.set_optimiser(hp)
    handler.set_losses([
        NamedLoss.Config("mse", "MSELoss", ("pred", "target"),
                         seq_mask="_seq_mask", reduction="mean_per_frame"),
        NamedLoss.Config("kld", "VAEKLDLoss", ("vae_mu",),
                         reduction="mean")])
    cpu_model = copy.deepcopy(handler.model).to("cpu")
    with torch.no_grad():
        ref = cpu_model({"questions": x}, lengths=lengths)["pred"]
        got = handler.model({"questions": x.to(device)},
                            lengths=lengths.to(device))["pred"]
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    _check("vae", err, SMALL_TOL, "inference, relative")
    mask = (torch.arange(SMALL_T)[None, :] < lengths[:, None]).float()
    batch = {"questions": x.to(device),
             "target": torch.from_numpy(np.random.RandomState(3).randn(
                 SMALL_B, SMALL_T, 67).astype(np.float32)).to(device),
             "_seq_mask": mask[..., None].to(device),
             "_lengths": {"questions": lengths.tolist()}}
    losses = [handler.process_batches([batch])[1] for _ in range(VAE_STEPS)]
    total = [v["mse"] + v["kld"] for v in losses]
    if not (losses[0]["kld"] > 0 and total[-1] < total[0]):
        fail("VAE training: kld {} total {}".format(
            [v["kld"] for v in losses], total))
    return dict(relative_err=err, losses=losses)


def always_dropout(torch, device, x):
    """AlwaysDropout (active at inference) with a seeded generator on the
    card: the same mask twice, about p of the values dropped, the kept
    ones the CPU model's without the group, scaled by 1 / (1 - p)."""
    from idiaptts_torch.models import rnn_dyn
    layers = [rnn_dyn.LayerConfig("Linear", out_dim=64, nonlin="ReLU"),
              rnn_dyn.LayerConfig("Linear", out_dim=67)]
    plain = rnn_dyn.RNNDyn.Config(in_dim=SMALL_D_IN,
                                  layer_configs=layers).create_model()
    cfg = rnn_dyn.RNNDyn.Config(in_dim=SMALL_D_IN, layer_configs=layers + [
        rnn_dyn.LayerConfig("AlwaysDropout", dropout=ALWAYS_DROPOUT)])
    model = cfg.create_model().to(device)
    model.load_state_dict(plain.state_dict())

    def run():
        with torch.no_grad():
            return model(x.to(device), generator=torch.Generator(
                device=device).manual_seed(5))

    a, b = run(), run()
    kept = a != 0
    dropped = 1.0 - kept.float().mean().item()
    with torch.no_grad():
        ref = (plain(x) / (1.0 - ALWAYS_DROPOUT)).to(torch.bfloat16)
    err = (a.cpu() - ref.float())[kept.cpu()].abs().max().item()
    top = ref.float().abs().max().item()
    if not torch.equal(a, b):
        fail("AlwaysDropout: a seeded generator gave two masks")
    if not abs(dropped - ALWAYS_DROPOUT) < 0.02:
        fail("AlwaysDropout: dropped share {}".format(dropped))
    # The bf16 Dense output scaled in bf16: 2 bf16 ulps at its magnitude
    # (measured 1.2e-4 against 3.2e-2 on an H100).
    _check("always_dropout", err, 2.0 ** -7 * top, "kept values")
    return dict(dropped_share=dropped, max_abs_err=err)


def residual_trajectory(torch, device, card):
    """(d) The full-width Interspeech'18 train step at T = 1024 and
    B = 64 (above 32 rows a device) from one seeded init, float32 against
    bf16 BiLSTM residuals: the loss after RESIDUAL_STEPS steps on one
    seeded batch and the ms a step of each."""
    batch = random_batch(torch, device, RESIDUAL_B, TRAIN_T)
    out = {}
    for bf16 in (False, True):
        handler = train_handler(device, "RNNDYN-2_RELU_1024-3_BiLSTM_512-"
                                "1_FC_{}".format(TRAIN_D_OUT))
        if handler.residuals_bf16_for(RESIDUAL_B) is not True:
            fail("the default residual rule does not pick bf16 at B={}"
                 .format(RESIDUAL_B))
        handler.residuals_bf16 = bf16
        losses = [handler.process_batches([batch])[0]
                  for _ in range(RESIDUAL_STEPS)]
        ms = cuda_ms(torch, lambda: handler.process_batches([batch]), 3)
        key = "bf16" if bf16 else "float32"
        out[key] = dict(first_loss=losses[0], loss=losses[-1], step_ms=ms)
        log("  residuals {}: loss {:.6f} -> {:.6f} after {} steps, {:.3f} "
            "ms a step at B={} T={} [{}]".format(
                key, losses[0], losses[-1], RESIDUAL_STEPS, ms, RESIDUAL_B,
                TRAIN_T, card))
        del handler
        torch.cuda.empty_cache()
    rel = abs(out["bf16"]["loss"] - out["float32"]["loss"]) \
        / out["float32"]["loss"]
    out["relative_loss_difference"] = rel
    # The default follows the JAX rule because the CPU trajectory test
    # keeps bf16 within 1% of float32; hold the card to the same bound.
    _check("residuals", rel, 0.01, "bf16 vs float32 loss, relative")
    return out


def remaining_layers(torch, device, card, workdir):
    """Phase 11: the ICASSP'19 preset, the EMB preset with a second
    input, one small model per remaining layer type, the residual
    trajectory and the trainer's profiler and TensorBoard front doors."""
    log("== phase 11 (a): ICASSP'19 preset {} at full width on {} [{}]"
        .format(ICASSP19_MODEL_STRING, device, card))
    walls = {"start": time.perf_counter()}
    gru = icassp19(torch, device, card, workdir)
    walls["a"] = time.perf_counter()
    log("== phase 11 (b, e): EMB preset {} with a speaker input on {} [{}]"
        .format(EMB_MODEL_STRING, device, card))
    emb = emb_preset(torch, device, card, workdir)
    walls["b"] = time.perf_counter()
    log("== phase 11 (c): one small model per remaining layer type [{}]"
        .format(card))
    small = small_models(torch, device, card)
    walls["c"] = time.perf_counter()
    log("== phase 11 (d): BiLSTM residual precision at B={} T={} [{}]"
        .format(RESIDUAL_B, TRAIN_T, card))
    residuals = residual_trajectory(torch, device, card)
    walls["d"] = time.perf_counter()
    wall = walls["d"] - walls["start"]
    log("  phase 11 [{}]: {}".format(card, json.dumps({
        "wall_s": wall,
        "wall_s_by_part": {k: walls[k] - walls[p] for p, k in zip(
            ("start", "a", "b", "c"), ("a", "b", "c", "d"))},
        "icassp19": {"xrt": {str(b): v["xrt"] for b, v in
                             gru["timing"].items()},
                     "split_ms": {str(b): {k: v[k] for k in (
                         "model_ms", "mlpg_ms", "vocoder_ms", "total_ms")}
                         for b, v in gru["timing"].items()},
                     "idle_share": {str(b): v["idle_share"] for b, v in
                                    gru["timing"].items()},
                     "train_step": gru["train_step"],
                     "cpu_frame_db": gru["cpu_frame_db"]},
        "emb": {"xrt": {str(b): v["xrt"] for b, v in
                        emb["timing"].items()},
                "cpu_frame_db": emb["cpu_frame_db"],
                "front_doors": emb["front_doors"]},
        "residuals": residuals})))
    return dict(icassp19=gru, emb=emb, small=small, residuals=residuals,
                wall_s=wall)


# -- phase 12 ----------------------------------------------------------------

def _corpus_ids(sub):
    return sorted(os.path.splitext(n)[0] for n in os.listdir(
        os.path.join(FIXTURES, "database", sub)) if n.endswith(".wav"))


def _wav(sub, id_name):
    from idiaptts_torch.ops import audio_io
    return audio_io.get_raw(os.path.join(FIXTURES, "database", sub,
                                         id_name + ".wav"))


def extract_corpora(torch, device, workdir, card):
    """gen_data on ``device`` of the 16 kHz and 48 kHz fixture corpora at
    each coded-spectrum width: wall s and xRT a corpus, the files it
    wrote, its features finite and of the expected widths.  Returns
    {(sub, num_sps): dict(dir, labels, wall_s, xrt, audio_s)}."""
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    from idiaptts_torch.ops.world.extract import world_analysis
    # One short analysis first: cuFFT plans and the first launches.
    _timed(torch, lambda: world_analysis(
        _wav("wav", "gen-0001")[0][:4000], FS, device=device))
    out = {}
    for sub, fs in EXTRACT_CORPORA:
        ids = _corpus_ids(sub)
        audio_s = sum(len(_wav(sub, i)[0]) for i in ids) / fs
        for num_sps, deltas in EXTRACT_SPS:
            directory = os.path.join(workdir, "extracted_{}_{}".format(
                sub, num_sps))
            gen = WorldFeatLabelGen(dir_labels=directory,
                                    add_deltas=deltas,
                                    num_coded_sps=num_sps,
                                    device=str(device))
            (labels, _), wall = _timed(torch, lambda: gen.gen_data(
                os.path.join(FIXTURES, "database", sub), dir_out=directory,
                id_list=ids, return_dict=True))
            num_bap = 1 if fs == FS else 5
            for id_name, feats in labels.items():
                frames = 1 + (len(_wav(sub, id_name)[0]) - 1) // (fs // 200)
                if feats.shape != (frames, num_sps + 2 + num_bap) \
                        or not np.all(np.isfinite(feats)):
                    fail("gen_data {} N={}: {} has features {} (want "
                         "({}, {}), finite)".format(
                             sub, num_sps, id_name, feats.shape, frames,
                             num_sps + 2 + num_bap))
            files = sum(len(f) for _, _, f in os.walk(directory))
            want = 4 * len(ids) + 6     # the streams, their statistics
            if files != want:
                fail("gen_data {} N={} wrote {} files, want {}".format(
                    sub, num_sps, files, want))
            out[(sub, num_sps)] = dict(dir=directory, labels=labels,
                                       wall_s=wall, audio_s=audio_s,
                                       xrt=audio_s / wall)
            log("  gen_data {} ({} utterances, {:.2f} s of audio, {} "
                "kHz) N={}{}: {:.3f} s = {:.1f}x realtime, {} files [{}]"
                .format(sub, len(ids), audio_s, fs // 1000, num_sps,
                        " with deltas" if deltas else "", wall,
                        audio_s / wall, files, card))
    return out


def _feature_diffs(out, ref):
    """Card-against-CPU differences of two world_analysis results."""
    (f0, coded, bap), (f0_r, coded_r, bap_r) = out, ref
    both = (f0 > 0) & (f0_r > 0)
    return {
        "voicing": float(((f0 > 0) == (f0_r > 0)).mean()),
        "f0_rel": float((np.abs(f0 - f0_r)[both] / f0_r[both]).max())
        if both.any() else 0.0,
        "coded_max": float(np.abs(coded - coded_r).max()),
        "coded_mean": float(np.abs(coded - coded_r).mean()),
        "bap_max": float(np.abs(bap - bap_r).max()),
        "bap_mean": float(np.abs(bap - bap_r).mean())}


def extraction_against_cpu(torch, device):
    """One 16 kHz and one 48 kHz utterance through world_analysis on the
    card and on the port's CPU path, held to the CPU tests' bounds."""
    from idiaptts_torch.ops.world.extract import world_analysis
    out = {}
    for sub, id_name in (("wav", "gen-0001"), ("wav48", "gen48-0001")):
        raw, fs = _wav(sub, id_name)
        diffs = _feature_diffs(world_analysis(raw, fs, NUM_SPS,
                                              device=device),
                               world_analysis(raw, fs, NUM_SPS,
                                              device="cpu"))
        log("  {} on the card against the CPU path: {}".format(
            id_name, json.dumps(diffs)))
        for k, tol in EXTRACT_TOL.items():
            bad = diffs[k] < tol if k == "voicing" else diffs[k] > tol
            if bad:
                fail("extraction of {} on the card against the CPU: {} "
                     "{:.3g} (bound {})".format(id_name, k, diffs[k], tol))
        out[id_name] = diffs
    return out


def _f0_against_truth(f0, f0_true, what):
    """test_world.py's bounds on the generating contour: median voiced
    error under 0.6 Hz, voicing agreement above 0.85."""
    n = min(len(f0), len(f0_true))
    both = (f0[:n] > 0) & (f0_true[:n] > 0)
    median = float(np.median(np.abs(f0[:n][both] - f0_true[:n][both])))
    agree = float(((f0[:n] > 0) == (f0_true[:n] > 0)).mean())
    if not (median < 0.6 and agree > 0.85):
        fail("F0 of {} against the generating parameters: median error "
             "{:.3f} Hz, voicing agreement {:.3f}".format(what, median,
                                                          agree))
    return {"median_err_hz": median, "voicing_agreement": agree}


def f0_against_parameters(corpus):
    """F0 from the card's gen_data (lf0 and vuv) against the contours the
    16 kHz fixture wavs were synthesised from."""
    out = {}
    for id_name, feats in sorted(corpus[("wav", NUM_SPS)]["labels"].items()):
        f0 = np.where(feats[:, NUM_SPS + 1] > 0.5,
                      np.exp(feats[:, NUM_SPS]), 0.0)
        f0_true = np.load(os.path.join(FIXTURES, "params",
                                       id_name + ".npz"))["f0"]
        out[id_name] = _f0_against_truth(f0, f0_true, id_name)
    log("  F0 against the generating parameters:", json.dumps(out))
    return out


def extraction_split(torch, device, raw, fs, card, what):
    """world_analysis of one waveform on the card: wall s end to end
    (xRT), the device analysis (synchronised; the host enqueues every
    launch, the Viterbi's and D4C's step loops included), the Viterbi
    forward loop alone, the host's refine_vuv, and the device's busy
    time and idle share over the device analysis from torch.profiler."""
    import importlib
    from idiaptts_torch.ops import mcep as mcep_ops
    from idiaptts_torch.ops.world.extract import (_analysis_dev,
                                                  world_analysis)
    f0_mod = importlib.import_module("idiaptts_torch.ops.world.f0")
    d4c_mod = importlib.import_module("idiaptts_torch.ops.world.d4c")
    hop = fs // 200
    audio_s = len(raw) / fs
    (f0, coded, bap), total = _timed(torch, lambda: world_analysis(
        raw, fs, NUM_SPS, device=device))
    padded = torch.from_numpy(f0_mod.pad_to_bucket(raw)).to(device)
    args = (padded, fs, hop, f0_mod.correlation_window(fs),
            mcep_ops.fs_to_frame_length(fs),
            max(1, d4c_mod.get_num_aperiodicities(fs)), NUM_SPS - 1,
            mcep_ops.fs_to_mgc_alpha(fs))
    with torch.inference_mode():
        _, device_s = _timed(torch, lambda: _analysis_dev(*args))
        nccf, _ = f0_mod._nccf(padded, fs, hop, 71.0, args[3])
        cand, scores = f0_mod._candidates(nccf, fs, 71.0, 800.0)
        del nccf
        _, viterbi_s = _timed(torch, lambda: f0_mod._viterbi(
            cand, scores, f0_mod._UNVOICED_COST, f0_mod._TRANSITION_W))
        kernels = profile_step(torch, lambda: _analysis_dev(*args), steps=1)
    # refine_vuv's cost is its four-interval tracks, whatever the f0.
    t0 = time.perf_counter()
    f0_mod.refine_vuv(raw, fs, f0)
    refine_s = time.perf_counter() - t0
    busy_ms = sum(kernels.values())
    stats = dict(audio_s=audio_s, frames=len(f0),
                 padded_frames=int(cand.shape[0]), wall_s=total,
                 xrt=audio_s / total, device_analysis_s=device_s,
                 viterbi_loop_s=viterbi_s, refine_vuv_s=refine_s,
                 device_busy_ms=busy_ms if kernels else None,
                 idle_share=(1.0 - busy_ms / (device_s * 1e3)
                             if kernels else None),
                 top_kernels_ms=dict(sorted(kernels.items(),
                                            key=lambda kv: -kv[1])[:6]))
    log("  {}: {:.2f} s of audio, {} frames ({} padded): world_analysis "
        "{:.3f} s = {:.1f}x realtime | device analysis {:.3f} s (Viterbi "
        "loop {:.3f} s), host refine_vuv {:.3f} s [{}]".format(
            what, audio_s, len(f0), stats["padded_frames"], total,
            stats["xrt"], device_s, viterbi_s, refine_s, card))
    if kernels:
        log("    device busy {:.3f} ms of the device analysis (idle "
            "{:.1%})".format(busy_ms, stats["idle_share"]))
        for name, v in stats["top_kernels_ms"].items():
            log("    {:9.3f} ms  {}".format(v, name[:100]))
    else:
        log("    torch.profiler recorded no device time: idle share not "
            "measured")
    if not (np.all(np.isfinite(coded)) and np.all(np.isfinite(bap))):
        fail("{}: non-finite features".format(what))
    return stats, f0


def long_utterance(torch, device, card):
    """The 16 kHz fixture wavs concatenated in order until 60 s (12,000
    frames) through world_analysis on the card, split and timed; its F0
    against the concatenated generating contours."""
    ids = _corpus_ids("wav")
    n = int(EXTRACT_LONG_S * FS)
    raws, truth, k = [], [], 0
    while sum(len(r) for r in raws) < n:
        id_name = ids[k % len(ids)]
        raws.append(_wav("wav", id_name)[0])
        truth.append(np.load(os.path.join(FIXTURES, "params",
                                          id_name + ".npz"))["f0"])
        k += 1
    raw = np.concatenate(raws)[:n]
    stats, f0 = extraction_split(torch, device, raw, FS, card,
                                 "60 s utterance")
    if len(f0) != n // (FS // 200):
        fail("60 s utterance: {} frames, want {}".format(
            len(f0), n // (FS // 200)))
    stats["f0_truth"] = _f0_against_truth(f0, np.concatenate(truth),
                                          "the 60 s utterance")
    return stats


def extracted_voice(torch, device, workdir, corpus, card):
    """Phase 6's trainer (the full-width Interspeech'18 model) trained on
    the corpus the card extracted (features and statistics), then its
    modular synth: launch counters reset just before each and read just
    after."""
    out_dir = os.path.join(workdir, "extracted_voice")
    trainer, hp = make_trainer(torch, device, out_dir,
                               world_dir=corpus[("wav", NUM_SPS)]["dir"])
    (losses, train_launches) = counted(torch, lambda: trainer.train(hp))
    val_loss, train_loss = losses
    log("  training on the extracted corpus: train loss {} | validation "
        "{} | launches {}".format(train_loss, val_loss,
                                  json.dumps(train_launches)))
    require_launches(train_launches, EXTRACT_TRAIN_KERNELS,
                     "extracted-corpus training")
    if not (np.all(np.isfinite(train_loss))
            and np.all(np.isfinite(val_loss))):
        fail("non-finite loss training on the extracted corpus")
    if not train_loss[-1] < train_loss[0]:
        fail("training loss on the extracted corpus did not fall: {}"
             .format(train_loss))
    ids = fixture_ids()
    hp.use_fused_synth = False
    hp.synth_dir = os.path.join(out_dir, "synth_modular")
    hp.batch_size_synth = len(ids)
    paths, synth_launches = counted(torch, lambda: trainer.synth(hp, ids))
    log("  modular synth from the extracted-corpus model: launches",
        json.dumps(synth_launches))
    require_launches(synth_launches, EXTRACT_SYNTH_KERNELS,
                     "extracted-corpus modular synth")
    labels = corpus[("wav", NUM_SPS)]["labels"]
    for id_name in ids:
        raw, ok = _wav_ok(paths[id_name], len(labels[id_name]))
        if not ok:
            fail("modular synth of {}: wrong length or non-finite".format(
                id_name))
    del trainer
    torch.cuda.empty_cache()
    return dict(train_loss=list(train_loss), val_loss=list(val_loss),
                train_launches=train_launches,
                synth_launches=synth_launches)


def amplitude_synthesis(torch, device, workdir, card):
    """One utterance's WORLD features with its amplitude spectrum
    (``sp_type="amp_sp"``) through ``Synthesiser.run_world_synth``, and
    its STFT magnitude through ``Synthesiser.run_griffin_lim``, on the
    card: finite and audible (RMS above 0.01)."""
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.ops import audio_io, stft as stft_ops
    from idiaptts_torch.synth.synthesiser import Synthesiser
    raw, fs = _wav("wav", "gen-0002")
    amp_sp, lf0, vuv, bap = WorldFeatLabelGen.world_extract_features(
        raw, fs, device=device)
    hp = ExtendedHParams.create_hparams()
    hp.device = str(device)
    hp.sp_type = "amp_sp"
    hp.num_coded_sps = amp_sp.shape[1]
    hp.synth_dir = os.path.join(workdir, "amplitude_synth")
    feats = WorldFeatLabelGen.convert_from_world_features(amp_sp, lf0, vuv,
                                                          bap)
    out = {}
    paths, out["world_amp_sp_s"] = _timed(
        torch, lambda: Synthesiser.run_world_synth({"world": feats}, hp))
    with torch.inference_mode():
        spec = stft_ops.amp_spectrum(torch.from_numpy(raw).to(device),
                                     1024, fs // 200).cpu().numpy()
    gl_paths, out["griffin_lim_s"] = _timed(
        torch, lambda: Synthesiser.run_griffin_lim({"griffin_lim": spec},
                                                   hp))
    for name, path, n in (("world", paths["world"], len(amp_sp) * 80),
                          ("griffin_lim", gl_paths["griffin_lim"],
                           (len(spec) - 1) * 80)):
        wav, _ = audio_io.get_raw(path)
        rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
        out[name + "_rms"] = rms
        if wav.shape != (n,) or not np.all(np.isfinite(wav)) \
                or not rms > 0.01:
            fail("{} synthesis on the card: {} samples (want {}), RMS "
                 "{:.4f}".format(name, len(wav), n, rms))
    log("  amplitude-spectrum WORLD synthesis and Griffin-Lim of gen-0002 "
        "[{}]: {}".format(card, json.dumps(out)))
    return out


def feature_extraction(torch, device, card, workdir):
    """Phase 12: gen_data on the card at 16 and 48 kHz, the card against
    the CPU path, F0 against the generating parameters, the extraction's
    split and idle share, the 60 s utterance, then a voice trained from
    the card's own features, its modular synth, and the amplitude-spectrum
    and Griffin-Lim synthesis."""
    t0 = time.perf_counter()
    log("== phase 12 (a): gen_data on {} [{}]".format(device, card))
    corpus = extract_corpora(torch, device, workdir, card)
    against_cpu = extraction_against_cpu(torch, device)
    f0_truth = f0_against_parameters(corpus)
    log("== phase 12 (b): the extraction's split and idle share [{}]"
        .format(card))
    splits = {}
    for sub, id_name in (("wav", "gen-0006"), ("wav48", "gen48-0002")):
        raw, fs = _wav(sub, id_name)
        splits[id_name] = extraction_split(torch, device, raw, fs, card,
                                           id_name)[0]
    splits["long"] = long_utterance(torch, device, card)
    log("== phase 12 (c): {} trained on the card's extracted corpus, its "
        "modular synth [{}]".format(MODEL_STRING, card))
    voice = extracted_voice(torch, device, workdir, corpus, card)
    log("== phase 12 (d): amplitude-spectrum synthesis and Griffin-Lim "
        "[{}]".format(card))
    amplitude = amplitude_synthesis(torch, device, workdir, card)
    wall = time.perf_counter() - t0
    summary = {
        "wall_s": wall,
        "gen_data": {"{}_N{}".format(*k): {x: v[x] for x in (
            "audio_s", "wall_s", "xrt")} for k, v in corpus.items()},
        "against_cpu": against_cpu, "f0_truth": f0_truth,
        "split": {k: {x: v[x] for x in (
            "audio_s", "frames", "padded_frames", "wall_s", "xrt",
            "device_analysis_s", "viterbi_loop_s", "refine_vuv_s",
            "device_busy_ms", "idle_share")} for k, v in splits.items()},
        "long_f0_truth": splits["long"]["f0_truth"],
        "voice": {k: voice[k] for k in ("train_loss", "val_loss")},
        "amplitude": amplitude}
    log("  phase 12 [{}]: {}".format(card, json.dumps(summary)))
    return dict(voice=voice, summary=summary)


# -- phase 13 ----------------------------------------------------------------

def padded_questions(workdir, width=ATOM_D_IN):
    """The fixture question matrices zero-padded to ``width`` columns (the
    production question width) with their min-max statistics, in a
    directory of the workdir."""
    from idiaptts_torch.data.normalisation import MinMaxExtractor
    questions, _, num_q = load_corpus()
    out_dir = os.path.join(workdir, "questions{}".format(width))
    os.makedirs(out_dir, exist_ok=True)
    extractor = MinMaxExtractor()
    for id_name, q in zip(fixture_ids(), questions):
        padded = np.zeros((len(q), width), np.float32)
        padded[:, :num_q] = q
        padded.tofile(os.path.join(out_dir, id_name + ".questions"))
        extractor.add_sample(padded)
    extractor.save(os.path.join(out_dir, "all"))
    return out_dir


def model_against_cpu(torch, model, data, lengths, out_name, tol, what,
                      training=False):
    """A model's output on the card against a CPU copy of it on the same
    inputs, relative to the output's largest magnitude."""
    cpu = copy.deepcopy(model).to("cpu")
    device = next(model.parameters()).device
    with torch.no_grad():
        got = model({k: v.to(device) for k, v in data.items()},
                    lengths=lengths.to(device), training=training)[
                        out_name].float().cpu()
        ref = cpu({k: v.cpu() for k, v in data.items()},
                  lengths=lengths.cpu(), training=training)[out_name].float()
    err = (got - ref).abs().max().item() / max(ref.abs().max().item(),
                                               1e-12)
    _check("card vs CPU", err, tol, what + " (rel)")
    return err


def one_utterance(trainer, names):
    """The first training utterance's inputs as a batch of one: tensors
    of ``names`` and the lengths."""
    import torch
    from idiaptts_torch.data.dataset import collate_batch
    uid = trainer.id_list_train[0]
    batch = collate_batch([trainer.dataset_train.get_id_name(uid)[0]])
    data = {n: torch.as_tensor(batch[n]) for n in names}
    lengths = torch.as_tensor(np.asarray(
        batch["_lengths"][names[0]], np.int64))
    return data, lengths


def step_ms(torch, trainer, reps=3):
    """CUDA-event ms of one handler train step on a fixed batch of
    training utterances (after one warm-up step)."""
    from idiaptts_torch.data.dataset import collate_batch
    ids = trainer.id_list_train[:trainer.hparams.batch_size_train]
    batch = collate_batch([trainer.dataset_train.get_id_name(i)[0]
                           for i in ids])
    return cuda_ms(torch, lambda: trainer.model_handler.process_batches(
        [batch]), reps), batch


def step_split(torch, trainer, batch, ms, what, card):
    """Device busy ms of one handler train step on ``batch`` from
    torch.profiler, the idle share against the step's ``ms``, and the
    three kernels with the most device time; logged."""
    kernels = profile_step(torch, lambda: trainer.model_handler
                           .process_batches([batch]))
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    log("  {} step: device busy {:.2f} of {:.2f} ms (idle {:.1%}); most "
        "device time: {} [{}]".format(what, busy, ms, 1 - busy / ms,
                                      ", ".join("{} {:.2f} ms".format(
                                          k[:48], v) for k, v in top),
                                      card))
    return dict(busy_ms=busy, idle=1 - busy / ms,
                top={k[:80]: v for k, v in top})


def set_loss(trainer, ids):
    """Mean evaluation loss of the handler over ``ids``."""
    return trainer.model_handler.process_batches(trainer._batches(
        trainer.dataset_val, ids, 1, prefetch=0), training=False)[0]


def wavenet_training(torch, device, card, workdir):
    """(a) WaveNetVocoderTrainer at WaveNetWrapper.Config's defaults on
    the fixture wavs and their 20-mcep WORLD conditioning, 0.5 s windows;
    then save_for_vocoding -> WaveNetVocoder.load -> generation (K8)."""
    from idiaptts_torch.models.wavenet import WaveNetVocoder, generate
    from idiaptts_torch.train.wavenet_trainer import WaveNetVocoderTrainer
    hp = WaveNetVocoderTrainer.create_hparams()
    hp.device = str(device)
    hp.out_dir = workdir
    hp.model_name = "wavenet_trained"
    hp.synth_dir = os.path.join(workdir, "wavenet_synth")
    hp.epochs = WN_TRAIN_EPOCHS
    hp.batch_size_train = 2
    hp.batch_size_val = 1
    hp.learning_rate = 1e-3
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.num_coded_sps_cond = NUM_SPS
    hp.num_coded_sps = NUM_SPS
    # The Noam warm-up cut to the run's few steps.
    hp.scheduler_args = {"warmup_steps": WN_TRAIN_WARMUP}
    trainer = WaveNetVocoderTrainer(
        hp, fixture_ids(), dir_world_features=os.path.join(FIXTURES, "WORLD"),
        dir_audio=os.path.join(FIXTURES, "database", "wav"))
    trainer.init(hp)
    cfg = trainer.model_handler.model_config
    log("  model: {} layers, R={}, {} classes, C={}".format(
        cfg.num_layers, cfg.residual_channels, cfg.out_channels,
        cfg.cond_channels))
    val_ids = trainer.id_list_val
    before = set_loss(trainer, val_ids)
    (_, train_loss), launches = counted(torch, lambda: trainer.train(hp))
    after = set_loss(trainer, val_ids)
    log("  {} epochs: train loss {} | validation loss {:.4f} -> {:.4f}"
        .format(WN_TRAIN_EPOCHS, ["{:.4f}".format(v) for v in train_loss],
                before, after))
    if not (np.all(np.isfinite(train_loss)) and np.isfinite(after)
            and after < before):
        fail("WaveNet training: the validation loss did not fall: "
             "{} -> {}".format(before, after))
    ms, batch = step_ms(torch, trainer)
    samples = int(np.sum(batch["_lengths"]["target_quantised"]))
    log("  train step B={} T={}: {:.2f} ms, {:.0f} samples/s [{}]".format(
        batch["cond_features"].shape[0], batch["cond_features"].shape[1], ms,
        samples / (ms / 1e3), card))
    split = step_split(torch, trainer, batch, ms, "WaveNet train", card)

    bundle = os.path.join(workdir, "wavenet_voc", "voc")
    trainer.save_for_vocoding(hp, bundle)
    vocoder = WaveNetVocoder.load(os.path.join(bundle, "nn"), device=device)
    ours = trainer.model_handler.model.state_dict()
    theirs = vocoder.model.state_dict()
    if not (sorted(ours) == sorted(theirs)
            and all(torch.equal(ours[k], theirs[k]) for k in ours)):
        fail("save_for_vocoding does not load back to the same parameters")

    ids = val_ids + trainer.id_list_train[:1]
    (paths, wall), gen_launches = counted(torch, lambda: _timed(
        torch, lambda: trainer.synth(hp, ids)))
    audio_s = 0.0
    for path in paths.values():
        from idiaptts_torch.ops import audio_io
        raw, fs = audio_io.get_raw(path)
        audio_s += len(raw) / fs
        if not (fs == FS and len(raw) and np.all(np.isfinite(raw))):
            fail("WaveNet generation wrote a bad wav: " + path)
    require_launches(gen_launches, VOCODE_KERNELS, "WaveNet generation")
    log("  gen_waveform of {} utterances ({:.2f} s of audio): {:.3f} s, "
        "{:.2f}x real time [{}]".format(len(ids), audio_s, wall,
                                        audio_s / wall, card))
    sample, _ = trainer.dataset_val.get_id_name(val_ids[0])
    cond = sample["cond_features"][:WN_T_CPU * 5]
    with torch.no_grad():
        a = vocoder.generate(cond, seed=0)
        b = generate(trainer.model_handler.model, cfg, cond,
                     generator=torch.Generator(device=device).manual_seed(0))
    if not np.array_equal(a, b):
        fail("the loaded vocoder draws other samples than the trainer")
    # (f) The teacher-forced network on the card against the CPU.
    data, lengths = one_utterance(trainer, ("cond_features",
                                            "target_quantised"))
    data = {k: v[:, :WN_T_CPU * 5] for k, v in data.items()}
    err = model_against_cpu(torch, trainer.model_handler.model, data,
                            torch.clamp(lengths, max=WN_T_CPU * 5),
                            "pred_logits", WN_TOL,
                            "WaveNet logits, T={}".format(WN_T_CPU * 5))
    del trainer, vocoder
    torch.cuda.empty_cache()
    return dict(train_launches=launches, gen_launches=gen_launches,
                train_loss=train_loss, val_loss=(before, after),
                step=dict(B=int(batch["cond_features"].shape[0]),
                          T=int(batch["cond_features"].shape[1]), ms=ms,
                          **split),
                gen=dict(utterances=len(ids), audio_s=audio_s, wall_s=wall,
                         xrt=audio_s / wall), cpu_rel=err)


def atom_hparams(cls, device, workdir, name, epochs, num_questions,
                 batch=3, lr=1e-3, best=False):
    hp = cls.create_hparams()
    hp.device = str(device)
    hp.num_questions = num_questions
    hp.thetas = list(ATOM_THETAS)
    hp.out_dir = os.path.join(workdir, name)
    hp.model_name = name
    hp.epochs = epochs
    hp.batch_size_train = batch
    hp.batch_size_val = 6
    hp.learning_rate = lr
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = best
    return hp


def atom_dirs(questions_dir):
    return dict(dir_question_labels=questions_dir, dir_atom_labels=WCAD_DIR,
                dir_world_features=os.path.join(FIXTURES, "WORLD"))


def atom_family(torch, device, card, workdir):
    """(b) AtomVUVDistPosModelTrainer with its default full-width model
    on the 409-column questions, 3 epochs (K7's projection, K4, K5 in
    training; K6's projection and K3 in benchmark), then the neural
    filter and phrase trainers adopt it and train."""
    from idiaptts_torch.train.atom_trainers import (
        AtomNeuralFilterModelTrainer, AtomVUVDistPosModelTrainer,
        PhraseAtomNeuralFilterModelTrainer)
    dirs = atom_dirs(padded_questions(workdir))
    ids = fixture_ids()
    atom_hp = atom_hparams(AtomVUVDistPosModelTrainer, device, workdir,
                           "atom_full", ATOM_EPOCHS, ATOM_D_IN)
    atom = AtomVUVDistPosModelTrainer(atom_hp, ids, **dirs)
    atom.init(atom_hp)
    log("  atom model: {} layer groups, {} -> 7".format(
        len(atom.model_handler.model_config.layer_configs), ATOM_D_IN))
    (_, loss), train_launches = counted(torch, lambda: atom.train(atom_hp))
    require_launches(train_launches, TRAIN_KERNELS, "atom training")
    if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
        fail("atom training loss did not fall: {}".format(loss))
    scores, bench_launches = counted(torch, lambda: atom.benchmark(
        atom_hp, atom.id_list_train))
    require_launches(bench_launches, ("bilstm_proj", "bilstm_recurrence"),
                     "atom benchmark")
    atom_ms, batch = step_ms(torch, atom)
    out = {"atom": dict(train_loss=loss, scores=scores, step_ms=atom_ms,
                        split=step_split(torch, atom, batch, atom_ms,
                                         "atom train", card),
                        train_launches=train_launches,
                        bench_launches=bench_launches)}
    log("  atom: train loss {} | F0-RMSE {:.3f} VDE {:.4f} | step {:.2f} ms"
        " [{}]".format(["{:.4f}".format(v) for v in loss], scores[0],
                       scores[1], atom_ms, card))
    data, lengths = one_utterance(atom, ("questions",))
    out["atom"]["cpu_rel"] = model_against_cpu(
        torch, atom.model_handler.model, data, lengths, "pred_atoms",
        ATOM_TOL, "atom model, T={}".format(int(lengths[0])))

    flat_hp = atom_hparams(AtomNeuralFilterModelTrainer, device, workdir,
                           "flat_full", ATOM_EPOCHS, ATOM_D_IN)
    flat = AtomNeuralFilterModelTrainer(flat_hp, ids, **dirs)
    flat.init_atom(flat_hp, atom)
    flat.init(flat_hp)
    flat.adopt_atom_params()
    phrase_hp = atom_hparams(PhraseAtomNeuralFilterModelTrainer, device,
                             workdir, "phrase_full", ATOM_EPOCHS, ATOM_D_IN)
    phrase = PhraseAtomNeuralFilterModelTrainer(phrase_hp, ids, **dirs)
    phrase.init_flat(phrase_hp, flat)
    phrase.init(phrase_hp)
    for name, trainer, hp, out_name in (
            ("flat", flat, flat_hp, "pred_intonation"),
            ("phrase", phrase, phrase_hp, "pred_intonation_phrase")):
        if trainer is phrase:
            phrase.adopt_flat_params()
        (_, loss), launches = counted(torch, lambda: trainer.train(hp))
        require_launches(launches, TRAIN_KERNELS, name + " training")
        if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
            fail("{} training loss did not fall: {}".format(name, loss))
        scores = trainer.benchmark(hp, trainer.id_list_train)
        ms, batch = step_ms(torch, trainer)
        iir = iir_ms(torch, trainer, batch, out_name)
        out[name] = dict(train_loss=loss, scores=scores, step_ms=ms,
                         iir_ms=iir, train_launches=launches,
                         split=step_split(torch, trainer, batch, ms,
                                          name + " train", card))
        log("  {}: train loss {} | F0-RMSE {:.3f} VDE {:.4f} | step {:.2f} "
            "ms, of it the IIR filter loops {:.2f} ms fwd+bwd ({:.0%}) [{}]"
            .format(name, ["{:.4f}".format(v) for v in loss], scores[0],
                    scores[1], ms, iir, iir / ms, card))
        data, lengths = one_utterance(trainer, ("questions",))
        out[name]["cpu_rel"] = model_against_cpu(
            torch, trainer.model_handler.model, data, lengths, out_name,
            ATOM_TOL, "{} model, T={}".format(name, int(lengths[0])))
    del atom, flat, phrase
    torch.cuda.empty_cache()
    return out


def iir_ms(torch, trainer, batch, out_name):
    """CUDA-event ms of the intonation filter banks alone, forward and
    backward, on the amplitudes a train step gives them."""
    model = trainer.model_handler.model
    nf = getattr(model, "neural_filters", model)
    banks = [nf.intonation_filters] + ([model.phrase_filter]
                                       if model is not nf else [])
    device = trainer.model_handler.device
    amps = torch.randn(batch["questions"].shape[0],
                       batch["questions"].shape[1], nf.num_thetas,
                       device=device, generator=torch.Generator(
                           device=device).manual_seed(0))

    def run():
        total = 0.0
        for bank in banks:
            x = amps if bank is nf.intonation_filters \
                else amps.sum(-1, keepdim=True)
            total = total + bank(x).sum()
        total.backward()
    return cuda_ms(torch, run, 2)


def vtln_config(trainer, hp, pre_net_string, d_in):
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    pre_net = convert_legacy_string(pre_net_string, d_in)
    pre_net.input_names = ("questions",)
    pre_net.output_names = ("pre_net_output",)
    return trainer.build_model_config(hp, pre_net, NUM_SPS)


def vtln_trainer(torch, device, workdir, name, pre_net_string, d_in,
                 questions_dir, epochs, lr, best):
    from idiaptts_torch.data.category import CategoryDataReader
    from idiaptts_torch.train.vtln_trainer import \
        VTLNSpeakerAdaptionModelTrainer
    hp = VTLNSpeakerAdaptionModelTrainer.create_hparams()
    hp.device = str(device)
    hp.num_questions = d_in
    hp.num_coded_sps = NUM_SPS
    hp.out_dir = os.path.join(workdir, name)
    hp.model_name = name
    hp.epochs = epochs
    hp.batch_size_train = 3
    hp.batch_size_val = 6
    hp.learning_rate = lr
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = best
    hp.warp_matrix_size = NUM_SPS
    trainer = VTLNSpeakerAdaptionModelTrainer(
        hp, fixture_ids(), dir_question_labels=questions_dir,
        dir_world_features=os.path.join(FIXTURES, "WORLD"))
    readers = trainer.default_data_reader_configs(hp)
    # The pin recipe's speaker input (test_quality_pins.py:308).
    readers.append(CategoryDataReader.Config(
        name="speaker_embedding", get_category_fn=lambda idn: [0.5]))
    trainer.init(hp, model_config=vtln_config(trainer, hp, pre_net_string,
                                              d_in),
                 data_reader_configs=readers)
    return trainer, hp


def vtln_full(torch, device, card, workdir):
    """(c) The Interspeech'18 pre-net under the all-pass warp layer in a
    Sequential at full width: training (K7's projection, K4, K5), then
    benchmark (K3 and the one-shot MLPG K1)."""
    trainer, hp = vtln_trainer(torch, device, workdir, "vtln_full",
                               VTLN_PRE_NET, ATOM_D_IN,
                               padded_questions(workdir), VTLN_EPOCHS,
                               5e-4, False)
    (_, loss), train_launches = counted(torch, lambda: trainer.train(hp))
    require_launches(train_launches, TRAIN_KERNELS, "VTLN training")
    if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
        fail("VTLN training loss did not fall: {}".format(loss))
    scores, bench_launches = counted(torch, lambda: trainer.benchmark(
        hp, trainer.id_list_train))
    require_launches(bench_launches, ("bilstm_proj", "bilstm_recurrence",
                                      "mlpg_oneshot"), "VTLN benchmark")
    ms, batch = step_ms(torch, trainer)
    split = step_split(torch, trainer, batch, ms, "VTLN train", card)
    log("  VTLN: train loss {} | MCD {:.3f} F0-RMSE {:.3f} VDE {:.4f} BAP "
        "{:.3f} | sweep {} | step {:.2f} ms [{}]".format(
            ["{:.4f}".format(v) for v in loss], *scores,
            {k: round(v, 4) for k, v in trainer.mcd_sweep.items()}, ms,
            card))
    sweep = dict(trainer.mcd_sweep)
    data, lengths = one_utterance(trainer, ("questions", "speaker_embedding"))
    err = model_against_cpu(torch, trainer.model_handler.model, data,
                            lengths, "pred_acoustic_features", ATOM_TOL,
                            "VTLN model, T={}".format(int(lengths[0])))
    del trainer
    torch.cuda.empty_cache()
    return dict(train_loss=loss, scores=scores, sweep=sweep, step_ms=ms,
                split=split, train_launches=train_launches,
                bench_launches=bench_launches, cpu_rel=err)


def intonation_pins(torch, device, card, workdir):
    """(d) The atom, flat/phrase and VTLN pin recipes of
    tests/integration/test_quality_pins.py:165-320 as published, from the
    JAX draw, each score held one-sided at 1% to the pins read from that
    file's text."""
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.atom_trainers import (
        AtomModelTrainer, AtomNeuralFilterModelTrainer,
        AtomVUVDistPosModelTrainer, PhraseAtomNeuralFilterModelTrainer)
    pinned_atom, pinned_flat, pinned_phrase, pinned_vtln = read_pins(
        ("PINNED_ATOM", "PINNED_FLAT", "PINNED_PHRASE", "PINNED_VTLN"))
    _, _, num_q = load_corpus()
    dirs = atom_dirs(os.path.join(FIXTURES, "questions"))
    ids = fixture_ids()

    def atom_config(string):
        cfg = convert_legacy_string(string, num_q)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_atoms",)
        return cfg

    scores = {}
    t0 = time.perf_counter()
    hp = atom_hparams(AtomModelTrainer, device, workdir, "pin_atoms", 10,
                      num_q, best=True)
    trainer = AtomModelTrainer(hp, ids, **dirs)
    trainer.init(hp, model_config=atom_config("RNNDYN-1_RELU_64-1_FC_5"))
    from_jax_draw(trainer)
    trainer.train(hp)
    scores["atom"] = dict(zip(("f0_rmse", "vde"), map(
        float, trainer.benchmark(hp, trainer.id_list_train))))
    for key, pinned in pinned_atom.items():
        check_pinned("atom " + key, scores["atom"][key], pinned)

    atom_hp = atom_hparams(AtomVUVDistPosModelTrainer, device, workdir,
                           "atoms", 3, num_q)
    atom = AtomVUVDistPosModelTrainer(atom_hp, ids, **dirs)
    atom.init(atom_hp, model_config=atom_config("RNNDYN-1_RELU_32-1_FC_7"))
    from_jax_draw(atom)
    flat_hp = atom_hparams(AtomNeuralFilterModelTrainer, device, workdir,
                           "flat", 3, num_q)
    flat = AtomNeuralFilterModelTrainer(flat_hp, ids, **dirs)
    flat.init_atom(flat_hp, atom)
    flat.init(flat_hp)
    from_jax_draw(flat)
    phrase_hp = atom_hparams(PhraseAtomNeuralFilterModelTrainer, device,
                             workdir, "phrase", 3, num_q)
    phrase_hp.add_hparams(phrase_bias_init=5.2)
    phrase = PhraseAtomNeuralFilterModelTrainer(phrase_hp, ids, **dirs)
    phrase.init_flat(phrase_hp, flat)
    phrase.init(phrase_hp)
    from_jax_draw(phrase)
    phrase.train_atom(atom_hp)
    phrase.train_flat(flat_hp)
    phrase.train(phrase_hp)
    for name, trainer, hp, pins in (("flat", flat, flat_hp, pinned_flat),
                                    ("phrase", phrase, phrase_hp,
                                     pinned_phrase)):
        scores[name] = dict(zip(("f0_rmse", "vde"), map(
            float, trainer.benchmark(hp, trainer.id_list_train))))
        for key, pinned in pins.items():
            check_pinned("{} {}".format(name, key), scores[name][key], pinned)

    trainer, hp = vtln_trainer(torch, device, workdir, "pin_vtln",
                               "RNNDYN-1_RELU_64-1_FC_67", num_q,
                               os.path.join(FIXTURES, "questions"), 8,
                               5e-4, True)
    from_jax_draw(trainer)
    trainer.train(hp)
    scores["vtln"] = dict(zip(("mcd", "f0_rmse", "vde", "bap"), map(
        float, trainer.benchmark(hp, trainer.id_list_train))))
    for key, pinned in pinned_vtln.items():
        check_pinned("vtln " + key, scores["vtln"][key], pinned)
    seconds = time.perf_counter() - t0
    log("  pins [{}]: {} ({:.1f} s)".format(card, json.dumps(scores),
                                            seconds))
    torch.cuda.empty_cache()
    return dict(scores=scores, seconds=seconds)


def enc_dec_small_models(torch, device, card, workdir):
    """(e) EncDecMonophoneModelTrainer at its defaults (encoder 256-256,
    two frames a decoder step, fixed attention) a few epochs, then
    free-running, card against CPU; ClassificationTrainer and a
    WindowingWrapper, small."""
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.models.wrappers import WindowingWrapper
    from idiaptts_torch.train.enc_dec_trainer import \
        EncDecMonophoneModelTrainer
    hp = EncDecMonophoneModelTrainer.create_hparams()
    hp.device = str(device)
    hp.num_coded_sps = NUM_SPS
    hp.out_dir = workdir
    hp.model_name = "encdec"
    hp.epochs = ENC_DEC_EPOCHS
    hp.batch_size_train = 3
    hp.batch_size_val = 6
    hp.learning_rate = 1e-3
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.label_type = "full_state_align"
    labels = os.path.join(FIXTURES, "labels")
    trainer = EncDecMonophoneModelTrainer(
        hp, fixture_ids(),
        dir_phoneme_labels=os.path.join(labels, "label_state_align"),
        dir_durations=os.path.join(FIXTURES, "dur"),
        dir_world_features=os.path.join(FIXTURES, "WORLD"),
        file_symbol_dict=os.path.join(labels, "mono_phone.list"))
    trainer.init(hp)
    cfg = trainer.model_handler.model_config
    (val, loss), _ = counted(torch, lambda: trainer.train(hp))
    log("  enc-dec ({} -> {}, encoder {}, decoder {}, {} frames a step): "
        "train loss {} | validation (free-running) {}".format(
            cfg.in_dim, cfg.out_dim, cfg.encoder_units, cfg.decoder_dim,
            cfg.n_frames_per_step, ["{:.4f}".format(v) for v in loss],
            ["{:.4f}".format(v) for v in val]))
    if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]
            and np.all(np.isfinite(val))):
        fail("enc-dec training loss did not fall: {}".format(loss))
    ms, batch = step_ms(torch, trainer)
    handler = trainer.model_handler
    split = step_split(torch, trainer, batch, ms, "enc-dec train B={} T={}"
                       .format(batch["acoustic_features"].shape[0],
                               batch["acoustic_features"].shape[1]), card)
    names = ("acoustic_features", "phonemes", "attention_matrix")
    data, lengths = one_utterance(trainer, names)
    model = handler.model
    errs = {mode: model_against_cpu(
        torch, model, data, lengths, "pred_acoustic_features", ENC_DEC_TOL,
        "enc-dec {}, T={}".format(mode, int(lengths[0])),
        training=mode == "teacher-forced")
        for mode in ("teacher-forced", "free-running")}
    (_, fr_wall) = _timed(torch, lambda: model(
        {k: v.to(device) for k, v in data.items()}, training=False))
    log("  enc-dec free-running forward of {} frames: {:.3f} s [{}]".format(
        int(lengths[0]), fr_wall, card))
    out = dict(train_loss=loss, val_loss=val, step_ms=ms, split=split,
               cpu_rel=errs,
               free_running_s=fr_wall)
    del trainer, handler, model
    torch.cuda.empty_cache()
    out["attention_decoder"] = attention_decoder_step(torch, device, card)
    out["classification"] = classification_small(torch, device, workdir)
    # A WindowingWrapper around a small BiLSTM model, card against CPU.
    inner = convert_legacy_string("RNNDYN-1_RELU_32-1_BiLSTM_32-1_FC_4", 8)
    inner.input_names = ("x",)
    inner.output_names = ("inner",)
    wcfg = WindowingWrapper.Config(wrapped_model_config=inner,
                                   window_size=64, window_step=48,
                                   input_names=("x",), output_names=("y",))
    wrapper = wcfg.create_model(torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 300, 8, generator=gen)
    out["windowing_cpu_rel"] = model_against_cpu(
        torch, wrapper, {"x": x}, torch.tensor([300, 211]), "y", ATOM_TOL,
        "WindowingWrapper, T=300")
    return out


def attention_decoder_step(torch, device, card):
    """The dot-product attention decoder (the step loop over chunks with
    the attention inside it) at the enc-dec defaults' widths: one
    teacher-forced forward and backward timed, with the device's idle
    share, and the forward held against the CPU."""
    from idiaptts_torch.models.enc_dec import AttentionDecoder
    cfg = AttentionDecoder.Config(
        attention_type="dot", input_names=("memory",),
        teacher_forcing_input_names=("target",), prenet_dims=(128,),
        lstm_dims=(512,), projections=(("pred_frames", 67, (), True),),
        n_frames_per_step=2, attention_dim=128, memory_dim=256)
    model = cfg.create_model(torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator().manual_seed(1)
    data = {"memory": torch.randn(3, 60, 256, generator=gen),
            "target": torch.randn(3, 512, 67, generator=gen)}
    lengths = torch.tensor([60, 51, 40])
    on_card = {k: v.to(device) for k, v in data.items()}

    def step():
        out = model(on_card, lengths=lengths.to(device), training=True)
        out["pred_frames"].square().mean().backward()
    ms = cuda_ms(torch, step, 2)
    kernels = profile_step(torch, step)
    busy = sum(kernels.values())
    log("  dot-attention decoder B=3 T=512 (256 chunks), forward and "
        "backward: {:.1f} ms, device busy {:.1f} ms (idle {:.1%}) [{}]"
        .format(ms, busy, 1 - busy / ms, card))
    err = model_against_cpu(torch, model, data, lengths, "pred_frames",
                            ENC_DEC_TOL, "dot-attention decoder, T=512")
    return dict(ms=ms, busy_ms=busy, idle=1 - busy / ms, cpu_rel=err)


def classification_small(torch, device, workdir):
    """ClassificationTrainer on the fixture questions with a class id an
    utterance: the loss falls, the confusion matrix counts every frame."""
    from idiaptts_torch.data.questions import QuestionLabelGen
    from idiaptts_torch.data.reader import DataReader
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.classification import ClassificationTrainer

    class TiledClass(DataReader):
        class Config(DataReader.Config):
            def create_reader(self):
                return TiledClass(self)

        def load(self, id_name):
            return np.full((4000, 1), int(id_name[-1]) % 2, np.float32)

    _, _, num_q = load_corpus()
    hp = ClassificationTrainer.create_hparams()
    hp.device = str(device)
    hp.set_hparam("num_classes", 2)
    hp.out_dir = workdir
    hp.model_name = "clf"
    hp.epochs = 3
    hp.batch_size_train = 3
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    trainer = ClassificationTrainer(hp, fixture_ids())
    readers = [QuestionLabelGen.Config(
                   name="questions",
                   directory=os.path.join(FIXTURES, "questions"),
                   num_questions=num_q, match_length=("class_target",)),
               TiledClass.Config(name="class_target",
                                 match_length=("questions",))]
    cfg = convert_legacy_string("RNNDYN-2_RELU_32-1_FC_2", num_q)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_class",)
    trainer.init(hp, model_config=cfg, data_reader_configs=readers)
    _, loss = trainer.train(hp)
    accuracy, confusion = trainer.benchmark(hp, trainer.id_list_train)
    log("  classification: train loss {} | unweighted accuracy {:.3f}, "
        "confusion {}".format(["{:.4f}".format(v) for v in loss], accuracy,
                              confusion.tolist()))
    if not (loss[-1] < loss[0] and confusion.sum() > 0):
        fail("classification training: {} / {}".format(loss, confusion))
    return dict(train_loss=loss, accuracy=float(accuracy),
                confusion=confusion.tolist())


def remaining_models(torch, device, card, workdir):
    """Phase 13: every path of the remaining models and trainers, each
    with the launch counters reset just before and read just after."""
    t0 = time.perf_counter()
    out = {}
    log("  (a) WaveNet vocoder training")
    out["wavenet"] = wavenet_training(torch, device, card, workdir)
    log("  (b) the atom family at full width")
    out["atoms"] = atom_family(torch, device, card, workdir)
    log("  (c) VTLN at full width")
    out["vtln"] = vtln_full(torch, device, card, workdir)
    log("  (d) the intonation and VTLN quality pins from the JAX draw")
    out["pins"] = intonation_pins(torch, device, card, workdir)
    log("  (e) the encoder-decoder, classification, windowing")
    out["enc_dec"] = enc_dec_small_models(torch, device, card, workdir)
    out["seconds"] = time.perf_counter() - t0
    log("  phase 13 took {:.1f} s".format(out["seconds"]))
    return out


# -- phase 14 ----------------------------------------------------------------

def dp_handler(device, model_string):
    """The model's handler (seed 1234) with SGD at DP_LR."""
    from idiaptts_torch.hparams import ExtendedHParams
    handler = train_handler(device, model_string)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = DP_LR
    hp.optimiser_type = "SGD"
    handler.set_optimiser(hp)
    return handler


def dp_batch(torch, device, lengths):
    """The seeded global batch: utterances of ``lengths`` frames, padded
    to the longest, on the device."""
    B, T = len(lengths), max(lengths)
    lengths = np.asarray(lengths, np.int64)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    batch = random_batch(torch, device, B, T)
    batch["_seq_mask"] = torch.from_numpy(mask[..., None]).to(device)
    batch["questions"] = batch["questions"] * batch["_seq_mask"]
    batch["_lengths"] = {"questions": lengths.tolist()}
    return batch


def dp_steps(torch, handler, batch):
    """DP_STEPS checked steps (counters reset just before, read just
    after), the parameters after them, then the step's host-clock ms over
    DP_TIME_REPS more (each step ends in a host read of its loss).  The
    parameters are the one-device state dict (gathered from the shards
    under tensor parallelism: every rank calls this)."""
    from idiaptts_torch.ops import dispatch

    def sync():
        if handler.device.type == "cuda":
            torch.cuda.synchronize(handler.device)

    dispatch.reset_counts()
    losses = [handler.process_batches([batch])[0] for _ in range(DP_STEPS)]
    sync()
    launches = dispatch.counts()
    state = {k: v.detach().cpu().clone()
             for k, v in handler.full_state_dict().items()}
    t0 = time.perf_counter()
    for _ in range(DP_TIME_REPS):
        handler.process_batches([batch])
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / DP_TIME_REPS
    return losses, launches, state, ms


def dp_worker(config):
    """One rank of phase 14 (a), run as ``chip_smoke.py --dp-worker
    CONFIG`` (JSON: rank, world, backend, url, out, device, model,
    lengths)."""
    import torch
    rank, world = config["rank"], config["world"]
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import (cuda_lstm, cuda_mlpg,  # noqa: F401
                                    cuda_wavenet, dispatch)
    from idiaptts_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(config["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dispatch.library()
    mesh = mesh_lib.initialise_multihost(config["url"], world, rank,
                                         backend=config["backend"],
                                         device=device)
    probe = torch.full((4,), float(rank + 1), device=device)
    mesh_lib.all_reduce_flat([probe])
    handler = dp_handler(device, config["model"])
    handler.setup_mesh(world)
    losses, launches, state, ms = dp_steps(
        torch, handler, dp_batch(torch, device, config["lengths"]))
    torch.save({"rank": rank, "mesh": repr(mesh),
                "backend": config["backend"], "probe": probe.cpu(),
                "losses": losses, "launches": launches, "ms": ms,
                "state": state if rank == 0 else None}, config["out"])
    torch.distributed.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(world, backend, device, workdir):
    """Run ``world`` ranks of ``dp_worker`` on ``device``; returns their
    outputs.  Every process is waited for (or killed at the time limit)."""
    import torch
    url = "tcp://localhost:{}".format(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [os.path.join(workdir, "dp_{}_{}_{}.pt".format(backend, world, r))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker",
         json.dumps({"rank": r, "world": world, "backend": backend,
                     "url": url, "out": outs[r], "device": str(device),
                     "model": DP_MODEL, "lengths": list(DP_LENGTHS)})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError("{} rank {} of {} exited {}:\n{}".format(
                backend, r, world, proc.returncode, text[-3000:]))
    return [torch.load(path, weights_only=False) for path in outs]


def _dp_against(torch, name, ranks, ref_losses, ref_state,
                kernels=DP_KERNELS):
    """Losses and rank 0's parameters against the one-process step, and
    ``kernels`` launched on every rank."""
    losses = ranks[0]["losses"]
    rel = float(np.max(np.abs(np.asarray(losses) - ref_losses)
                       / np.abs(ref_losses)))
    if not rel <= DP_LOSS_RTOL:
        fail("{}: losses {} vs one process {} (relative {:.2e})".format(
            name, losses, ref_losses, rel))
    worst, worst_name = 0.0, None
    for key, value in ref_state.items():
        got = ranks[0]["state"][key]
        excess = ((got - value).abs() - DP_PARAM_RTOL * value.abs()
                  ).max().item()
        if excess > worst:
            worst, worst_name = excess, key
        if not torch.allclose(got, value, rtol=DP_PARAM_RTOL,
                              atol=DP_PARAM_ATOL):
            fail("{}: parameter {} beyond rtol {} atol {} of the one-process"
                 " step".format(name, key, DP_PARAM_RTOL, DP_PARAM_ATOL))
    for rank in ranks:
        require_launches(rank["launches"], kernels,
                         "{} rank {}".format(name, rank["rank"]))
    if len({tuple(r["losses"]) for r in ranks}) != 1:
        fail("{}: ranks report different losses".format(name))
    return {"losses": losses, "loss_rel": rel,
            "param_excess_over_rtol": worst, "param_worst": worst_name,
            "launches_by_rank": [r["launches"] for r in ranks],
            "step_ms_by_rank": [r["ms"] for r in ranks]}


def data_parallel(torch, device, card, workdir):
    """Phase 14 (a): the data-parallel step of ``MODEL_STRING`` on the
    card, two gloo ranks sharing it and a one-rank NCCL world, against
    the one-process step."""
    handler = dp_handler(device, DP_MODEL)
    ref_losses, launches, ref_state, ref_ms = dp_steps(
        torch, handler, dp_batch(torch, device, DP_LENGTHS))
    del handler
    torch.cuda.empty_cache()
    log("  one process: losses {} | {:.3f} ms a step | launches {} [{}]"
        .format(["{:.6f}".format(x) for x in ref_losses], ref_ms,
                json.dumps(launches), card))
    out = {"one_process": {"losses": ref_losses, "step_ms": ref_ms,
                           "launches": launches}}
    for name, world, backend in DP_WORLDS:
        t0 = time.perf_counter()
        ranks = spawn_ranks(world, backend, device, workdir)
        probe = ranks[0]["probe"].tolist()
        want = float(sum(range(1, world + 1)))
        if probe != [want] * 4:
            fail("{}: all_reduce probe {} != {}".format(name, probe, want))
        out[name] = _dp_against(torch, name, ranks, ref_losses, ref_state)
        out[name]["spawn_s"] = time.perf_counter() - t0
        log("  {} ({}): losses {} (relative {:.2e} of one process), "
            "parameters' largest excess over rtol {:.2e} ({}) | {} ms a "
            "step by rank | launches rank 0 {} | {:.1f} s with start-up [{}]"
            .format(name, ranks[0]["mesh"],
                    ["{:.6f}".format(x) for x in out[name]["losses"]],
                    out[name]["loss_rel"],
                    out[name]["param_excess_over_rtol"],
                    out[name]["param_worst"],
                    ["{:.3f}".format(x) for x in out[name][
                        "step_ms_by_rank"]],
                    json.dumps(ranks[0]["launches"]), out[name]["spawn_s"],
                    card))
    return out


def _wav_peak(path):
    from idiaptts_torch.ops.audio_io import get_raw
    raw, _ = get_raw(path)
    return raw, float(np.abs(raw).max()) if raw.size else 0.0


def _rms_db(raw):
    """Root-mean-square level in dB of full scale (-inf for silence)."""
    with np.errstate(divide="ignore"):
        return float(10.0 * np.log10(np.mean(raw.astype(np.float64) ** 2)))


def ljspeech_recipe(torch, device, card, workdir):
    """Phase 14 (b): ``egs.ljspeech_demo`` stages 1-8 on the card at full
    width, one stage a call, counters reset just before and read just
    after each."""
    from idiaptts_torch.egs import ljspeech_demo
    from idiaptts_torch.ops import dispatch
    work = os.path.join(workdir, "ljspeech_demo")
    out = {"launches": {}, "seconds": {}}
    for stage in range(1, 9):
        epochs = RECIPE_EPOCHS_WAVENET if stage == 8 else RECIPE_EPOCHS
        dispatch.reset_counts()
        t0 = time.perf_counter()
        result = ljspeech_demo.main([
            "--work_dir", work, "--fixtures", FIXTURES, "--device",
            str(device),
            "--stage", str(stage), "--stop_stage", str(stage),
            "--epochs", str(epochs)])[stage]
        torch.cuda.synchronize()
        out["seconds"][stage] = time.perf_counter() - t0
        out["launches"][stage] = launches = dispatch.counts()
        log("  stage {}: {:.1f} s | launches {}".format(
            stage, out["seconds"][stage], json.dumps(launches)))
        require_launches(launches, RECIPE_STAGE_KERNELS.get(stage, ()),
                         "ljspeech_demo stage {}".format(stage))
        if stage in (3, 4, 8):
            losses = result["train_loss"] + result["val_loss"]
            out["losses_{}".format(stage)] = losses
            if not np.all(np.isfinite(losses)):
                fail("ljspeech_demo stage {}: non-finite loss {}".format(
                    stage, losses))
        if stage == 5:
            out["scores"] = [float(x) for x in result]
            log("  benchmark (MCD dB, F0-RMSE Hz, VDE, BAP dB): {} [{}]"
                .format(out["scores"], card))
            if not np.all(np.isfinite(out["scores"])):
                fail("ljspeech_demo benchmark: non-finite scores")
        if stage == 7:
            out["serve_stats"] = result["stats"]
            levels = {}
            for id_name, path in result["paths"].items():
                raw, peak = _wav_peak(path)
                recorded, _ = _wav_peak(os.path.join(
                    FIXTURES, "database", "wav", id_name + ".wav"))
                levels[id_name] = {"peak": peak, "rms_db": _rms_db(raw),
                                   "recorded_rms_db": _rms_db(recorded)}
                gap = levels[id_name]["rms_db"] \
                    - levels[id_name]["recorded_rms_db"]
                # Audible: the served level within RECIPE_LOUDNESS_DB of
                # the fixture recording's.
                if not np.all(np.isfinite(raw)) \
                        or not gap >= -RECIPE_LOUDNESS_DB:
                    fail("served {}: not finite or too quiet ({:.2f} dB "
                         "RMS, {:.2f} dB against the recording's {:.2f}; "
                         "floor -{} dB)".format(
                             id_name, levels[id_name]["rms_db"], gap,
                             levels[id_name]["recorded_rms_db"],
                             RECIPE_LOUDNESS_DB))
            out["served_levels"] = levels
            log("  served: {} | levels {}".format(
                json.dumps(result["stats"]), json.dumps(levels)))
        if stage == 8:
            _, out["wavenet_peak"] = _wav_peak(
                next(iter(result["paths"].values())))
    return out


def intonation_recipe(torch, device, card, workdir):
    """Phase 14 (c): ``egs.intonation_demo`` stages 1-6 on the card, at
    the recipe's default epochs."""
    from idiaptts_torch.egs import intonation_demo
    t0 = time.perf_counter()
    results = intonation_demo.main([
        "--work_dir", os.path.join(workdir, "intonation_demo"),
        "--fixtures", FIXTURES, "--device", str(device)])
    scores = {stage: [float(x) for x in results[stage]["scores"]]
              for stage in (4, 5, 6)}
    for stage, value in scores.items():
        if not np.all(np.isfinite(value)):
            fail("intonation_demo stage {}: non-finite benchmark {}"
                 .format(stage, value))
    seconds = time.perf_counter() - t0
    log("  F0-RMSE Hz, VDE by stage: {} | {:.1f} s [{}]".format(
        json.dumps(scores), seconds, card))
    return {"scores": scores, "seconds": seconds}


def split_serving(torch, device, card):
    """Phase 14 (d): ``FusedAcousticPipeline(devices=[card, card])`` at
    B = 6 against ``devices=None``, with a seeded F0 contour on the card:
    the PCM equal sample for sample, the padded tails silent; K6's
    projection, K3 and K2 launched by the split run.  Then the weights
    are changed in place on the caller's stream behind a spin of the
    card, and a split call follows with no synchronisation: its PCM must
    equal the one-device run's on the changed weights, which holds only
    if the side streams wait for the caller's queued work."""
    from idiaptts_torch.ops import audio_io, dispatch
    questions, model, make_pipeline = build_slice(torch, device)
    plain = make_pipeline(device)
    split = make_pipeline(device, devices=[device, device])
    T = -(-max(len(q) for q in questions) // plain.bucket) * plain.bucket
    f0 = torch.from_numpy(np.random.RandomState(14).uniform(
        90.0, 220.0, (len(questions), T)).astype(np.float32)).to(device)
    ref = plain(model, questions, f0_cont=f0, seed=5,
                device_output=True).cpu().numpy()
    dispatch.reset_counts()
    got = split(model, questions, f0_cont=f0, seed=5, device_output=True)
    torch.cuda.synchronize()
    launches = dispatch.counts()
    got = got.cpu().numpy()
    require_launches(launches, SERVE_KERNELS, "batch-split serving")
    pcm_equal = bool(np.array_equal(audio_io.float_to_pcm16(got),
                                    audio_io.float_to_pcm16(ref)))
    diff = float(np.abs(got - ref).max())
    if not pcm_equal:
        fail("batch-split serving: PCM differs from one device (largest "
             "float difference {:.3e})".format(diff))
    tails = []
    for row, q in zip(got, questions):
        body = row[:len(q) * plain.hop]
        tail = row[len(q) * plain.hop + 400:]
        tails.append(float(np.abs(tail).max() / np.abs(body).max())
                     if tail.size else 0.0)
    if not max(tails) < 1e-3:
        fail("batch-split serving: padded tail not silent ({})".format(
            max(tails)))
    # Weights changed in place just before a split call.
    unchanged = audio_io.float_to_pcm16(plain(
        model, questions, seed=5, device_output=True).cpu().numpy())
    with torch.no_grad():
        originals = [p.detach().clone() for p in model.parameters()]
        for p in model.parameters():
            p.mul_(SPLIT_WEIGHT_SCALE)
    changed = plain(model, questions, seed=5, device_output=True)
    changed = audio_io.float_to_pcm16(changed.cpu().numpy())
    if np.array_equal(changed, unchanged):
        fail("batch-split serving: scaling the weights by {} left the PCM "
             "as it was".format(SPLIT_WEIGHT_SCALE))
    with torch.no_grad():
        for p, o in zip(model.parameters(), originals):
            p.copy_(o)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPLIT_SPIN_CYCLES)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(SPLIT_WEIGHT_SCALE)
    after = split(model, questions, seed=5, device_output=True)
    after = audio_io.float_to_pcm16(after.cpu().numpy())
    ordered = bool(np.array_equal(after, changed))
    if not ordered:
        fail("batch-split serving: a split call right after an in-place "
             "weight change returned other PCM than one device on the "
             "changed weights ({} samples differ)".format(
                 int((after != changed).sum())))
    with torch.no_grad():
        for p, o in zip(model.parameters(), originals):
            p.copy_(o)
    ms = cuda_ms(torch, lambda: split(model, questions, seed=5), 3)
    ms_plain = cuda_ms(torch, lambda: plain(model, questions, seed=5), 3)
    log("  B={} over 2 x {}: PCM equal {} (float difference {:.3e}), tail "
        "/ peak {:.2e}, ordered after an in-place weight change {} | "
        "{:.3f} ms split, {:.3f} ms one device | launches {} [{}]".format(
            len(questions), device, pcm_equal, diff, max(tails), ordered,
            ms, ms_plain, json.dumps(launches), card))
    return {"pcm_equal": pcm_equal, "max_float_diff": diff,
            "tail_over_peak": max(tails), "ordered_after_weight_change":
            ordered, "ms": ms, "ms_one_device": ms_plain,
            "launches": launches}


def enhancement_check(torch, device, card):
    """Phase 14 (e): ``enhance`` of one fixture wav plus seeded noise on
    the card against the CPU path, both in float64."""
    from idiaptts_torch.ops import audio_io, enhancement
    raw, fs = audio_io.get_raw(os.path.join(FIXTURES, "database", "wav",
                                            "gen-0001.wav"))
    noisy = raw.astype(np.float64) \
        + 0.01 * np.random.RandomState(0).randn(len(raw))
    out = {}
    for t60 in (None, 0.5):
        cpu = enhancement._enhance(torch.as_tensor(noisy), fs, t60=t60)
        x = torch.as_tensor(noisy, device=device)
        card_out = enhancement._enhance(x, fs, t60=t60).cpu()
        rel = ((card_out - cpu).abs().max() / cpu.abs().max()).item()
        _check("enhance t60={}".format(t60), rel, ENHANCE_TOL,
               "relative to the peak, float64")
        ms = cuda_ms(torch, lambda: enhancement._enhance(x, fs, t60=t60), 3)
        out[str(t60)] = {"rel": rel, "ms": ms,
                         "xrt": len(raw) / fs / (ms / 1e3)}
        log("  enhance t60={}: card vs CPU {:.2e} of the peak | {:.3f} ms, "
            "{:.1f}x real time [{}]".format(t60, rel, ms,
                                            out[str(t60)]["xrt"], card))
    return out


def port_surface(torch, device, card, workdir):
    """Phase 14: data-parallel training, the two recipes, batch-split
    serving and enhancement on the card."""
    t0 = time.perf_counter()
    out = {}
    log("  (a) data-parallel training, {} at D_in={}, B={} T={} (lengths "
        "{}), SGD lr {}".format(DP_MODEL, TRAIN_D_IN, len(DP_LENGTHS),
                                max(DP_LENGTHS), DP_LENGTHS, DP_LR))
    out["data_parallel"] = data_parallel(torch, device, card, workdir)
    torch.cuda.empty_cache()
    log("  (b) egs.ljspeech_demo stages 1-8 at full width")
    out["ljspeech"] = ljspeech_recipe(torch, device, card, workdir)
    torch.cuda.empty_cache()
    log("  (c) egs.intonation_demo stages 1-6")
    out["intonation"] = intonation_recipe(torch, device, card, workdir)
    log("  (d) batch-split serving over two streams of the card")
    out["split"] = split_serving(torch, device, card)
    torch.cuda.empty_cache()
    log("  (e) enhance, card against CPU")
    out["enhance"] = enhancement_check(torch, device, card)
    out["seconds"] = time.perf_counter() - t0
    log("  phase 14 took {:.1f} s".format(out["seconds"]))
    return out


# -- phase 15 ----------------------------------------------------------------

def _onedir_inputs(torch, gen, T, B, D, F):
    """Seeded two-direction inputs of one layer: xin (T, 2B, D) bf16, Wx
    (2, D, 4F) bf16, the bias (2, 4F), wh_cat (2F, 4F) bf16 and an
    upstream cotangent (T, 2B, F)."""
    xin, wx, bias = projection_inputs(torch, gen, T, B, D, F)
    wh = (torch.randn(2 * F, 4 * F, generator=gen, device=gen.device)
          / np.sqrt(F)).to(torch.bfloat16)
    gout = 0.1 * torch.randn(T, 2 * B, F, generator=gen, device=gen.device)
    return xin, wx, bias, wh, gout


def onedir_kernel_checks(torch, device, shapes=TP_ONEDIR_SHAPES, reps=5):
    """Phase 15 (a): the one-direction instances of the projection, K3,
    K4 and K5 on each direction's inputs, ``torch.equal`` to that half of
    the two-direction launch, and against their plain versions on the
    same inputs (the two-direction kernels' tolerances); then timed
    beside their plain versions and a unidirectional cuDNN LSTM (a bf16
    ``torch.mm`` for the projection).  Returns {kernel name: {tag:
    measurements}}, tag B for F = F_HIDDEN and "narrow" for F = 64."""
    from idiaptts_torch.ops import cuda_lstm
    gen = torch.Generator(device=device).manual_seed(1515)
    names = ("bilstm_proj_onedir", "bilstm_recurrence_onedir",
             "bilstm_recurrence_train_onedir", "bilstm_bwd_onedir")
    out = {n: {} for n in names}
    for T, B, D, F in shapes:
        tag = B if F == F_HIDDEN else "narrow"
        shape = "T={},R={},D={},F={}".format(T, B, D, F)
        xin, wx, bias, wh, gout = _onedir_inputs(torch, gen, T, B, D, F)
        xp2 = cuda_lstm.bilstm_projection_tmajor(xin, wx, bias)
        h2 = cuda_lstm.bilstm_recurrence_tmajor(xp2, wh)
        train2 = {res: cuda_lstm.bilstm_recurrence_train_tmajor(xp2, wh, res)
                  for res in (False, True)}
        dz2 = {res: cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
               for res, (_, a, c) in train2.items()}
        halves = True
        for d in range(2):
            rows, units = slice(d * B, (d + 1) * B), slice(d * F, (d + 1) * F)
            xp1 = cuda_lstm.bilstm_projection_tmajor(
                xin[:, rows].contiguous(), wx[d:d + 1], bias[d:d + 1])
            same = [torch.equal(xp1, xp2[:, rows]),
                    torch.equal(cuda_lstm.bilstm_recurrence_tmajor(
                        xp1, wh[units]), h2[:, rows])]
            for res, (h, a, c) in train2.items():
                h1, a1, c1 = cuda_lstm.bilstm_recurrence_train_tmajor(
                    xp1, wh[units], res)
                same += [torch.equal(h1, h[:, rows]),
                         torch.equal(a1, a[:, rows]),
                         torch.equal(c1, c[:, rows]),
                         torch.equal(cuda_lstm.dz_bwd_tmajor(
                             a1, c1, gout[:, rows].contiguous(), wh[units]),
                             dz2[res][:, rows])]
            if not all(same):
                halves = False
                fail("one-direction instances differ from the two-direction "
                     "launch's direction {} half ({}): {}".format(
                         d, shape, same))
        log("  one-direction {}: projection, K3, K4 (f32 and bf16 "
            "residuals) and K5 torch.equal to both halves: {}".format(
                shape, halves))
        # Against the plain versions, direction 0's inputs.
        x1, w1, b1 = xin[:, :B].contiguous(), wx[:1], bias[:1]
        wh1, g1 = wh[:F], gout[:, :B].contiguous()
        # The bf16 products (zero bias) at most one bf16 ulp apart, rarely;
        # the bias one float32 add after them (as projection_entry).
        zero = torch.zeros_like(b1)
        p_k = cuda_lstm.bilstm_projection_tmajor(x1, w1, zero)
        p_p = cuda_lstm.projection_tmajor_plain(x1, w1, zero)
        d_p = (p_k - p_p).abs()
        proj_excess = (d_p - bf16_ulp(torch, torch.maximum(
            p_k.abs(), p_p.abs())) - 1e-5).max().item()
        if proj_excess > 0 or (d_p > 0).float().mean().item() > 1e-2:
            fail("bilstm_proj_onedir beyond rare one-ulp flips ({})".format(
                shape))
        xp1 = cuda_lstm.bilstm_projection_tmajor(x1, w1, b1)
        if not torch.equal(xp1, p_k + b1[0]):
            fail("bilstm_proj_onedir bias add differs ({})".format(shape))
        h1 = cuda_lstm.bilstm_recurrence_tmajor(xp1, wh1)
        h1_p = cuda_lstm.recurrence_tmajor_plain(xp1, wh1)
        rec_err = (h1 - h1_p).abs().max().item()
        _check("bilstm_recurrence_onedir", rec_err, REC_TOL, shape)
        ht, a1, c1 = cuda_lstm.bilstm_recurrence_train_tmajor(xp1, wh1)
        ht_p, a1_p, c1_p = cuda_lstm.recurrence_train_tmajor_plain(xp1, wh1)
        tr_errs = {"h": (ht - ht_p).abs().max().item(),
                   "a": (a1 - a1_p).abs().max().item(), "c": _rel(c1, c1_p)}
        for k, e in tr_errs.items():
            _check("rec_train_onedir " + k, e, REC_TOL, shape)
        dz1 = cuda_lstm.dz_bwd_tmajor(a1, c1, g1, wh1)
        dz1_p = cuda_lstm.dz_bwd_tmajor_plain(a1, c1, g1, wh1)
        _check("bilstm_bwd_onedir dz", _rel(dz1, dz1_p), 1e-3, shape)
        # Times beside the plain versions and the library yardsticks.
        lstm = cudnn_lstm(torch, D, F, device, bidirectional=False)
        x_seq = x1.detach().clone().requires_grad_()
        lib_eval = cuda_ms(torch, lambda: lstm.eval()(x_seq.detach()), reps)
        lstm.train()
        lib_fwd = cuda_ms(torch, lambda: lstm(x_seq), reps)
        y_seq, _ = lstm(x_seq)
        gy = torch.randn(y_seq.shape, generator=gen, device=device,
                         dtype=y_seq.dtype)
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            y_seq, x_seq, gy, retain_graph=True), reps)
        x_flat = x1.reshape(T * B, D)
        entries = {
            "bilstm_proj_onedir": (
                lambda: cuda_lstm.bilstm_projection_tmajor(x1, w1, b1),
                lambda: cuda_lstm.projection_tmajor_plain(x1, w1, b1),
                cuda_ms(torch, lambda: torch.mm(x_flat, w1[0]), reps),
                d_p.max().item(), "proj", 10),
            "bilstm_recurrence_onedir": (
                lambda: cuda_lstm.bilstm_recurrence_tmajor(xp1, wh1),
                lambda: cuda_lstm.recurrence_tmajor_plain(xp1, wh1),
                lib_eval, rec_err, "rec", 1),
            "bilstm_recurrence_train_onedir": (
                lambda: cuda_lstm.bilstm_recurrence_train_tmajor(xp1, wh1),
                lambda: cuda_lstm.recurrence_train_tmajor_plain(xp1, wh1),
                lib_fwd, max(tr_errs.values()), "rec_train", 1),
            "bilstm_bwd_onedir": (
                lambda: cuda_lstm.dz_bwd_tmajor(a1, c1, g1, wh1),
                lambda: cuda_lstm.dz_bwd_tmajor_plain(a1, c1, g1, wh1),
                lib_bwd, (dz1 - dz1_p).abs().max().item(), "bwd", 1)}
        for name, (kernel, plain, lib_ms, err, what, plain_reps) \
                in entries.items():
            ms = cuda_ms(torch, kernel, reps)
            bound_ms, bound_by = lstm_bound(T, B, D, F, what, ndir=1)
            out[name][tag] = dict(
                shape=shape, max_abs_err=err, ms=ms,
                plain_ms=cuda_ms(torch, plain, plain_reps),
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                halves_equal=halves)
            if what != "proj":
                out[name][tag]["us_per_step"] = ms * 1e3 / T
            log("  {:<31s} {:<24s} kernel {:9.4f} ms | plain {:9.4f} ms | "
                "library {:9.4f} ms | bound {:8.4f} ms ({})".format(
                    name, shape, ms, out[name][tag]["plain_ms"], lib_ms,
                    bound_ms, bound_by))
        del xin, wx, xp2, h2, train2, dz2, lstm, y_seq, x_seq
        torch.cuda.empty_cache()
    return out


def param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tp_worker(config):
    """One rank of phase 15 (b)-(e), run as ``chip_smoke.py --tp-worker
    CONFIG`` (JSON: rank, world, model_parallel, backend, url, out,
    device, model, lengths, checkpoint): the checked and timed steps, an
    evaluation and an inference, each with the counters reset just
    before and read just after, and a checkpoint (rank 0 writes)."""
    import torch
    rank, world = config["rank"], config["world"]
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import (cuda_lstm, cuda_mlpg,  # noqa: F401
                                    cuda_wavenet, dispatch)
    from idiaptts_torch.parallel import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh_lib.rank_device(config["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dispatch.library()
    mesh_lib.initialise_multihost(config["url"], world, rank,
                                  backend=config["backend"], device=device)
    handler = dp_handler(device, config["model"])
    handler.setup_mesh(world, model_parallel=config["model_parallel"])
    batch = dp_batch(torch, device, config["lengths"])
    losses, launches, state, ms = dp_steps(torch, handler, batch)
    norm = handler.last_grad_norm

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    dispatch.reset_counts()
    val = handler.process_batches([batch], training=False)[0]
    pred = handler.inference(batch)["pred"]
    sync()
    eval_launches = dispatch.counts()
    handler.save_checkpoint(config["checkpoint"], "tp",
                            step=handler.total_steps)
    final = {k: v.detach().cpu().clone()
             for k, v in handler.full_state_dict().items()}
    torch.save({"rank": rank, "mesh": repr(handler.mesh),
                "backend": config["backend"], "losses": losses,
                "grad_norm": norm, "launches": launches, "ms": ms,
                "val": val, "eval_launches": eval_launches,
                "bytes": param_bytes(handler.model),
                "state": state if rank == 0 else None,
                "final_state": final if rank == 0 else None,
                "pred": pred if rank == 0 else None}, config["out"])
    torch.distributed.destroy_process_group()
    return 0


def spawn_tp_ranks(name, world, model_parallel, backend, device, workdir):
    """Run ``world`` ranks of ``tp_worker`` (ranks that share a card get
    ``device``; NCCL ranks one card each); returns their outputs.  Every
    process is waited for (or killed at the time limit)."""
    import torch
    url = "tcp://localhost:{}".format(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [os.path.join(workdir, "tp_{}_{}.pt".format(name, r))
            for r in range(world)]
    ckpt = os.path.join(workdir, "tp_ckpt_" + name)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker",
         json.dumps({"rank": r, "world": world,
                     "model_parallel": model_parallel, "backend": backend,
                     "url": url, "out": outs[r],
                     "device": "cuda" if backend == "nccl" else str(device),
                     "model": TP_MODEL, "lengths": list(DP_LENGTHS),
                     "checkpoint": ckpt})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError("{} rank {} of {} exited {}:\n{}".format(
                name, r, world, proc.returncode, text[-3000:]))
    return [torch.load(path, weights_only=False) for path in outs], ckpt


def expected_tp_bytes(model, model_parallel):
    """A rank's parameter bytes under make_param_shardings at M."""
    from idiaptts_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.TensorMesh(mesh_lib.DataMesh(1, 0, "cpu"),
                               mesh_lib.DataMesh(model_parallel, 0, "cpu"),
                               "cpu")
    shardings = mesh_lib.make_param_shardings(model, mesh)
    total = 0
    for name, p in model.named_parameters():
        dim = shardings[name]
        parts = 1 if dim is None else min(model_parallel, p.shape[dim])
        total += p.numel() * p.element_size() // parts
    return total


def _tp_against(torch, name, M, ranks, ref, expect_bytes):
    """Phase 15 (b, c): losses, rank 0's gathered parameters and the grad
    norm against the one-process step; every rank's one-direction
    launches (TP_LAUNCHES of each of TP_KERNELS, none of the
    two-direction kernels) and parameter bytes."""
    out = _dp_against(torch, name, ranks, ref["losses"], ref["state"],
                      TP_KERNELS)
    norm_rel = abs(ranks[0]["grad_norm"] - ref["grad_norm"]) \
        / ref["grad_norm"]
    if not norm_rel <= TP_NORM_RTOL:
        fail("{}: grad norm {} vs one process {}".format(
            name, ranks[0]["grad_norm"], ref["grad_norm"]))
    for rank in ranks:
        counts = rank["launches"]
        wrong = {k: counts.get(k, 0) for k in TP_KERNELS
                 if counts.get(k, 0) != TP_LAUNCHES}
        wrong.update({k: counts[k] for k in DP_KERNELS if counts.get(k)})
        if wrong:
            fail("{} rank {}: launches {} (want {} of each of {} and no "
                 "two-direction launch)".format(name, rank["rank"], wrong,
                                                TP_LAUNCHES, TP_KERNELS))
        ev = rank["eval_launches"]
        if ev.get("bilstm_recurrence_onedir", 0) < 1 \
                or ev.get("bilstm_proj_onedir", 0) < 1:
            fail("{} rank {}: the TP evaluation launched {}".format(
                name, rank["rank"], ev))
        if rank["bytes"] != expect_bytes:
            fail("{} rank {}: {} parameter bytes, want {}".format(
                name, rank["rank"], rank["bytes"], expect_bytes))
    val_rel = abs(ranks[0]["val"] - ref["val"]) / ref["val"]
    if not val_rel <= DP_LOSS_RTOL:
        fail("{}: evaluation loss {} vs one process {}".format(
            name, ranks[0]["val"], ref["val"]))
    out.update(model_parallel=M, grad_norm_rel=norm_rel, val_rel=val_rel,
               bytes_by_rank=[r["bytes"] for r in ranks],
               bytes_share=ranks[0]["bytes"] / ref["bytes"],
               eval_launches_by_rank=[r["eval_launches"] for r in ranks],
               mesh_by_rank=[r["mesh"] for r in ranks])
    return out


def _tp_checkpoint(torch, device, name, ckpt, rank0):
    """Phase 15 (e): the TP checkpoint that rank 0 wrote, loaded into a
    one-process handler (as the trainer's init loads one): the gathered
    parameters bit for bit, and its forward against the TP forward."""
    from idiaptts_torch.train.handler import ModularModelHandler
    one = ModularModelHandler(device=device)
    one.load_checkpoint(ckpt, "tp")
    same = all(torch.equal(one.model.state_dict()[k].cpu(), v)
               for k, v in rank0["final_state"].items())
    if not same:
        fail("{}: the TP checkpoint loads other parameters".format(name))
    pred = one.inference(dp_batch(torch, device, DP_LENGTHS))["pred"]
    err = float(np.abs(pred - rank0["pred"]).max()
                / max(1.0, np.abs(pred).max()))
    if not err <= TP_FORWARD_TOL:
        fail("{}: one-process forward of the TP checkpoint {:.3e} from the "
             "TP forward".format(name, err))
    return {"params_equal": same, "forward_rel": err}


def tensor_parallel(torch, device, card, workdir):
    """Phase 15: (a) the one-direction kernel instances; (b) the
    Interspeech'18 model trained at model_parallel=2 by two gloo ranks
    that share the card (and over NCCL, one rank a card, where there are
    cards enough) against the one-process step; (c) each rank's
    launches and parameter bytes; (d) a TP evaluation and inference;
    (e) the TP checkpoint in a one-process handler."""
    t0 = time.perf_counter()
    out = {}
    log("  (a) one-direction instances, T={} B={} D={} F={} and F={} "
        "[{}]".format(TRAIN_T, [s[1] for s in TP_ONEDIR_SHAPES], D_IN,
                      F_HIDDEN, NARROW[1], card))
    out["onedir"] = onedir_kernel_checks(torch, device, TP_ONEDIR_SHAPES)
    log("  (b) {} at D_in={}, B={} T={} (lengths {}), SGD lr {}".format(
        TP_MODEL, TRAIN_D_IN, len(DP_LENGTHS), max(DP_LENGTHS),
        DP_LENGTHS, DP_LR))
    handler = dp_handler(device, TP_MODEL)
    batch = dp_batch(torch, device, DP_LENGTHS)
    losses, launches, state, ms = dp_steps(torch, handler, batch)
    ref = {"losses": losses, "state": state, "step_ms": ms,
           "launches": launches, "grad_norm": handler.last_grad_norm,
           "val": handler.process_batches([batch], training=False)[0],
           "bytes": param_bytes(handler.model)}
    expect = {M: expected_tp_bytes(handler.model, M) for M in (2, 4)}
    del handler, batch
    torch.cuda.empty_cache()
    log("  one process: losses {} | {:.3f} ms a step | {} parameter bytes "
        "[{}]".format(["{:.6f}".format(x) for x in losses], ms,
                      ref["bytes"], card))
    out["one_process"] = {k: ref[k] for k in (
        "losses", "step_ms", "launches", "grad_norm", "val", "bytes")}
    cards = torch.cuda.device_count()
    for name, world, M, backend, need in TP_WORLDS:
        if cards < need:
            log("  {}: needs {} cards, this machine has {}; not run".format(
                name, need, cards))
            continue
        t1 = time.perf_counter()
        ranks, ckpt = spawn_tp_ranks(name, world, M, backend, device,
                                     workdir)
        res = _tp_against(torch, name, M, ranks, ref, expect[M])
        res["spawn_s"] = time.perf_counter() - t1
        if name == TP_WORLDS[0][0]:
            res["checkpoint"] = _tp_checkpoint(torch, device, name, ckpt,
                                               ranks[0])
        out[name] = res
        log("  {} ({}): losses {} (relative {:.2e}), grad norm relative "
            "{:.2e}, parameters' largest excess over rtol {:.2e} ({}) | {} "
            "ms a step by rank | {:.4f} of the parameter bytes a rank | "
            "launches rank 0 {} | eval {} | {:.1f} s with start-up [{}]"
            .format(name, ranks[0]["mesh"],
                    ["{:.6f}".format(x) for x in res["losses"]],
                    res["loss_rel"], res["grad_norm_rel"],
                    res["param_excess_over_rtol"], res["param_worst"],
                    ["{:.3f}".format(x) for x in res["step_ms_by_rank"]],
                    res["bytes_share"], json.dumps({
                        k: v for k, v in ranks[0]["launches"].items() if v}),
                    json.dumps({k: v for k, v in ranks[0][
                        "eval_launches"].items() if v}), res["spawn_s"],
                    card))
        if "checkpoint" in res:
            log("  (e) {} checkpoint in one process: parameters equal {}, "
                "forward {:.3e} of the TP forward".format(
                    name, res["checkpoint"]["params_equal"],
                    res["checkpoint"]["forward_rel"]))
    out["seconds"] = time.perf_counter() - t0
    log("  phase 15 took {:.1f} s".format(out["seconds"]))
    return out


# -- phase 16 ----------------------------------------------------------------

def _bf16_ulps(torch, a, b):
    """Largest difference of ``a`` and ``b`` in bf16 ulps of the larger
    magnitude."""
    a, b = a.float(), b.float()
    ulp = bf16_ulp(torch, torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / ulp).max().item()


def _max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def wavenet_block_inputs(torch, gen, B, T):
    """Seeded card tensors of one block at the r9y9 widths: the float32
    stream x and its gradient dx', the bf16 products P1, P2 and their
    biases, the gradients dz and dtaps, the [skip | residual] product P
    with its bias, the skip sum and its gradient."""
    R, G = WN_R9Y9["residual_channels"], WN_R9Y9["gate_channels"]
    S, k = WN_R9Y9["skip_channels"], WN_R9Y9["kernel_size"]
    dev = gen.device

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(
            dtype)

    bf16 = torch.bfloat16
    return dict(
        x=randn(B, T, R), dxo=randn(B, T, R),
        p1=randn(B, T, G, scale=2.0, dtype=bf16),
        p2=randn(B, T, G, scale=2.0, dtype=bf16),
        b1=randn(G, scale=0.3), b2=randn(G, scale=0.3),
        dz=randn(B, T, G // 2, dtype=bf16),
        dtaps=randn(B, T, k * R, dtype=bf16),
        p=randn(B, T, S + R, dtype=bf16), bsr=randn(S + R, scale=0.1),
        skips=randn(B, T, S, dtype=bf16), dskips=randn(B, T, S, dtype=bf16))


def wavenet_kernel_bytes(B, T):
    """{kernel: HBM bytes} at one block's (B, T): each input read and each
    output written once (bf16 2 bytes, the float32 stream 4)."""
    R, G = WN_R9Y9["residual_channels"], WN_R9Y9["gate_channels"]
    S, k = WN_R9Y9["skip_channels"], WN_R9Y9["kernel_size"]
    row = {"wavenet_gate_fwd": 2 * (2 * G + G + G // 2),
           "wavenet_gate_bwd": 2 * (G + G // 2 + G),
           "wavenet_taps": 4 * R + 2 * k * R,
           "wavenet_taps_bwd": 2 * k * R + 4 * R + 4 * R,
           "wavenet_residual": 2 * (S + R) + 4 * R + 2 * S + 4 * R + 2 * S,
           "wavenet_residual_bwd": 4 * R + 2 * S + 2 * (S + R)}
    return {name: B * T * n for name, n in row.items()}


def wavenet_train_kernel_checks(torch, device, reps=20, plain_reps=3):
    """Phase 16 (a): the six WaveNet training kernels through their
    wrappers against their plain versions on the same card tensors, at
    each of ``WN_TRAIN_SHAPES``; CUDA-event times of both.  Returns
    {kernel name: {shape tag: measurements}}."""
    from idiaptts_torch.ops import wavenet_block as wb
    from idiaptts_torch.ops import wavenet_gate as wg
    k = WN_R9Y9["kernel_size"]
    gen = torch.Generator(device=device).manual_seed(1616)
    out = {name: {} for name in WN_TRAIN_KERNELS}
    for B, T, d in WN_TRAIN_SHAPES:
        shape = "rows={}x{},R={},G={},S={},k={},d={}".format(
            B, T, WN_R9Y9["residual_channels"], WN_R9Y9["gate_channels"],
            WN_R9Y9["skip_channels"], k, d)
        t = wavenet_block_inputs(torch, gen, B, T)
        h, z = wg.gate(t["p1"], t["p2"], t["b1"], t["b2"])
        h_p, z_p = wg.gate_plain(t["p1"], t["p2"], t["b1"], t["b2"])
        dh = wg.gate_backward(h, t["dz"])
        dh_p = wg.gate_backward_plain(h, t["dz"])
        taps = wb.taps(t["x"], k, d)
        taps_p = wb.taps_plain(t["x"], k, d)
        dx = wb.taps_backward(t["dtaps"], t["dxo"], k, d)
        dx_p = wb.taps_backward_plain(t["dtaps"], t["dxo"], k, d)
        res = {first: wb.residual(t["p"], t["bsr"], t["x"],
                                  None if first else t["skips"])
               for first in (True, False)}
        res_p = {first: wb.residual_plain(t["p"], t["bsr"], t["x"],
                                          None if first else t["skips"])
                 for first in (True, False)}
        dp = wb.residual_backward(t["dxo"], t["dskips"])
        dp_p = wb.residual_backward_plain(t["dxo"], t["dskips"])
        torch.cuda.synchronize()
        # The gate's tanhf / expf against PyTorch's CUDA tanh and sigmoid
        # may differ by a float32 ulp, which moves a bf16 rounding by at
        # most one bf16 ulp; everything else is the same float32
        # operations in the same order, each rounded alone.
        agree = {
            "wavenet_gate_fwd": torch.equal(h, h_p)
            and _bf16_ulps(torch, z, z_p) <= 1.0,
            "wavenet_gate_bwd": _bf16_ulps(torch, dh, dh_p) <= 1.0,
            "wavenet_taps": torch.equal(taps, taps_p),
            "wavenet_taps_bwd": torch.equal(dx, dx_p),
            "wavenet_residual": all(
                torch.equal(res[f][0], res_p[f][0])
                and torch.equal(res[f][1], res_p[f][1]) for f in res),
            "wavenet_residual_bwd": torch.equal(dp, dp_p)}
        errs = {
            "wavenet_gate_fwd": max(_max_abs(h, h_p), _max_abs(z, z_p)),
            "wavenet_gate_bwd": _max_abs(dh, dh_p),
            "wavenet_taps": _max_abs(taps, taps_p),
            "wavenet_taps_bwd": _max_abs(dx, dx_p),
            "wavenet_residual": max(max(_max_abs(res[f][i], res_p[f][i])
                                        for i in (0, 1)) for f in res),
            "wavenet_residual_bwd": _max_abs(dp, dp_p)}
        for name, ok in agree.items():
            if not ok:
                fail("{} differs from its plain version beyond the bound "
                     "({}): max|d| {:.3e}".format(name, shape, errs[name]))
        calls = {
            "wavenet_gate_fwd": (
                lambda: wg.gate(t["p1"], t["p2"], t["b1"], t["b2"]),
                lambda: wg.gate_plain(t["p1"], t["p2"], t["b1"], t["b2"])),
            "wavenet_gate_bwd": (
                lambda: wg.gate_backward(h, t["dz"]),
                lambda: wg.gate_backward_plain(h, t["dz"])),
            "wavenet_taps": (lambda: wb.taps(t["x"], k, d),
                             lambda: wb.taps_plain(t["x"], k, d)),
            "wavenet_taps_bwd": (
                lambda: wb.taps_backward(t["dtaps"], t["dxo"], k, d),
                lambda: wb.taps_backward_plain(t["dtaps"], t["dxo"], k, d)),
            "wavenet_residual": (
                lambda: wb.residual(t["p"], t["bsr"], t["x"], t["skips"]),
                lambda: wb.residual_plain(t["p"], t["bsr"], t["x"],
                                          t["skips"])),
            "wavenet_residual_bwd": (
                lambda: wb.residual_backward(t["dxo"], t["dskips"]),
                lambda: wb.residual_backward_plain(t["dxo"], t["dskips"]))}
        nbytes = wavenet_kernel_bytes(B, T)
        for name, (kernel, plain) in calls.items():
            ms = cuda_ms(torch, kernel, reps)
            bound_ms, bound_by = bound(0.0, PEAK_BF16_FLOPS, nbytes[name])
            out[name][B] = dict(
                shape=shape, max_abs_err=errs[name], ms=ms,
                plain_ms=cuda_ms(torch, plain, plain_reps),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, matches_plain=agree[name])
            log("  {:<21s} {:<40s} kernel {:8.4f} ms | plain {:8.4f} ms | "
                "bound {:7.4f} ms ({}, {:.0%}) | max|d| {:.2e}".format(
                    name, shape, ms, out[name][B]["plain_ms"], bound_ms,
                    bound_by, bound_ms / ms, errs[name]))
        del t, h, z, h_p, z_p, dh, dh_p, taps, taps_p, dx, dx_p, res, \
            res_p, dp, dp_p, calls
        torch.cuda.empty_cache()
    return out


def wavenet_train_step(torch, device, card, seed=21):
    """Phase 16 (b): ModularModelHandler steps of the r9y9 WaveNet on
    wavenet.train's batch (32 seeded crops of ``WN_TRAIN_CROP`` samples,
    bucketed to 8192), Adam and the masked cross-entropy as
    WaveNetVocoderTrainer sets them.  Graphed (the block stack's CUDA
    graphs): one step that captures, one counted step that replays
    (every kernel of ``WN_TRAIN_KERNELS`` once a block, credited from
    the replays), three timed with CUDA events, the captures and replays,
    and the peak memory allocated and reserved.  Then eager (the graphs'
    budget 0): one warm-up step and three timed."""
    from idiaptts_torch.data.dataset import collate_batch
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.models.wavenet import WaveNet, WaveNetWrapper
    from idiaptts_torch.ops import cuda_graph
    from idiaptts_torch.train.handler import ModularModelHandler
    B, T = WN_TRAIN_SHAPES[0][:2]
    handler = ModularModelHandler(device=device)
    handler.create_model(WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", **WN_R9Y9), seed=seed)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    handler.set_optimiser(hp)
    handler.set_losses([NamedLoss.Config(
        "ce", "CrossEntropyLoss", ("pred_logits", "target_quantised"),
        seq_mask="_seq_mask", reduction="mean")])
    net = next(m for m in handler.model.modules() if isinstance(m, WaveNet))
    rng = np.random.default_rng(seed)
    C, Q = WN_R9Y9["cond_channels"], WN_R9Y9["out_channels"]
    batch = collate_batch([
        {"cond_features": rng.standard_normal(
            (WN_TRAIN_CROP, C)).astype(np.float32),
         "target_quantised": rng.integers(0, Q, (WN_TRAIN_CROP, 1)).astype(
             np.float32)} for _ in range(B)])
    if batch["cond_features"].shape[1] != T:
        fail("phase 16: the crops were bucketed to {}, not {}".format(
            batch["cond_features"].shape[1], T))
    torch.cuda.reset_peak_memory_stats(device)
    losses = [handler.process_batches([batch])[0]]
    loss, launches = counted(torch, lambda: handler.process_batches(
        [batch])[0])
    losses.append(loss)
    peak = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.max_memory_reserved(device)
    ms = cuda_ms(torch, lambda: handler.process_batches([batch]), 3)
    graphs = net.graph_counts()
    # Eager: a new cache that captures nothing (the captures' memory
    # goes with the old one).
    net._graphs = cuda_graph.GraphCache(budget=0)
    torch.cuda.empty_cache()
    eager_ms = cuda_ms(torch, lambda: handler.process_batches([batch]), 3)
    layers = WN_R9Y9["num_layers"]
    wrong = {name: launches.get(name, 0) for name in WN_TRAIN_KERNELS
             if launches.get(name, 0) != layers}
    if wrong:
        fail("phase 16: WaveNet kernels not launched once a block ({}) in "
             "a replayed train step: {}".format(layers, wrong))
    if graphs != {"captures": 1, "replays": 5, "eager": 0}:
        fail("phase 16: the graphed steps did not capture once and replay "
             "after: {}".format(graphs))
    if not all(np.isfinite(losses)):
        fail("phase 16: a WaveNet train step's loss is not finite: "
             "{}".format(losses))
    samples = B * WN_TRAIN_CROP
    log("  r9y9 WaveNet train step B={} T={}: losses {} | graphed {:.2f} "
        "ms, {:.0f} samples/s | eager {:.2f} ms | graphs {} | peak {:.2f} "
        "GB allocated, {:.2f} GB reserved | launches {} [{}]".format(
            B, T, ["{:.4f}".format(v) for v in losses], ms,
            samples / (ms / 1e3), eager_ms, json.dumps(graphs), peak / 1e9,
            reserved / 1e9,
            json.dumps({n: launches.get(n, 0) for n in WN_TRAIN_KERNELS}),
            card))
    del handler, batch, net
    torch.cuda.empty_cache()
    return dict(B=B, T=T, losses=losses, ms=ms, eager_ms=eager_ms,
                samples_per_s=samples / (ms / 1e3), peak_bytes=peak,
                reserved_bytes=reserved, graphs=graphs, launches=launches)


def wavenet_train_kernels(torch, device, card):
    """Phase 16: (a) the kernels at the cell's shapes, (b) the step."""
    log("== phase 16: WaveNet training kernels at wavenet.train's shapes "
        "[{}]".format(card))
    kernels = wavenet_train_kernel_checks(torch, device)
    return dict(kernels=kernels, step=wavenet_train_step(torch, device,
                                                         card))


def require_launches(launches, names, path):
    """Every kernel of a path must have launched during its run."""
    missing = [k for k in names if launches.get(k, 0) < 1]
    if missing:
        fail("kernels not launched on the {} path: {}".format(
            path, ", ".join(missing)))


def main():
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--dp-worker":
        return dp_worker(json.loads(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--tp-worker":
        return tp_worker(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from idiaptts_torch.ops import (cuda_lstm, cuda_mlpg,  # noqa: F401
                                    cuda_wavenet, dispatch, wavenet_block,
                                    wavenet_gate)

    log("== phase 1: environment")
    card = environment(torch)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    log("== phase 2: build")
    build()

    if len(sys.argv) > 1 and sys.argv[1] == "--phase15":
        return _phase15_alone(torch, device, card)
    if len(sys.argv) > 1 and sys.argv[1] == "--phase16":
        return _phase16_alone(torch, device, card)

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


def _phase15_alone(torch, device, card):
    """``chip_smoke.py --phase15``: phases 1, 2 and 15 only (on every
    card the machine has, for the NCCL worlds); prints phase 15's results
    as one JSON line and the card's name and power limit."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        log("== phase 15: tensor parallelism on {}".format(device))
        tp = tensor_parallel(torch, device, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if FAILURES:
        log("== {} check(s) failed:".format(len(FAILURES)))
        for message in FAILURES:
            log("  ", message)
        return 1
    print(json.dumps({"phase15": tp}, default=float))
    print(card)
    return 0


def _phase16_alone(torch, device, card):
    """``chip_smoke.py --phase16``: phases 1, 2 and 16 only; prints phase
    16's results as one JSON line and the card's name and power limit."""
    wtrain = wavenet_train_kernels(torch, device, card)
    if FAILURES:
        log("== {} check(s) failed:".format(len(FAILURES)))
        for message in FAILURES:
            log("  ", message)
        return 1
    print(json.dumps({"phase16": wtrain}, default=float))
    print(card)
    return 0


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
    narrow = narrow_train_steps(torch, device, card)
    torch.cuda.empty_cache()

    log("== phase 7: WaveNet sampler kernel against its plain version, "
        "{} layers, C={} and {} [{}]".format(WN_LAYERS, WN_COND, WN_COND_WIDE,
                                              card))
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
    torch.cuda.empty_cache()
    tfd = text_front_door(torch, device, card, workdir, trainer, hp)
    del trainer
    torch.cuda.empty_cache()
    rest = remaining_layers(torch, device, card, workdir)
    torch.cuda.empty_cache()
    extraction = feature_extraction(torch, device, card, workdir)
    torch.cuda.empty_cache()
    log("== phase 13: the remaining models and trainers on {}".format(
        device))
    remaining = remaining_models(torch, device, card, workdir)
    torch.cuda.empty_cache()
    log("== phase 14: data-parallel training, the recipes, batch-split "
        "serving and enhancement on {}".format(device))
    surface = port_surface(torch, device, card, workdir)
    dp = surface["data_parallel"]
    torch.cuda.empty_cache()
    log("== phase 15: tensor parallelism on {}".format(device))
    tp = tensor_parallel(torch, device, card, workdir)
    tp_runs = {k: v for k, v in tp.items()
               if isinstance(v, dict) and "launches_by_rank" in v}
    torch.cuda.empty_cache()
    wtrain = wavenet_train_kernels(torch, device, card)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        if name in kres:        # serving shapes (phase 3)
            first, second = kres[name][BATCHES[0]], kres[name][BATCHES[1]]
        elif name in tres:      # training shapes (phase 5)
            first = tres[name][TRAIN_BATCHES[0]]
            second = tres[name][TRAIN_BATCHES[1]]
        elif name in tp["onedir"]:     # one-direction shapes (phase 15)
            first = tp["onedir"][name][TRAIN_BATCHES[0]]
            second = tp["onedir"][name][TRAIN_BATCHES[1]]
        elif name in wtrain["kernels"]:     # wavenet.train's (phase 16)
            first = wtrain["kernels"][name][WN_TRAIN_SHAPES[0][0]]
            second = wtrain["kernels"][name][WN_TRAIN_SHAPES[1][0]]
        elif name == "mlpg_oneshot":    # evaluation shapes (phase 9)
            first = mres[MLPG_SHAPES[0]]
            second = {"T={},L={}".format(*k): v for k, v in mres.items()
                      if k != MLPG_SHAPES[0]}
        else:                   # sampler shapes (phase 7)
            first = wres[WN_CHECK_BATCHES[0]]
            second = wres[WN_CHECK_BATCHES[-1]]
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name],
                   "train_narrow": narrow["launches"][name],
                   "vocode": vocode_launches[name],
                   "evaluate": eval_launches[name],
                   "train_pins": tfd["pin_launches"][name],
                   "text": tfd["launches"][name],
                   "icassp19_serve": rest["icassp19"]["serve_launches"][
                       name],
                   "icassp19_train": rest["icassp19"]["train_launches"][
                       name],
                   "emb_train": rest["emb"]["train_launches"][name],
                   "emb_serve": rest["emb"]["serve_launches"][name],
                   "extract_train": extraction["voice"]["train_launches"][
                       name],
                   "extract_synth": extraction["voice"]["synth_launches"][
                       name],
                   "wavenet_train": remaining["wavenet"]["train_launches"][
                       name],
                   "wavenet_generate": remaining["wavenet"]["gen_launches"][
                       name],
                   "wavenet_train_r9y9": wtrain["step"]["launches"][name],
                   **{"{}_train".format(k): remaining["atoms"][k][
                       "train_launches"][name]
                      for k in ("atom", "flat", "phrase")},
                   "atom_benchmark": remaining["atoms"]["atom"][
                       "bench_launches"][name],
                   "vtln_train": remaining["vtln"]["train_launches"][name],
                   "vtln_benchmark": remaining["vtln"]["bench_launches"][
                       name],
                   "dp_one_process": dp["one_process"]["launches"][name],
                   **{"dp_gloo_rank{}".format(r): counts.get(name, 0)
                      for r, counts in enumerate(
                          dp["gloo_2"]["launches_by_rank"])},
                   "dp_nccl_rank0": dp["nccl_1"]["launches_by_rank"][0].get(
                       name, 0),
                   **{"ljspeech_stage{}".format(n): counts.get(name, 0)
                      for n, counts in surface["ljspeech"][
                          "launches"].items()},
                   "split_serve": surface["split"]["launches"][name],
                   "tp_one_process": tp["one_process"]["launches"].get(
                       name, 0),
                   **{"tp_{}_rank{}".format(w, r): counts.get(name, 0)
                      for w, res in tp_runs.items()
                      for r, counts in enumerate(res["launches_by_rank"])},
                   **{"tp_{}_eval_rank{}".format(w, r): counts.get(name, 0)
                      for w, res in tp_runs.items()
                      for r, counts in enumerate(
                          res["eval_launches_by_rank"])}}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: first[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "shape")},
                 "card": card, "second_batch": second}
        if name == "bilstm_proj":
            entry["train_shapes"] = tres[name]
            entry["ragged_shapes"] = {k: v for k, v in kres[name].items()
                                      if isinstance(k, str)}
            entry["also_replaces"] = "idiaptts_tpu/ops/pallas_lstm.py:742"
        if name == "bilstm_recurrence_train":
            entry["also_replaces"] = "idiaptts_tpu/ops/pallas_lstm.py:742"
        if name == "wavenet_sampler":
            entry["one_second_of_audio"] = wtime
            entry["wide_cond"] = {k: v for k, v in wres.items()
                                  if isinstance(k, str)}
            entry["vocode_path"] = vstats
        if name == "mlpg_oneshot":
            entry["evaluate_path"] = estats
            entry["extraction"] = extraction["summary"]
        if name == "banded_solve":
            entry["text_path"] = {
                "run_DM_AM": {m: {k: tfd["text"][m][k] for k in (
                    "wall_s", "front_half_s", "synth_s", "native_matches")}
                    for m in ("fused", "modular")},
                "serve": {k: tfd["served"][k] for k in (
                    "latency_s", "stats", "cpu_frame_db")}}
        if name == "bilstm_bwd":
            entry["pins"] = {"duration": tfd["dur_pin"],
                             "acoustic": tfd["acoustic_pin"]["scores"],
                             "audible": tfd["acoustic_pin"]["audible"]}
        if name == "bilstm_recurrence":
            entry["narrow"] = kres[name]["narrow"]
        if name == "wavenet_sampler":
            entry["wavenet_training"] = {k: remaining["wavenet"][k] for k in (
                "train_loss", "val_loss", "step", "gen", "cpu_rel")}
        if name == "bilstm_bwd":
            entry["remaining_models"] = {
                "atoms": {k: {f: v[f] for f in ("train_loss", "scores",
                                               "step_ms", "cpu_rel")
                              + (("iir_ms",) if "iir_ms" in v else ())}
                          for k, v in remaining["atoms"].items()},
                "vtln": {k: remaining["vtln"][k] for k in (
                    "train_loss", "scores", "sweep", "step_ms", "cpu_rel")},
                "pins": remaining["pins"],
                "enc_dec": {k: v for k, v in remaining["enc_dec"].items()},
                "phase13_s": remaining["seconds"]}
        if name == "banded_solve":
            entry["lanewise"] = first["lanewise"]
            entry["long_bucket"] = kres[name]["T={},B={}".format(
                *SOLVE_LONG)]
        if name in ("bilstm_recurrence_train", "bilstm_bwd"):
            entry["third_batch"] = tres[name][KERNEL_TRAIN_BATCHES[2]]
            entry["narrow"] = tres[name]["narrow"]
        if name in tp["onedir"]:
            entry["narrow"] = tp["onedir"][name]["narrow"]
        if name == "bilstm_bwd_onedir":
            entry["tensor_parallel"] = tp
        if name == "wavenet_gate_fwd":
            entry["wavenet_train_step"] = {
                k: v for k, v in wtrain["step"].items() if k != "launches"}
        if name == "bilstm_bwd":
            entry["narrow_training"] = {k: narrow[k] for k in (
                "model", "B", "T", "losses", "step_ms", "frames_per_s")}
            entry["data_parallel"] = dp
        if name == "banded_solve":
            entry["port_surface"] = {k: surface[k] for k in (
                "split", "enhance", "intonation", "seconds")}
            entry["ljspeech_demo"] = surface["ljspeech"]
        for k in ("layer_max_abs_err", "layer_ms", "layer_plain_ms",
                  "us_per_step"):
            if k in first:
                entry[k] = first[k]
        kernels.append(entry)
    if FAILURES:
        log("== {} check(s) failed:".format(len(FAILURES)))
        for message in FAILURES:
            log("  ", message)
        return 1
    print(json.dumps({"kernels": kernels}, default=float))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
