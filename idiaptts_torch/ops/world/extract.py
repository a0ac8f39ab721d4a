"""WORLD analysis of one waveform on the device: F0, envelope,
aperiodicity and mel-cepstral coding in one pass, the port of
``idiaptts_tpu/ops/world/extract.py``.

Only the coded features (T x (num_sps + 2)) come back to the host.
:func:`world_analysis_async` enqueues the device work and a
non-blocking copy into pinned host memory and returns at once;
:func:`world_analysis_result` waits for the copy and runs the host's
four-interval voicing refinement, so a corpus loop can refine utterance
i while the card analyses utterance i+1.
"""

import importlib

import numpy as np
import torch

from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops.dispatch import resolve_device

# The package re-exports same-named functions; import the submodules.
ct = importlib.import_module("idiaptts_torch.ops.world.cheaptrick")
d4c_mod = importlib.import_module("idiaptts_torch.ops.world.d4c")
f0_mod = importlib.import_module("idiaptts_torch.ops.world.f0")


def _analysis_dev(raw, fs, hop, window, fft_size, num_bands, order, alpha):
    """(f0, coded_sp, bap) of a padded waveform tensor, on its device."""
    f0 = f0_mod._extract_f0_dev(raw, fs, hop, 71.0, 800.0, window)
    sp_power = ct._cheaptrick_dev(raw, f0, fs, hop, fft_size)
    bap = d4c_mod.code_aperiodicity(
        d4c_mod._d4c_dev(raw, f0, fs, hop, num_bands))
    coded_sp = mcep_ops.amp_sp_to_mcep(torch.sqrt(sp_power), order, alpha)
    return f0, coded_sp, bap


def world_analysis(raw, fs, num_coded_sps=60, frame_shift_ms=5.0,
                   fft_size=None, mgc_alpha=None, device="cuda"):
    """Waveform (numpy) -> (f0, coded_sp, bap) numpy, analysed on
    ``device`` and trimmed to the true frame count.  ``mgc_alpha``
    overrides the warping coefficient (e.g. Merlin's 0.58 at 16 kHz)."""
    return world_analysis_result(world_analysis_async(
        raw, fs, num_coded_sps=num_coded_sps,
        frame_shift_ms=frame_shift_ms, fft_size=fft_size,
        mgc_alpha=mgc_alpha, device=device))


def world_analysis_async(raw, fs, num_coded_sps=60, frame_shift_ms=5.0,
                         fft_size=None, mgc_alpha=None, device="cuda"):
    """Enqueue the analysis on ``device`` without waiting for it: returns
    a handle for :func:`world_analysis_result`.  The waveform is padded
    to a multiple of 16384 samples, as the JAX package pads it."""
    device = resolve_device(device)
    if fft_size is None:
        fft_size = mcep_ops.fs_to_frame_length(fs)
    hop = int(fs * frame_shift_ms / 1000.0)
    alpha = mgc_alpha if mgc_alpha is not None \
        else mcep_ops.fs_to_mgc_alpha(fs)
    num_bands = max(1, d4c_mod.get_num_aperiodicities(fs))
    raw = np.asarray(raw, dtype=np.float32)
    num_frames = f0_mod._num_frames(len(raw), hop)
    padded = torch.from_numpy(f0_mod.pad_to_bucket(raw))
    with torch.inference_mode():
        outputs = _analysis_dev(
            padded.to(device, non_blocking=True), int(fs), hop,
            f0_mod.correlation_window(fs), int(fft_size), num_bands,
            num_coded_sps - 1, float(alpha))
        outputs = [o[:num_frames] for o in outputs]
        done = None
        if device.type == "cuda":
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outputs]
            for h, o in zip(host, outputs):
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            outputs = host
    return outputs, done, raw, fs, frame_shift_ms


def world_analysis_result(handle, vuv_refine=True):
    """Wait for a :func:`world_analysis_async` handle -> (f0, coded_sp,
    bap) numpy.  ``vuv_refine`` applies the host's four-interval voicing
    decision to f0, as :func:`~idiaptts_torch.ops.world.f0.extract_f0`
    does; the envelope and aperiodicity keep the device's voicing."""
    outputs, done, raw, fs, frame_shift_ms = handle
    if done is not None:
        done.synchronize()
    f0, coded_sp, bap = (o.numpy() for o in outputs)
    if vuv_refine:
        f0 = f0_mod.refine_vuv(raw, fs, f0, frame_shift_ms)
    return f0, coded_sp, bap
