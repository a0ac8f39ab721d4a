"""Pitch-adaptive spectral envelope (the CheapTrick role): the port of
``idiaptts_tpu/ops/world/cheaptrick.py``, float32 on the tensors' device.

Each frame takes a Hann window of ``3 fs / f0`` samples inside a fixed
``fft_size`` frame, one batched FFT gives the power spectra, the band
below f0 gets its mirror image added (DC correction), a rectangular
smoothing of width ``2 f0 / 3`` is applied as a sinc multiplier on the
power cepstrum, and the quefrency lifter (sinc smoothing and the q1
recovery lifter) runs as an irfft/rfft pair.

:func:`cheaptrick` pads the frame count to a multiple of
``_FRAME_BUCKET`` as the JAX package does.
"""

import numpy as np
import torch

from idiaptts_torch.ops import mcep as mcep_ops
from idiaptts_torch.ops.dispatch import resolve_device

_DEFAULT_F0 = 500.0   # envelope analysis f0 for unvoiced frames
_F0_CEIL = 800.0      # highest trackable f0 (f0.py's ceiling)
_Q1 = -0.15           # spectral recovery lifter coefficient
_FRAME_BUCKET = 256   # frame-count padding


def _sinc_where(arg):
    return torch.where(arg > 1e-6,
                       torch.sin(arg) / torch.clamp(arg, min=1e-6),
                       torch.ones_like(arg))


def _cheaptrick_dev(raw, f0, fs, hop, fft_size):
    """Power envelope (T, fft_size//2+1) of a waveform tensor and an f0
    tensor (T,) on one device."""
    T = f0.shape[0]
    device = f0.device
    num_bins = fft_size // 2 + 1
    f0_eff = torch.where(f0 > 0, f0, torch.full_like(f0, _DEFAULT_F0))
    f0_eff = torch.clamp(f0_eff, min=3.0 * fs / fft_size)

    # Frame t covers samples [t*hop - fft_size/2, t*hop + fft_size/2).
    half_max = fft_size // 2
    offs = torch.arange(fft_size, device=device) - half_max
    rows_per_frame = -(-fft_size // hop) + 1
    padded = torch.nn.functional.pad(
        raw, (half_max, rows_per_frame * hop + hop * T))
    segs = padded.unfold(0, fft_size, hop)[:T]

    half_win = 1.5 * fs / f0_eff
    t_norm = offs[None, :] / half_win[:, None]
    window = torch.where(torch.abs(t_norm) <= 1.0,
                         0.5 + 0.5 * torch.cos(np.pi * t_norm),
                         torch.zeros_like(t_norm))
    window = window / torch.sqrt(
        torch.sum(window ** 2, dim=1, keepdim=True) + 1e-12)
    windowed = segs * window
    # Remove the windowed DC (WORLD subtracts the weighted mean).
    wsum = torch.sum(window, dim=1, keepdim=True)
    windowed = windowed - window * (
        torch.sum(windowed, dim=1, keepdim=True)
        / torch.clamp(wsum, min=1e-9))
    power = torch.abs(torch.fft.rfft(windowed, n=fft_size, dim=-1)) ** 2

    # DC correction: mirror the band below f0 into it, over every bin
    # below the highest trackable f0.
    bin_hz = fs / fft_size
    k_mirror = min(int(np.ceil(_F0_CEIL * fft_size / fs)) + 2, num_bins)
    freqs_m = torch.arange(k_mirror, device=device) * bin_hz
    mirror_bin = (2.0 * f0_eff[:, None] - freqs_m[None, :]) / bin_hz
    mirror_bin = torch.clamp(mirror_bin, 0, num_bins - 1)
    lo = torch.floor(mirror_bin).to(torch.int64)
    hi = torch.clamp(lo + 1, max=num_bins - 1)
    frac = mirror_bin - lo
    mirrored = (torch.gather(power, 1, lo) * (1 - frac)
                + torch.gather(power, 1, hi) * frac)
    below = freqs_m[None, :] < f0_eff[:, None]
    power = torch.cat([
        power[:, :k_mirror] + torch.where(below, mirrored,
                                          torch.zeros_like(mirrored)),
        power[:, k_mirror:]], dim=1)

    # Rectangular smoothing of width 2 f0 / 3: a sinc multiplier on the
    # power "cepstrum" of the even extension.
    width_bins = (2.0 * f0_eff / 3.0) / bin_hz
    pq = torch.fft.rfft(
        torch.cat([power, torch.flip(power[:, 1:-1], dims=[1])], dim=1),
        dim=1)
    m = torch.arange(num_bins, device=device)
    rect_mult = _sinc_where(np.pi * width_bins[:, None] * m[None, :]
                            / fft_size)
    smoothed = torch.fft.irfft(pq * rect_mult, n=fft_size,
                               dim=1)[:, :num_bins]
    smoothed = torch.clamp(smoothed, min=0.0)

    # Quefrency liftering with spectral recovery, over a relative floor
    # of -90 dB a frame (deep notches would make the lifter ring).
    frame_max = torch.max(smoothed, dim=1, keepdim=True).values
    floor = torch.clamp(frame_max * 1e-9, min=1e-30)
    log_p = torch.log(torch.maximum(smoothed, floor))
    cep = torch.fft.irfft(log_p, n=fft_size, dim=-1)
    q_idx = torch.arange(fft_size, device=device)
    q = torch.minimum(q_idx, fft_size - q_idx) / fs
    arg = np.pi * f0_eff[:, None] * q[None, :]
    comp = (1.0 - 2.0 * _Q1) + 2.0 * _Q1 * torch.cos(2.0 * arg)
    cep = cep * _sinc_where(arg) * comp
    log_env = torch.fft.rfft(cep, n=fft_size, dim=-1).real
    log_env = torch.maximum(log_env, torch.log(floor))
    return torch.exp(log_env)


def _bucket_frames(raw, f0, hop):
    """(raw, f0) zero-padded to a frame-count bucket, numpy float32, and
    the true frame count."""
    T = len(f0)
    T_pad = int(np.ceil(max(T, 1) / _FRAME_BUCKET) * _FRAME_BUCKET)
    f0_p = np.zeros(T_pad, dtype=np.float32)
    f0_p[:T] = np.asarray(f0, dtype=np.float32).reshape(-1)
    raw = np.asarray(raw, dtype=np.float32)
    raw_p = np.zeros(max(T_pad * hop, len(raw)), dtype=np.float32)
    raw_p[:len(raw)] = raw
    return raw_p, f0_p, T


def cheaptrick(raw, f0, fs, frame_shift_ms=5.0, fft_size=None,
               device="cuda"):
    """Power spectral envelope (T, fft_size//2+1) of a waveform and its
    f0 track (numpy), a float32 tensor on ``device``."""
    device = resolve_device(device)
    if fft_size is None:
        fft_size = mcep_ops.fs_to_frame_length(fs)
    hop = int(fs * frame_shift_ms / 1000.0)
    raw_p, f0_p, T = _bucket_frames(raw, f0, hop)
    with torch.inference_mode():
        out = _cheaptrick_dev(torch.from_numpy(raw_p).to(device),
                              torch.from_numpy(f0_p).to(device), int(fs),
                              hop, int(fft_size))
    return out[:T]
