"""STFT, mel filterbank and Griffin-Lim: the port of
``idiaptts_tpu/ops/stft.py``, float32 on the tensors' device.

librosa's conventions, as the JAX package keeps them: a periodic Hann
window, centred frames with reflect padding framed by a gather, an
inverse that divides by the squared-window overlap-add, and Slaney mel
filters (built in numpy float64 on the host).  Griffin-Lim takes its
initial phases as an input: ``angles`` or a ``torch.Generator``.
"""

import numpy as np
import torch

from idiaptts_torch.ops.dispatch import resolve_device


def hann_window(win_length, dtype=torch.float32, device="cpu"):
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_length)


def _window(n_fft, win_length, device):
    """The Hann window of ``win_length`` centred in ``n_fft``."""
    window = hann_window(win_length, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(
            window, (lpad, n_fft - win_length - lpad))
    return window


def _reflect(index, n):
    """numpy's "reflect" padding of a length-n signal as indices into
    it, for any pad length."""
    if n == 1:
        return torch.zeros_like(index)
    period = 2 * (n - 1)
    m = torch.remainder(index, period)
    return torch.where(m < n, m, period - m)


def frame_signal(raw, frame_length, hop_length, center=True):
    """(N,) -> (num_frames, frame_length) by a gather; ``center`` pads
    frame_length // 2 samples at both ends by reflection."""
    pad = frame_length // 2 if center else 0
    num_frames = 1 + (raw.shape[0] + 2 * pad - frame_length) // hop_length
    idx = (torch.arange(num_frames, device=raw.device)[:, None] * hop_length
           + torch.arange(frame_length, device=raw.device)[None, :] - pad)
    if center:
        idx = _reflect(idx, raw.shape[0])
    return raw[idx]


def stft(raw, n_fft=1024, hop_length=256, win_length=None, center=True):
    """Complex (num_frames, n_fft // 2 + 1) STFT of a (N,) tensor."""
    if win_length is None:
        win_length = n_fft
    frames = frame_signal(raw, n_fft, hop_length, center)
    window = _window(n_fft, win_length, raw.device)
    return torch.fft.rfft(frames * window[None, :], n=n_fft, dim=-1)


def amp_spectrum(raw, n_fft=1024, hop_length=256, win_length=None,
                 center=True):
    return torch.abs(stft(raw, n_fft, hop_length, win_length, center))


def _overlap_add(x, num_frames, k, hop_length):
    """(num_frames, k * hop) hop-aligned frames -> ((num_frames + k) *
    hop,) summed, one shifted layout a chunk."""
    chunks = x.reshape(num_frames, k, hop_length)
    acc = x.new_zeros((num_frames + k, hop_length))
    for j in range(k):
        acc[j:j + num_frames] += chunks[:, j]
    return acc.reshape(-1)


def istft(spec, n_fft=1024, hop_length=256, win_length=None, length=None):
    """Inverse STFT of (num_frames, n_fft // 2 + 1) with the
    squared-window overlap-add normalisation; the centre padding is
    trimmed from both ends."""
    if win_length is None:
        win_length = n_fft
    window = _window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window[None, :]
    num_frames = frames.shape[0]
    total = n_fft + hop_length * (num_frames - 1)
    # Only the window's support contributes.
    wstart = (n_fft - win_length) // 2 if win_length < n_fft else 0
    eff = frames[:, wstart:wstart + win_length]
    wsq = (window[wstart:wstart + win_length] ** 2)[None, :].expand(
        eff.shape)
    if win_length % hop_length == 0:
        k = win_length // hop_length

        def overlap_add(x):
            flat = _overlap_add(x, num_frames, k, hop_length)[
                :total - wstart]
            return torch.nn.functional.pad(flat, (wstart, 0))[:total]

        raw = overlap_add(eff)
        norm = overlap_add(wsq.contiguous())
    else:
        offsets = (torch.arange(num_frames, device=spec.device) * hop_length
                   + wstart)
        idx = (offsets[:, None] + torch.arange(
            win_length, device=spec.device)[None, :]).reshape(-1)
        raw = eff.new_zeros(total).index_add_(0, idx, eff.reshape(-1))
        norm = eff.new_zeros(total).index_add_(0, idx, wsq.reshape(-1))
    raw = raw / torch.clamp(norm, min=1e-8)
    pad = n_fft // 2
    raw = raw[pad:total - pad]
    if length is not None:
        raw = torch.nn.functional.pad(
            raw, (0, max(0, length - raw.shape[0])))[:length]
    return raw


def hz_to_mel(freq):
    """Slaney mel scale (librosa's default)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(freq, 1e-10)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep,
                    mel)


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), freq)


def mel_filterbank(fs, n_fft, n_mels=80, fmin=0.0, fmax=None, norm="slaney"):
    """(n_mels, n_fft//2+1) float32 triangular filterbank (numpy),
    librosa-compatible."""
    if fmax is None:
        fmax = fs / 2.0
    fft_freqs = np.linspace(0, fs / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def griffin_lim(amp_spec, n_fft=1024, hop_length=256, win_length=None,
                num_iters=50, length=None, generator=None, angles=None,
                momentum=0.99):
    """Phase reconstruction of a (num_frames, n_fft//2+1) magnitude
    tensor by momentum-accelerated STFT projections (librosa's
    ``griffinlim`` with its default momentum 0.99).  The initial phases
    are ``angles`` or uniform in [-pi, pi) drawn from ``generator`` (a
    ``torch.Generator`` on the tensor's device)."""
    if angles is None:
        if generator is None:
            raise ValueError("griffin_lim needs a generator or angles")
        angles = torch.rand(amp_spec.shape, generator=generator,
                            device=amp_spec.device) * (2.0 * np.pi) - np.pi
    if not isinstance(angles, torch.Tensor):
        angles = torch.from_numpy(np.array(angles, dtype=np.float32))
    angles = angles.to(device=amp_spec.device, dtype=torch.float32)
    spec = amp_spec * torch.polar(torch.ones_like(angles), angles)
    prev = torch.zeros_like(spec)
    for _ in range(num_iters):
        re = stft(istft(spec, n_fft, hop_length, win_length, length),
                  n_fft, hop_length, win_length)[:amp_spec.shape[0]]
        accel = re - (momentum / (1.0 + momentum)) * prev if momentum \
            else re
        spec = amp_spec * (accel / torch.clamp(torch.abs(accel), min=1e-8))
        prev = re
    return istft(spec, n_fft, hop_length, win_length, length)


def mel_power_to_power_sp(mel_power, fs, n_fft, num_iters=30):
    """Non-negative power spectrum (..., n_fft//2+1) whose mel projection
    ``p @ W^T`` is ``mel_power``: a least-squares start clipped to
    positive, then multiplicative NNLS updates ``p <- p * ((m / (p W^T))
    W) / sum(W, 0)``; lossy, like librosa's ``mel_to_stft``."""
    n_mels = mel_power.shape[-1]
    W = torch.as_tensor(mel_filterbank(fs, n_fft, n_mels=n_mels),
                        device=mel_power.device)
    m = torch.clamp(mel_power, min=1e-10)
    p = torch.clamp(m @ torch.linalg.pinv(W).t(), min=1e-10)
    col_sum = torch.clamp(torch.sum(W, dim=0)[None, :], min=1e-10)
    for _ in range(num_iters):
        recon = torch.clamp(p @ W.t(), min=1e-10)
        p = p * ((m / recon) @ W) / col_sum
    return p


def mfbanks_to_amp_sp(coded_sp, fs, n_fft=None, device="cuda"):
    """Log-mel-power features ``log(amp_sp**2 @ fbank.T)`` (numpy or a
    tensor) -> amplitude spectrum tensor on ``device``."""
    device = resolve_device(device)
    if n_fft is None:
        from idiaptts_torch.ops import mcep as mcep_ops
        n_fft = mcep_ops.fs_to_frame_length(fs)
    coded = torch.as_tensor(np.asarray(coded_sp, np.float32), device=device)
    return torch.sqrt(mel_power_to_power_sp(torch.exp(coded), int(fs),
                                            int(n_fft)))


def amp_to_db(amp):
    return 20.0 * torch.log10(torch.clamp(amp, min=1e-10))


def db_to_amp(db):
    return torch.pow(10.0, db / 20.0)
