"""Single-channel speech enhancement: the port of
``idiaptts_tpu/ops/enhancement.py``.

Spectral subtraction with minimum-statistics noise tracking, a
decision-directed a-priori SNR and late-reverberation suppression (a
Lebart exponential-decay model from T60), in float64 tensors on the
caller's device (the card unless ``device="cpu"``).

The STFT, the overlap-add, the sliding minimum of the noise tracker and
the late-reverberation shift run as whole tensors.  The two recurrences,
the periodogram smoothing and the decision-directed gain, stay step
loops over frames with the numpy version's operations in its order, so
they repeat its float64 sums.
"""

import numpy as np
import torch

from idiaptts_torch.ops.dispatch import resolve_device

_FRAME_S = 0.032
_ALPHA_DD = 0.98
_ALPHA_SMOOTH = 0.85      # periodogram smoothing for the min tracker
_MS_BUFFER_S = 3.0        # minimum-statistics window
_MS_BIAS = 1.5            # minimum bias compensation
_MIN_GAIN_DB = -10.0
_LATE_THRESHOLD_S = 0.08  # late-reverberation onset


def _stft(x, n_fft, hop):
    """x (N,) float64 -> (complex spectrum (frames, n_fft/2+1), window)
    over zero-padded frames of a square-root Hann window."""
    win = torch.as_tensor(np.sqrt(np.hanning(n_fft + 1)[:n_fft]),
                          device=x.device)
    n_frames = 1 + max(0, -(-(len(x) - n_fft) // hop))
    pad = (n_frames - 1) * hop + n_fft
    xp = torch.cat([x, x.new_zeros(max(0, pad - len(x)))])
    frames = xp.unfold(0, n_fft, hop) * win
    return torch.fft.rfft(frames, dim=1), win


def _overlap_add(frames, hop):
    """(frames, n_fft) -> ((frames - 1) * hop + n_fft,) sum of the
    frames placed ``hop`` apart."""
    n_frames, n_fft = frames.shape
    length = (n_frames - 1) * hop + n_fft
    return torch.nn.functional.fold(
        frames.T[None], (1, length), (1, n_fft), stride=(1, hop))[0, 0, 0]


def _istft(spec, win, hop, length):
    frames = torch.fft.irfft(spec, dim=1) * win
    out = _overlap_add(frames, hop)
    norm = _overlap_add((win * win).expand(spec.shape[0], -1), hop)
    return (out / torch.clamp(norm, min=1e-8))[:length]


def _minimum_statistics(periodogram, buffer_frames):
    """Noise PSD: the minimum over the last ``buffer_frames`` frames of
    the recursively smoothed periodogram, times the bias factor."""
    smoothed = torch.empty_like(periodogram)
    acc = periodogram[0]
    for t in range(periodogram.shape[0]):
        acc = _ALPHA_SMOOTH * acc + (1 - _ALPHA_SMOOTH) * periodogram[t]
        smoothed[t] = acc
    # Window minima over a +inf-padded front: frame t sees frames
    # max(0, t - buffer_frames + 1) .. t.
    padded = torch.cat([smoothed.new_full(
        (buffer_frames - 1, smoothed.shape[1]), float("inf")), smoothed])
    noise = padded.unfold(0, buffer_frames, 1).amin(dim=-1)
    return noise * _MS_BIAS


def _enhance(noisy, fs, t60=None, minimum_gain_db=_MIN_GAIN_DB,
             dereverb=True):
    """``enhance`` on a float64 tensor; returns the float64 result on the
    tensor's device."""
    n_fft = int(2 ** np.round(np.log2(fs * _FRAME_S)))
    hop = n_fft // 2
    Y, win = _stft(noisy, n_fft, hop)
    P = torch.abs(Y) ** 2
    buffer_frames = max(4, int(_MS_BUFFER_S * fs / hop))
    interference = _minimum_statistics(P, buffer_frames)

    # Late-reverberation PSD: exp(-2 delta T_l) P(t - T_l), with
    # delta = 3 ln(10) / T60.
    if dereverb and t60 and t60 > 0:
        delay = max(1, int(round(_LATE_THRESHOLD_S * fs / hop)))
        decay = np.exp(-2.0 * (3.0 * np.log(10.0) / t60)
                       * _LATE_THRESHOLD_S)
        late = torch.zeros_like(P)
        late[delay:] = decay * P[:-delay]
        interference = interference + late

    # Decision-directed a-priori SNR and a Wiener gain with a floor.
    g_min = 10.0 ** (minimum_gain_db / 20.0)
    sigma = torch.clamp(interference, min=1e-12)
    ml_term = (1 - _ALPHA_DD) * torch.clamp(P / sigma - 1.0, min=0.0)
    gain = torch.empty_like(P)
    prev_s2 = P[0]
    for t in range(P.shape[0]):
        xi = _ALPHA_DD * prev_s2 / sigma[t] + ml_term[t]
        g = torch.clamp(xi / (1.0 + xi), min=g_min)
        gain[t] = g
        prev_s2 = (g * g) * P[t]
    return _istft(Y * gain, win, hop, len(noisy))


def enhance(noisy, fs, t60=None, minimum_gain_db=_MIN_GAIN_DB,
            dereverb=True, device="cuda"):
    """Denoise (and, with ``t60``, dereverberate) a waveform.

    Args:
      noisy: float waveform in [-1, 1] (array or tensor).
      fs: sample rate.
      t60: reverberation time in seconds for the late-reverberation
        model; ``None`` turns dereverberation off.
      device: where it runs; the card by default, raising without CUDA
        unless ``device="cpu"``.
    Returns the enhanced waveform as a float32 numpy array of the same
    length.
    """
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(noisy, np.float64), device=device) \
        if not torch.is_tensor(noisy) \
        else noisy.to(device=device, dtype=torch.float64)
    with torch.no_grad():
        out = _enhance(x, fs, t60, minimum_gain_db, dereverb)
    return out.cpu().numpy().astype(np.float32)
