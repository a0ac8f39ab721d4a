"""WORLD-style waveform synthesis: phase-coherent harmonics plus shaped
noise, the port of ``idiaptts_tpu/ops/world/synthesis.py``.

Two harmonic paths: from coded features (``_harmonic_part_mcep``, the
serving path: the mel log envelope ``sum_m c_m cos(m * beta(w))``
evaluated at the harmonic frequencies with the Chebyshev recurrence)
and from amplitude spectra (``_harmonic_part``, behind
:func:`world_synthesis`: the log envelope and log aperiodicity sampled
at the harmonic frequencies through their real cepstra,
``_sample_log_field``).  Both feed the degree-9 minimax sine bank on
phase in cycles.

Every function takes optional leading batch dims: the batch axis is
written out instead of vmapped.  The noise draw is an input: a
``torch.Generator`` or an explicit complex draw ``z``.
"""

import numpy as np
import torch

from idiaptts_torch.ops.dispatch import resolve_device
from idiaptts_torch.ops.interpolation import interpolate_lin
from idiaptts_torch.ops.world.d4c import _AP_FLOOR

# Degree-9 odd minimax polynomial for sin(pi*t) on [-1, 1] (max error
# 5.9e-6 = -104 dB).
_SIN_C1 = 3.1415284229461573
_SIN_C3 = -5.166408786411196
_SIN_C5 = 2.5427382100290914
_SIN_C7 = -0.5818930905684506
_SIN_C9 = 0.06404115475945735


def _sin_cycles(x):
    """sin(2*pi*x) for x in [0, 1) via sin(pi*t), t = 2x-1:
    sin(2*pi*x) = -sin(pi*t)."""
    t = 2.0 * x - 1.0
    t2 = t * t
    p = _SIN_C9 * t2 + _SIN_C7
    p = p * t2 + _SIN_C5
    p = p * t2 + _SIN_C3
    p = p * t2 + _SIN_C1
    return -(t * p)


def _upsample(x, hop):
    """(..., T, C) frame values -> (..., T*hop, C) by linear
    interpolation towards the next frame (the last frame holds)."""
    T = x.shape[-2]
    w = torch.arange(hop, dtype=x.dtype, device=x.device) / hop
    x_next = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    out = (x[..., :, None, :] * (1 - w)[:, None]
           + x_next[..., :, None, :] * w[:, None])
    return out.reshape(x.shape[:-2] + (T * hop, x.shape[-1]))


def _harmonic_bank(f0_safe, amp, fs, hop):
    """Additive synthesis: per-sample phase accumulation + the minimax
    sine bank.  f0_safe (..., T) Hz; amp (..., T, H) per-frame harmonic
    amplitudes.  Returns (..., T*hop)."""
    f0_safe = torch.clamp(f0_safe, 0.0, fs / 2.0)
    T, H = amp.shape[-2], amp.shape[-1]
    N = T * hop
    h = torch.arange(1, H + 1, dtype=torch.float32, device=amp.device)
    f0_s = _upsample(f0_safe[..., None], hop)[..., 0]           # (..., N)
    # Phase in cycles with per-frame wrapping: the frame-start offsets
    # are frac(exclusive cumsum of per-frame cycles), accumulated in
    # float64 (the reference wraps a float32 carry each frame with a
    # scan; both keep the offset's error far below 1e-6 cycles over a
    # minute of audio, where a flat float32 cumsum would not).
    inc = (f0_s / fs).reshape(f0_s.shape[:-1] + (T, hop))
    frame_sum = torch.sum(inc, dim=-1).to(torch.float64)
    frame_offset = torch.remainder(
        torch.cumsum(frame_sum, dim=-1) - frame_sum, 1.0).to(torch.float32)
    inner = torch.cumsum(inc, dim=-1)
    cycles = torch.remainder(frame_offset[..., None] + inner, 1.0)
    cycles = cycles.reshape(f0_s.shape)                          # (..., N)
    arg = torch.remainder(cycles[..., None] * h, 1.0)            # (..., N, H)
    return torch.sum(_upsample(amp, hop) * _sin_cycles(arg), dim=-1)


def _sample_log_field(log_field, x, num_ceps=64):
    """A smooth log-spectral field (..., T, K) over bins [0, fs/2]
    evaluated at frequencies x (..., T, H) in cycles/sample in [0, 0.5]:
    ``c0 + 2 sum_m c_m cos(2 pi m x)`` from the field's real cepstrum,
    with the Chebyshev recurrence (one cos, the rest multiply-adds),
    accumulated in the JAX package's order."""
    K = log_field.shape[-1]
    ceps = torch.fft.irfft(log_field, n=2 * (K - 1), dim=-1)[
        ..., :num_ceps]
    cos1 = torch.cos((2.0 * np.pi) * x)
    acc = ceps[..., 0:1] + 2.0 * ceps[..., 1:2] * cos1
    c_prev, c_cur = torch.ones_like(cos1), cos1
    for m in range(2, num_ceps):
        c_prev, c_cur = c_cur, 2.0 * cos1 * c_cur - c_prev
        acc = acc + 2.0 * ceps[..., m:m + 1] * c_cur
    return acc


def _harmonic_part(f0, f0_cont, sp_power, ap, fs, hop, max_harmonics):
    """Additive harmonic synthesis from amplitude spectra.  f0 (..., T)
    with unvoiced zeros, f0_cont (..., T) gap-filled pitch for the phase,
    sp_power and ap (..., T, K) -> (..., T * hop)."""
    num_bins = sp_power.shape[-1]
    bin_hz = fs / (2 * (num_bins - 1))
    voiced = f0 > 0
    f0_safe = f0_cont
    h = torch.arange(1, max_harmonics + 1, dtype=torch.float32,
                     device=sp_power.device)
    harm_freq = f0_safe[..., None] * h
    below_nyq = harm_freq < (fs / 2.0 - bin_hz)
    x = torch.clamp(harm_freq / fs, 0.0, 0.5)
    log_env = 0.5 * torch.log(torch.clamp(sp_power, min=1e-30))
    log_ap = torch.log(torch.clamp(ap, min=1e-9))
    # Clip before exp: divergent inputs must not overflow to inf (the
    # masks below would turn it into NaN).
    env_p = torch.exp(2.0 * torch.clamp(_sample_log_field(log_env, x),
                                        -60.0, 25.0))
    ap_h = torch.exp(torch.clamp(_sample_log_field(log_ap, x), -60.0, 0.0))
    periodic_frac = torch.sqrt(torch.clamp(1.0 - ap_h ** 2, 0.0, 1.0))
    amp = 2.0 * torch.sqrt(env_p * f0_safe[..., None] / fs)
    amp = amp * periodic_frac * below_nyq * voiced[..., None]
    return _harmonic_bank(f0_safe, amp, fs, hop)


def _ap_at_freqs(bap, freqs, fs):
    """Aperiodicity ratio at arbitrary frequencies (..., T, H): the same
    piecewise-linear-in-log band model as ``decode_aperiodicity``
    without the bin grid.  bap (..., T, NB) coded log ratios; freqs Hz."""
    num_bands = bap.shape[-1]
    log_floor = float(np.log(_AP_FLOOR))
    log_ratio = torch.clamp(bap, log_floor, 0.0)
    anchors_f = np.concatenate([
        [0.0], 3000.0 * (np.arange(num_bands) + 1.0), [fs / 2.0]])
    anchors_v = torch.cat(
        [torch.full(bap.shape[:-1] + (1,), log_floor, dtype=bap.dtype,
                    device=bap.device),
         log_ratio, log_ratio[..., -1:]], dim=-1)                # (..., NB+2)
    ap_log = anchors_v[..., -1:].expand(freqs.shape)
    # Static segment sweep (<= 6 segments): later matches overwrite.
    for s in range(len(anchors_f) - 1, 0, -1):
        f_lo, f_hi = anchors_f[s - 1], anchors_f[s]
        w = (freqs - f_lo) / max(f_hi - f_lo, 1e-9)
        seg = (anchors_v[..., s - 1:s] * (1.0 - w)
               + anchors_v[..., s:s + 1] * w)
        ap_log = torch.where(freqs < f_hi, seg, ap_log)
    return torch.clamp(torch.exp(ap_log), _AP_FLOOR, 1.0)


def _harmonic_part_mcep(f0, f0_cont, coded, bap, fs, hop, alpha,
                        max_harmonics):
    """Harmonic synthesis straight from coded features: the mel-cepstral
    log envelope ``sum_m c_m cos(m * beta(w))`` evaluated at the harmonic
    frequencies with the Chebyshev recurrence.

    f0 (..., T) with unvoiced zeros; f0_cont (..., T) gap-filled pitch
    for the phase; coded (..., T, order+1); bap (..., T, NB).  Returns
    (..., T*hop)."""
    voiced = f0 > 0
    f0_safe = f0_cont
    h = torch.arange(1, max_harmonics + 1, dtype=torch.float32,
                     device=coded.device)
    harm_freq = f0_safe[..., None] * h                           # (..., T, H)
    below_nyq = harm_freq < (fs / 2.0 * (1.0 - 2.0 / 1024.0))
    omega = (2.0 * np.pi) * torch.clamp(harm_freq / fs, 0.0, 0.5)
    beta = omega + 2.0 * torch.atan2(alpha * torch.sin(omega),
                                     1.0 - alpha * torch.cos(omega))
    cos1 = torch.cos(beta)
    c_prev = torch.ones_like(cos1)
    c_cur = cos1
    log_amp = coded[..., 0:1] + coded[..., 1:2] * cos1
    for m in range(2, coded.shape[-1]):
        c_prev, c_cur = c_cur, 2.0 * cos1 * c_cur - c_prev
        log_amp = log_amp + coded[..., m:m + 1] * c_cur
    env_p = torch.exp(2.0 * torch.clamp(log_amp, -60.0, 25.0))
    ap_h = _ap_at_freqs(bap, harm_freq, fs)
    periodic_frac = torch.sqrt(torch.clamp(1.0 - ap_h ** 2, 0.0, 1.0))
    amp = 2.0 * torch.sqrt(env_p * f0_safe[..., None] / fs)
    amp = amp * periodic_frac * below_nyq * voiced[..., None]
    return _harmonic_bank(f0_safe, amp, fs, hop)


def noise_draw(num_frames, num_bins, generator, device):
    """The complex-Gaussian frame spectra ``_noise_part`` shapes:
    (num_frames, num_bins) complex64, real and imaginary parts N(0, 1),
    drawn from ``generator`` (a ``torch.Generator`` on ``device``)."""
    parts = torch.randn(2, num_frames, num_bins, generator=generator,
                        device=device, dtype=torch.float32)
    return torch.complex(parts[0], parts[1])


def _overlap_add(x, k, hop):
    """(..., rows, k*hop) frames hop-aligned -> (..., rows*hop)."""
    rows = x.shape[-2]
    chunks = x.reshape(x.shape[:-2] + (rows, k, hop))
    acc = x.new_zeros(x.shape[:-2] + (rows + k, hop))
    for j in range(k):
        acc[..., j:j + rows, :] += chunks[..., :, j, :]
    return acc.reshape(x.shape[:-2] + ((rows + k) * hop,))[
        ..., :rows * hop]


def _noise_part(f0, sp_power, ap, fs, hop, generator=None, z=None):
    """Shaped-noise synthesis in the frequency domain: each frame's
    spectrum is iid complex Gaussian noise scaled by the target
    amplitude ``sqrt(sp_power) * ap``; the windowed irffts are
    overlap-added on a hop-aligned layout and renormalised by the
    window's overlap energy.

    sp_power, ap: (..., T, num_bins).  The draw ``z`` (T, num_bins)
    complex, shared by every leading index, comes from
    :func:`noise_draw` with ``generator`` unless given (tests pass the
    JAX package's own draw).  Returns (..., T*hop)."""
    T, num_bins = sp_power.shape[-2], sp_power.shape[-1]
    n_fft = 2 * (num_bins - 1)
    if n_fft < hop:
        raise ValueError(
            "noise grid too small: n_fft {} < hop {} (increase "
            "num_bins so 2*(num_bins-1) >= hop)".format(n_fft, hop))
    k = max(1, min(4, n_fft // hop))
    win = k * hop
    w_np = np.asarray(0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(win) / win), np.float32)
    wsum2 = float((w_np ** 2).sum())
    scale = float(np.sqrt(n_fft * win / (2.0 * wsum2)))
    device = sp_power.device
    if z is None:
        if generator is None:
            raise ValueError("_noise_part needs a generator or a draw z")
        z = noise_draw(T, num_bins, generator, device)
    z = torch.as_tensor(z, device=device).to(torch.complex64)
    target = torch.sqrt(torch.clamp(sp_power, min=0.0)) * ap
    w = torch.as_tensor(w_np, device=device)
    frames = torch.fft.irfft(z * (target * (scale / np.sqrt(2.0))),
                             n=n_fft, dim=-1)[..., :win] * w
    raw = _overlap_add(frames, k, hop)
    norm = _overlap_add((w ** 2).expand(T, win), k, hop)
    return raw * torch.rsqrt(torch.clamp(norm, min=1e-12))


def _as_float32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def world_synthesis(f0, sp_power, ap, fs, frame_shift_ms=5.0, seed=0,
                    z=None, device="cuda"):
    """Waveform (T * hop,) float32 tensor on ``device`` from WORLD
    features: f0 (T,) Hz with 0 = unvoiced, sp_power (T, num_bins) power
    envelope (the CheapTrick convention), ap (T, num_bins) aperiodicity
    ratio in [0, 1].  The noise is drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``, unless ``z`` (complex (T,
    num_bins)) gives it."""
    device = resolve_device(device)
    hop = int(fs * frame_shift_ms / 1000.0)
    f0 = np.asarray(f0, np.float32).reshape(-1)
    f0_cont = interpolate_lin(f0)[0][:, 0]
    f0_cont = np.where(f0_cont > 0, f0_cont, 150.0)  # all-unvoiced guard
    f0_t = torch.from_numpy(f0).to(device)
    f0_cont = torch.from_numpy(f0_cont.astype(np.float32)).to(device)
    sp_power = _as_float32(sp_power, device)
    ap = _as_float32(ap, device)
    max_harmonics = int(fs / 2.0 / 55.0)
    generator = None
    if z is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    with torch.inference_mode():
        harm = _harmonic_part(f0_t, f0_cont, sp_power, ap, int(fs), hop,
                              max_harmonics)
        noise = _noise_part(f0_t, sp_power, ap, int(fs), hop,
                            generator=generator, z=z)
        return harm + noise
