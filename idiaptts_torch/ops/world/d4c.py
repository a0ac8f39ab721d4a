"""Band aperiodicity (the D4C role) and its coding: the port of
``idiaptts_tpu/ops/world/d4c.py``, float32 on the tensors' device.

The f0 track defines a continuous fundamental phase ``phi``;
demodulating a Nuttall-windowed frame (8 periods) at ``exp(-i k phi /
2)`` measures harmonic power at integer ``k`` and the noise density
between harmonics at half-integer ``k``, and per band

    ap^2 = N_band / (N_band + P_band)

with ``P_band`` the harmonic power above the noise and ``N_band`` the
noise over the band.  By default the ratio is mapped onto D4C's
observable scale (``ln ap_d4c = A ln ap + B``, clipped); ``d4c_scale=
False`` returns the raw ratio.

Two sequential recurrences are kept as the JAX package computes them:
the per-hop phase offset wraps ``mod(offset + s, 2)`` in float32, one
step a frame, and the slot phasors advance by the incremental product
``z <- z * v_half``, one step a slot.
"""

import numpy as np
import torch

from idiaptts_torch.ops.dispatch import resolve_device

_AP_FLOOR = 1e-9
_WINDOW_PERIODS = 8.0   # Nuttall mainlobe halfwidth ~4/T_w < f0/2
_F0_FLOOR = 71.0
_DEFAULT_F0 = 160.0     # phase track through unvoiced stretches
# ln ap_d4c = A * ln ap_ratio + B (the JAX package's fit).
_D4C_SCALE_A = 5.30
_D4C_SCALE_B = 6.84


def get_num_aperiodicities(fs):
    """Number of coded aperiodicity bands: WORLD's 3 kHz bands from
    3 kHz up."""
    return int(min(15000.0, fs / 2.0 - 3000.0) / 3000.0)


def _nuttall(t_norm):
    """Nuttall window on |t_norm| <= 1, zero outside."""
    x = np.pi * (t_norm + 1.0)
    w = (0.355768 - 0.487396 * torch.cos(x) + 0.144232 * torch.cos(2 * x)
         - 0.012604 * torch.cos(3 * x))
    return torch.where(torch.abs(t_norm) <= 1.0, w, torch.zeros_like(w))


def _wrap_offsets(chunk_sum, period):
    """Exclusive running sum of ``chunk_sum`` wrapped mod ``period``
    after every step, in float32, one step at a time (the JAX
    package's ``lax.scan``)."""
    offsets = torch.zeros_like(chunk_sum)
    step = torch.empty((), dtype=chunk_sum.dtype, device=chunk_sum.device)
    for t in range(1, chunk_sum.shape[0]):
        torch.add(offsets[t - 1], chunk_sum[t - 1], out=step)
        torch.remainder(step, period, out=offsets[t])
    return offsets


def _d4c_dev(raw, f0, fs, hop, num_bands, d4c_scale=True):
    """Band aperiodicity ratios (T, num_bands) of a waveform tensor and
    an f0 tensor (T,) on one device."""
    T = f0.shape[0]
    device = f0.device
    f0_eff = torch.where(f0 > 0, torch.clamp(f0, min=_F0_FLOOR),
                         torch.full_like(f0, _DEFAULT_F0))

    # Continuous fundamental phase, wrapped mod 2 cycles (4 pi) each
    # hop: every half-integer slot phasor is 4 pi periodic.
    need = T * hop + hop
    f0_samples = torch.repeat_interleave(f0_eff, hop)
    f0_samples = torch.cat([f0_samples, f0_samples[-1:].expand(hop)])
    inc = (f0_samples / fs).reshape(-1, hop)
    offsets = _wrap_offsets(torch.sum(inc, dim=1), 2.0)
    cycles = torch.remainder(offsets[:, None] + torch.cumsum(inc, dim=1),
                             2.0)
    phi = (2.0 * np.pi) * cycles.reshape(-1)

    W = int(2 ** np.ceil(np.log2(_WINDOW_PERIODS * fs / _F0_FLOOR)))
    half = W // 2
    rows_per_frame = -(-W // hop) + 1
    ext = rows_per_frame * hop

    def frame(sig):
        sp = torch.nn.functional.pad(sig, (half, ext + hop))
        return sp.unfold(0, W, hop)[:T]

    N = raw.shape[0]
    x_f = frame(torch.nn.functional.pad(raw, (0, max(0, need - N)))[:need])
    phi_f = frame(phi)
    phi_f = phi_f - phi_f[:, half:half + 1]

    offs = torch.arange(W, device=device) - half
    half_win = torch.clamp(0.5 * _WINDOW_PERIODS * fs / f0_eff,
                           max=float(half - 1))
    w = _nuttall(offs[None, :] / half_win[:, None])
    w = w / torch.sqrt(torch.sum(w ** 2, dim=1, keepdim=True) + 1e-20)
    wsum2 = torch.sum(w, dim=1) ** 2
    xw = (x_f * w).to(torch.complex64)
    del x_f, w

    # S_k for k = 0.5, 1.0, ... by incremental half-step phasors.
    K_half = int(2 * np.floor((fs / 2.0) / _F0_FLOOR))
    v_half = torch.polar(torch.ones_like(phi_f), -0.5 * phi_f)
    del phi_f
    S = torch.empty((K_half, T), dtype=torch.complex64, device=device)
    z = v_half.clone()
    for k in range(K_half):
        torch.sum(xw * z, dim=1, out=S[k])
        z.mul_(v_half)
    del z, v_half, xw
    P = torch.abs(S.t()) ** 2
    slots = torch.arange(K_half, device=device)
    freqs = ((slots + 1) * 0.5)[None, :] * f0_eff[:, None]
    is_harm = (slots % 2) == 1
    valid = freqs < (fs / 2.0 - 0.5 * f0_eff[:, None])

    edges = [0.0] + [3000.0 * (b + 1) + 1500.0
                     for b in range(num_bands - 1)] + [fs / 2.0 + 1.0]
    zeros = torch.zeros_like(P)
    aps = []
    for b in range(num_bands):
        in_band = (freqs >= edges[b]) & (freqs < edges[b + 1]) & valid
        noise_m = in_band & (~is_harm)[None, :]
        harm_m = in_band & is_harm[None, :]
        n_noise = torch.sum(noise_m, dim=1)
        noise_slot = torch.sum(torch.where(noise_m, P, zeros), dim=1) \
            / torch.clamp(n_noise, min=1)
        p_per = torch.sum(torch.where(
            harm_m, torch.clamp(P - noise_slot[:, None], min=0.0), zeros),
            dim=1) * 2.0 / torch.clamp(wsum2, min=1e-20)
        bw = min(edges[b + 1], fs / 2.0) - edges[b]
        p_noise = noise_slot * 2.0 * bw / fs
        ap2 = p_noise / (p_noise + p_per + 1e-30)
        ap = torch.sqrt(torch.clamp(ap2, _AP_FLOOR ** 2, 1.0))
        # Bands with no usable slots (f0 too high): fully aperiodic.
        usable = (n_noise > 0) & (torch.sum(harm_m, dim=1) > 0)
        aps.append(torch.where(usable, ap, torch.ones_like(ap)))
    ap = torch.stack(aps, dim=1)

    if d4c_scale:
        ap = torch.exp(torch.clamp(
            _D4C_SCALE_A * torch.log(ap) + _D4C_SCALE_B,
            float(np.log(_AP_FLOOR)), 0.0))
    return torch.where((f0 > 0)[:, None], ap, torch.ones_like(ap))


def d4c_band_aperiodicity(raw, f0, fs, frame_shift_ms=5.0, fft_size=None,
                          d4c_scale=True, device="cuda"):
    """Band aperiodicity ratios (T, num_bands) in (0, 1] of a waveform
    and its f0 track (numpy), a float32 tensor on ``device``.
    ``d4c_scale=False`` returns the raw noise-amplitude fraction.
    ``fft_size`` is accepted for the JAX package's signature; the probe
    method uses no FFT grid."""
    from idiaptts_torch.ops.world.cheaptrick import _bucket_frames
    device = resolve_device(device)
    hop = int(fs * frame_shift_ms / 1000.0)
    num_bands = max(1, get_num_aperiodicities(fs))
    raw_p, f0_p, T = _bucket_frames(raw, f0, hop)
    with torch.inference_mode():
        out = _d4c_dev(torch.from_numpy(raw_p).to(device),
                       torch.from_numpy(f0_p).to(device), int(fs), hop,
                       num_bands, d4c_scale=bool(d4c_scale))
    return out[:T]


def code_aperiodicity(ap_ratio):
    """(T, num_bands) ratio -> coded bap = ln(ratio), in
    [ln(1e-9), 0]."""
    return torch.log(torch.clamp(ap_ratio, _AP_FLOOR, 1.0))


def decode_aperiodicity(bap, num_bins, fs):
    """Coded bap (..., num_bands) -> aperiodicity (..., num_bins) by
    piecewise-linear interpolation of the log ratio over band anchors
    (pyworld.decode_aperiodicity role).  As in WORLD, the 0 Hz anchor is
    pinned at the aperiodicity floor and the Nyquist anchor holds the
    last band's value."""
    if bap.dim() == 1:
        bap = bap[None]
    num_bands = bap.shape[-1]
    log_floor = float(np.log(_AP_FLOOR))
    log_ratio = torch.clamp(bap, log_floor, 0.0)
    anchors_f = np.concatenate([[0.0], 3000.0 * (np.arange(num_bands) + 1.0),
                                [fs / 2.0]]).astype(np.float32)
    anchors_v = torch.cat([
        torch.full(bap.shape[:-1] + (1,), log_floor, dtype=bap.dtype,
                   device=bap.device),
        log_ratio, log_ratio[..., -1:]], dim=-1)
    # The anchor grid is shared, so the segment of each bin and its
    # interpolation weight are host constants.
    freqs = np.linspace(0.0, fs / 2.0, num_bins, dtype=np.float32)
    seg = np.clip(np.searchsorted(anchors_f, freqs, side="right") - 1,
                  0, num_bands)
    f_lo = anchors_f[seg]
    f_hi = anchors_f[seg + 1]
    w = np.where(f_hi > f_lo,
                 (freqs - f_lo) / np.maximum(f_hi - f_lo, 1e-9), 0.0)
    w = torch.as_tensor(w.astype(np.float32), device=bap.device)
    seg_t = torch.as_tensor(seg, device=bap.device)
    v_lo = anchors_v[..., seg_t]
    v_hi = anchors_v[..., seg_t + 1]
    ap_log = v_lo * (1.0 - w) + v_hi * w
    return torch.clamp(torch.exp(ap_log), _AP_FLOOR, 1.0)
