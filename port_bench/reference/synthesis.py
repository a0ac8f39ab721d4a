"""Model output -> waveform: denormalisation, MLPG and the WORLD vocoder.

MLPG is solved per dimension in float64 by ``scipy.linalg.solveh_banded``
on the pentadiagonal precision W^T diag(1/var) W, with the windows (1),
(-0.5, 0, 0.5) and (1, -2, 1) and the delta windows' variances at 1e11
on the first and last frame (IdiapTTS's MLPG).  Frames past an
utterance's length are silenced after the solve (c0 = -100, the rest 0,
unvoiced), and the voicing is the model's vuv column above 0.5.

The vocoder is a frozen copy of the port's plain PyTorch WORLD synthesis
from coded features (``_vocode_one``: the mel-cepstral envelope at the
harmonics of the phase pitch, the band aperiodicity, the degree-9
minimax sine bank, and shaped noise from one complex Gaussian draw
``noise_draw(T, bins)`` from a ``torch.Generator`` seeded with 0 on the
device), so that the reference and the program get the same draw.
"""

import numpy as np
import scipy.linalg
import torch

WINDOWS = (np.array([0.0, 1.0, 0.0]), np.array([-0.5, 0.0, 0.5]),
           np.array([1.0, -2.0, 1.0]))
BOUNDARY_VAR = 1e11
AP_FLOOR = 1e-9
_SIN = (3.1415284229461573, -5.166408786411196, 2.5427382100290914,
        -0.5818930905684506, 0.06404115475945735)


def layout(config):
    """Column indices of the model output (cmp order: sp statics, deltas,
    delta-deltas | lf0 x3 | vuv | bap x3 NB)."""
    D, NB = int(config["num_coded_sps"]), int(config["num_bap"])
    return D, NB, 3 * D + 3     # vuv column


def mlpg(out, config):
    """(T, C) denormalised output -> (T, D + 1 + NB) float64 statics."""
    D, NB, _ = layout(config)
    var = config["mlpg_variances"]
    streams = [(np.arange(3) * D + d, [var["sp"][w * D + d]
                                       for w in range(3)])
               for d in range(D)]
    streams.append((3 * D + np.arange(3), var["lf0"]))
    streams += [(3 * D + 4 + np.arange(3) * NB + k,
                 [var["bap"][w * NB + k] for w in range(3)])
                for k in range(NB)]
    T = out.shape[0]
    result = np.empty((T, len(streams)))
    for s, (cols, v) in enumerate(streams):
        ab = np.zeros((3, T))
        b = np.zeros(T)
        for w, c in enumerate(WINDOWS):
            tau = np.full(T, 1.0 / float(v[w]))
            if w > 0:
                tau[[0, -1]] = 1.0 / BOUNDARY_VAR
            mu = out[:, cols[w]].astype(np.float64)
            for k1 in (-1, 0, 1):
                t = np.arange(max(0, -k1), T - max(0, k1))
                b[t + k1] += c[k1 + 1] * mu[t] * tau[t]
                for k2 in (-1, 0, 1):
                    if k2 > k1:
                        continue
                    t = np.arange(max(0, -k1, -k2), T - max(0, k1, k2))
                    ab[k1 - k2, t + k2] += c[k1 + 1] * c[k2 + 1] * tau[t]
        result[:, s] = scipy.linalg.solveh_banded(ab, b, lower=True)
    return result


def _sin_cycles(x):
    t = 2.0 * x - 1.0
    t2 = t * t
    p = _SIN[4] * t2 + _SIN[3]
    p = p * t2 + _SIN[2]
    p = p * t2 + _SIN[1]
    p = p * t2 + _SIN[0]
    return -(t * p)


def _upsample(x, hop):
    T = x.shape[-2]
    w = torch.arange(hop, dtype=x.dtype, device=x.device) / hop
    x_next = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    out = (x[..., :, None, :] * (1 - w)[:, None]
           + x_next[..., :, None, :] * w[:, None])
    return out.reshape(x.shape[:-2] + (T * hop, x.shape[-1]))


def _harmonic_bank(f0_safe, amp, fs, hop):
    f0_safe = torch.clamp(f0_safe, 0.0, fs / 2.0)
    T, H = amp.shape[-2], amp.shape[-1]
    h = torch.arange(1, H + 1, dtype=torch.float32, device=amp.device)
    f0_s = _upsample(f0_safe[..., None], hop)[..., 0]
    inc = (f0_s / fs).reshape(f0_s.shape[:-1] + (T, hop))
    frame_sum = torch.sum(inc, dim=-1).to(torch.float64)
    frame_offset = torch.remainder(
        torch.cumsum(frame_sum, dim=-1) - frame_sum, 1.0).to(torch.float32)
    inner = torch.cumsum(inc, dim=-1)
    cycles = torch.remainder(frame_offset[..., None] + inner, 1.0)
    cycles = cycles.reshape(f0_s.shape)
    arg = torch.remainder(cycles[..., None] * h, 1.0)
    return torch.sum(_upsample(amp, hop) * _sin_cycles(arg), dim=-1)


def _band_anchors(bap, fs):
    num_bands = bap.shape[-1]
    log_floor = float(np.log(AP_FLOOR))
    log_ratio = torch.clamp(bap, log_floor, 0.0)
    anchors_f = np.concatenate([[0.0], 3000.0 * (np.arange(num_bands) + 1.0),
                                [fs / 2.0]])
    anchors_v = torch.cat(
        [torch.full(bap.shape[:-1] + (1,), log_floor, dtype=bap.dtype,
                    device=bap.device), log_ratio, log_ratio[..., -1:]],
        dim=-1)
    return anchors_f, anchors_v


def _ap_at_freqs(bap, freqs, fs):
    anchors_f, anchors_v = _band_anchors(bap, fs)
    ap_log = anchors_v[..., -1:].expand(freqs.shape)
    for s in range(len(anchors_f) - 1, 0, -1):
        f_lo, f_hi = anchors_f[s - 1], anchors_f[s]
        w = (freqs - f_lo) / max(f_hi - f_lo, 1e-9)
        seg = (anchors_v[..., s - 1:s] * (1.0 - w)
               + anchors_v[..., s:s + 1] * w)
        ap_log = torch.where(freqs < f_hi, seg, ap_log)
    return torch.clamp(torch.exp(ap_log), AP_FLOOR, 1.0)


def _harmonic_part(f0, f0_cont, coded, bap, fs, hop, alpha, max_harmonics):
    voiced = f0 > 0
    h = torch.arange(1, max_harmonics + 1, dtype=torch.float32,
                     device=coded.device)
    harm_freq = f0_cont[..., None] * h
    below_nyq = harm_freq < (fs / 2.0 * (1.0 - 2.0 / 1024.0))
    omega = (2.0 * np.pi) * torch.clamp(harm_freq / fs, 0.0, 0.5)
    beta = omega + 2.0 * torch.atan2(alpha * torch.sin(omega),
                                     1.0 - alpha * torch.cos(omega))
    cos1 = torch.cos(beta)
    c_prev, c_cur = torch.ones_like(cos1), cos1
    log_amp = coded[..., 0:1] + coded[..., 1:2] * cos1
    for m in range(2, coded.shape[-1]):
        c_prev, c_cur = c_cur, 2.0 * cos1 * c_cur - c_prev
        log_amp = log_amp + coded[..., m:m + 1] * c_cur
    env_p = torch.exp(2.0 * torch.clamp(log_amp, -60.0, 25.0))
    ap_h = _ap_at_freqs(bap, harm_freq, fs)
    periodic_frac = torch.sqrt(torch.clamp(1.0 - ap_h ** 2, 0.0, 1.0))
    amp = 2.0 * torch.sqrt(env_p * f0_cont[..., None] / fs)
    amp = amp * periodic_frac * below_nyq * voiced[..., None]
    return _harmonic_bank(f0_cont, amp, fs, hop)


def _amp_sp(coded, num_bins, alpha):
    omega = np.linspace(0, np.pi, num_bins)
    beta = omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))
    basis = np.cos(beta[:, None] * np.arange(coded.shape[-1])[None, :])
    basis_t = torch.as_tensor(np.ascontiguousarray(basis.T.astype(
        np.float32)), device=coded.device)
    return torch.exp(torch.clamp(torch.matmul(coded, basis_t), -60.0, 25.0))


def _decode_aperiodicity(bap, num_bins, fs):
    anchors_f, anchors_v = _band_anchors(bap, fs)
    anchors_f = anchors_f.astype(np.float32)
    freqs = np.linspace(0.0, fs / 2.0, num_bins, dtype=np.float32)
    seg = np.clip(np.searchsorted(anchors_f, freqs, side="right") - 1, 0,
                  bap.shape[-1])
    f_lo, f_hi = anchors_f[seg], anchors_f[seg + 1]
    w = np.where(f_hi > f_lo, (freqs - f_lo) / np.maximum(f_hi - f_lo, 1e-9),
                 0.0)
    w = torch.as_tensor(w.astype(np.float32), device=bap.device)
    seg_t = torch.as_tensor(seg, device=bap.device)
    ap_log = anchors_v[..., seg_t] * (1.0 - w) + anchors_v[..., seg_t + 1] * w
    return torch.clamp(torch.exp(ap_log), AP_FLOOR, 1.0)


def _overlap_add(x, k, hop):
    rows = x.shape[-2]
    chunks = x.reshape(x.shape[:-2] + (rows, k, hop))
    acc = x.new_zeros(x.shape[:-2] + (rows + k, hop))
    for j in range(k):
        acc[..., j:j + rows, :] += chunks[..., :, j, :]
    return acc.reshape(x.shape[:-2] + ((rows + k) * hop,))[..., :rows * hop]


def noise_draw(T, num_bins, device, seed=0):
    """The complex Gaussian frame spectra, drawn as the vocoder draws
    them: ``randn(2, T, bins)`` from a generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    parts = torch.randn(2, T, num_bins, generator=gen, device=device,
                        dtype=torch.float32)
    return torch.complex(parts[0], parts[1])


def _noise_part(sp_power, ap, hop, z):
    T, num_bins = sp_power.shape[-2], sp_power.shape[-1]
    n_fft = 2 * (num_bins - 1)
    k = max(1, min(4, n_fft // hop))
    win = k * hop
    w_np = np.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win),
                      np.float32)
    scale = float(np.sqrt(n_fft * win / (2.0 * float((w_np ** 2).sum()))))
    target = torch.sqrt(torch.clamp(sp_power, min=0.0)) * ap
    w = torch.as_tensor(w_np, device=sp_power.device)
    frames = torch.fft.irfft(z * (target * (scale / np.sqrt(2.0))),
                             n=n_fft, dim=-1)[..., :win] * w
    raw = _overlap_add(frames, k, hop)
    norm = _overlap_add((w ** 2).expand(T, win), k, hop)
    return raw * torch.rsqrt(torch.clamp(norm, min=1e-12))


def vocode(statics, vuv, config, device):
    """(B, T, D + 1 + NB) statics and (B, T) voicing -> (B, T * hop)
    float32 waveforms, the phase pitch at 150 Hz."""
    D, NB, _ = layout(config)
    fs = int(config["fs"])
    hop = int(fs * float(config["frame_shift_ms"]) / 1000.0)
    num_bins = int(config["num_bins"])
    alpha = float(config["mgc_alpha"])
    statics = torch.as_tensor(statics, dtype=torch.float32, device=device)
    vuv = torch.as_tensor(vuv, device=device)
    coded, lf0, bap = (statics[..., :D], statics[..., D],
                       statics[..., D + 1:D + 1 + NB])
    f0 = torch.where(vuv, torch.exp(torch.clamp(lf0, max=float(
        np.log(fs / 2.0)))), torch.zeros_like(lf0))
    f0_cont = torch.full_like(lf0, 150.0)
    harm = _harmonic_part(f0, f0_cont, coded, bap, fs, hop, alpha,
                          int(config["max_harmonics"]))
    nb_small = max(min(num_bins, 129), hop // 2 + 1 + (hop % 2))
    amp_small = _amp_sp(coded, nb_small, alpha)
    ap_small = _decode_aperiodicity(bap, nb_small, fs)
    z = noise_draw(statics.shape[-2], nb_small, device)
    return harm + _noise_part(amp_small ** 2, ap_small, hop, z)


def synthesise(out, lengths, config, device):
    """Model outputs (B, T, C) float32 tensor (normalised), lengths (B,)
    -> (B, T * hop) waveforms: denormalise, MLPG a row, silence the
    padding, vocode."""
    norm = config["normalisation"]
    mean = torch.as_tensor(norm["mean"], dtype=torch.float32,
                           device=out.device)
    scale = torch.as_tensor(norm["scale"], dtype=torch.float32,
                            device=out.device)
    den = (out * scale + mean).detach().cpu().numpy()
    _, _, vuv_col = layout(config)
    B, T, _ = den.shape
    statics = np.stack([mlpg(den[i], config) for i in range(B)])
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    silent = np.zeros(statics.shape[-1])
    silent[0] = -100.0
    statics = np.where(valid[..., None], statics, silent)
    vuv = (den[..., vuv_col] > 0.5) & valid
    return vocode(statics, torch.as_tensor(vuv), config, device)
