"""F0 tracking: the port of ``idiaptts_tpu/ops/world/f0.py``.

The device half runs on the tensors' device in float32 (cuFFT on the
card): framing, the normalised cross-correlation by FFT, local-maximum
candidates with parabolic refinement, a Viterbi over the candidates and
an unvoiced state, the energy gate and two instantaneous-frequency
refinement passes (the StoneMask role).  The four-interval voicing
decision (:func:`refine_vuv`) is event detection in numpy float64 on
the host, as in the JAX package.

The waveform is padded with zeros to a multiple of ``_LENGTH_BUCKET``
samples before the analysis, as the JAX package pads it: the energy
gate's maximum and the Viterbi's backtrace run over the padded frames,
so the bucket is part of the result.

The Viterbi's forward pass is a sequential min-plus recurrence, one
step a frame, kept in the JAX package's order (``prev_cost[:, None] +
trans``, the minimum and its first index, then ``+ obs_t``).  Its
backtrace is a composition of per-frame maps, exact in any order, so it
runs as a doubling scan of gathers (log2 T steps) on the device.
"""

import numpy as np
import torch

from idiaptts_torch.ops.dispatch import resolve_device

_NUM_CANDS = 8          # candidate peaks per frame
_UNVOICED_COST = 0.52   # score below which unvoiced becomes attractive
_TRANSITION_W = 4.0     # octave-jump penalty weight
_LAG_BIAS = 0.0         # subharmonic penalty supersedes lag bias
_SCORE_TH = 0.47        # picked candidates scoring lower are unvoiced
_SWITCH_COST = 0.25     # voiced <-> unvoiced transition
_LENGTH_BUCKET = 16384  # waveform padding (samples)


def _num_frames(num_samples, hop):
    return max(1, 1 + (num_samples - 1) // hop)


def _frame_signal(raw, hop, num_frames, seg_len, front_pad):
    """(num_frames, seg_len) windows: frame ``t`` covers samples
    ``[t*hop - front_pad, t*hop - front_pad + seg_len)``, zeros outside
    the signal."""
    rows_per_frame = -(-seg_len // hop)
    padded = torch.nn.functional.pad(
        raw, (front_pad, (rows_per_frame + num_frames) * hop))
    return padded.unfold(0, seg_len, hop)[:num_frames]


def _nccf(raw, fs, hop, f0_floor, window):
    """Normalised cross-correlation (T, max_lag + 1) and the frame
    energy (T,)."""
    max_lag = int(fs / f0_floor) + 1
    num_frames = _num_frames(raw.shape[0], hop)
    seg_len = window + max_lag
    segs = _frame_signal(raw, hop, num_frames, seg_len, window // 2)
    segs = segs - torch.mean(segs[:, :window], dim=1, keepdim=True)

    n_fft = int(2 ** np.ceil(np.log2(seg_len + window)))
    spec_base = torch.fft.rfft(segs[:, :window], n=n_fft, dim=-1)
    spec_full = torch.fft.rfft(segs, n=n_fft, dim=-1)
    corr = torch.fft.irfft(torch.conj(spec_base) * spec_full, n=n_fft,
                           dim=-1)[:, :max_lag + 1]

    # e0 = sum base^2; e[l] = sum segs[l:l+window]^2.
    csum = torch.cumsum(segs ** 2, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[:, :1]), csum], dim=-1)
    e_lag = csum[:, window:window + max_lag + 1] - csum[:, :max_lag + 1]
    e0 = e_lag[:, :1]
    denom = torch.sqrt(torch.clamp(e0 * e_lag, min=1e-12))
    return corr / denom, e0[:, 0] / window


def _top_k_lower_first(scores, k):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal scores (a stable descending sort)."""
    values, indices = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def _candidates(nccf, fs, f0_floor, f0_ceil):
    """Local-maximum candidate lags with parabolic refinement ->
    (T, K) f0 and scores (less a subharmonic penalty)."""
    L1 = nccf.shape[1]
    lags = torch.arange(L1, device=nccf.device)
    lag_min = int(fs / f0_ceil)
    valid = (lags >= lag_min) & (lags <= L1 - 2)

    left = torch.cat([nccf[:, :1], nccf[:, :-1]], dim=1)
    right = torch.cat([nccf[:, 1:], nccf[:, -1:]], dim=1)
    is_peak = (nccf >= left) & (nccf >= right) & valid[None, :]
    scores = torch.where(is_peak, nccf, torch.full_like(nccf, -1.0))
    top_scores, l = _top_k_lower_first(scores, _NUM_CANDS)

    ym1 = torch.gather(nccf, 1, torch.clamp(l - 1, min=0))
    y0 = torch.gather(nccf, 1, l)
    yp1 = torch.gather(nccf, 1, torch.clamp(l + 1, max=L1 - 1))
    denom = ym1 - 2.0 * y0 + yp1
    delta = torch.where(torch.abs(denom) > 1e-9,
                        0.5 * (ym1 - yp1) / denom, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    refined = l.to(torch.float32) + delta
    f0 = torch.clamp(fs / torch.clamp(refined, min=1.0), f0_floor, f0_ceil)

    # A candidate whose half lag also correlates strongly is likely an
    # octave-low duplicate of the true period.
    half = torch.clamp(l // 2, min=1)
    nccf_half = torch.gather(nccf, 1, half)
    penalty = 0.35 * torch.clamp(nccf_half - 0.4, 0.0, 1.0)
    penalty = torch.where(half >= lag_min, penalty,
                          torch.zeros_like(penalty))
    return f0, top_scores - penalty


def _viterbi(f0_cand, scores, uv_cost, trans_w):
    """Continuity smoothing over the K candidates of each frame plus an
    unvoiced state K.  Returns the best state path (T,) int64."""
    T, K = f0_cand.shape
    device = f0_cand.device
    log_f0 = torch.log(f0_cand)
    obs = torch.cat([-scores, torch.full((T, 1), -uv_cost,
                                         dtype=scores.dtype,
                                         device=device)], dim=1)
    # Every frame's (K+1, K+1) transition costs at once: the same
    # products the JAX step computes.
    jump = torch.abs(log_f0[1:, None, :] - log_f0[:-1, :, None])
    trans = torch.full((T - 1, K + 1, K + 1), _SWITCH_COST,
                       dtype=scores.dtype, device=device)
    trans[:, :K, :K] = trans_w * jump
    trans[:, K, K] = 0.0
    argmins = torch.empty((T, K + 1), dtype=torch.int64, device=device)
    argmins[0] = torch.arange(K + 1, device=device)
    cost = obs[0]
    moved = torch.empty(K + 1, dtype=scores.dtype, device=device)
    for t in range(1, T):
        torch.min(cost[:, None] + trans[t - 1], dim=0,
                  out=(moved, argmins[t]))
        cost = moved + obs[t]
    last = torch.argmin(cost)
    # path[t] = (A_{t+1} o ... o A_{T-1})(last) with A_t = argmins[t]:
    # suffix compositions by doubling; gathers compose maps exactly.
    maps = torch.cat([argmins[1:], torch.arange(
        K + 1, device=device)[None]], dim=0)
    d = 1
    while d < T:
        maps = torch.cat([torch.gather(maps[:-d], 1, maps[d:]), maps[-d:]],
                         dim=0)
        d *= 2
    return maps[:, last]


def _if_spectra(raw, fs, hop, num_frames, window):
    """Per-frame instantaneous frequency (the phase advance between a
    windowed segment and the same segment one sample later) and the
    power of each bin, for :func:`_refine_if`."""
    n_fft = int(2 ** np.ceil(np.log2(2 * window)))
    segs = _frame_signal(raw, hop, num_frames, window + 1, window // 2)
    n = torch.arange(window, device=raw.device, dtype=torch.float32)
    win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / (window - 1))
    spec_a = torch.fft.rfft(segs[:, :window] * win, n=n_fft, dim=-1)
    spec_b = torch.fft.rfft(segs[:, 1:window + 1] * win, n=n_fft, dim=-1)
    cross = spec_b * torch.conj(spec_a)
    inst_freq = torch.angle(cross) * fs / (2.0 * np.pi)
    mag2 = torch.abs(spec_a) ** 2
    return inst_freq, mag2, n_fft


def _refine_if(inst_freq, mag2, n_fft, fs, window, f0, voiced,
               num_harmonics=3):
    """StoneMask-role refinement: the instantaneous frequencies at the
    bins around the first harmonics, divided by the harmonic's index and
    averaged with power weights; harmonics more than 18% off the current
    estimate are dropped."""
    num_bins = inst_freq.shape[1]
    est_num = torch.zeros_like(f0)
    est_den = torch.zeros_like(f0)
    for k in range(1, num_harmonics + 1):
        bin_f = k * f0 * n_fft / fs
        b0 = torch.clamp(torch.round(bin_f).to(torch.int64), 1,
                         num_bins - 2)
        in_range = (k * f0) < (0.5 * fs - fs / window)
        for off in (-1, 0, 1):
            idx = torch.clamp(b0 + off, 0, num_bins - 1)[:, None]
            est = torch.gather(inst_freq, 1, idx)[:, 0] / k
            w = torch.gather(mag2, 1, idx)[:, 0]
            ok = in_range & (torch.abs(est - f0) < 0.18 * f0)
            w = torch.where(ok, w, torch.zeros_like(w))
            est_num = est_num + w * est
            est_den = est_den + w
    refined = est_num / torch.clamp(est_den, min=1e-12)
    use = voiced & (est_den > 1e-8)
    return torch.where(use, refined, f0)


def _extract_f0_dev(raw, fs, hop, f0_floor, f0_ceil, window,
                    uv_cost=_UNVOICED_COST, trans_w=_TRANSITION_W,
                    lag_bias=_LAG_BIAS, score_th=_SCORE_TH):
    """F0 (T,) of a padded waveform tensor on its device, 0 where
    unvoiced; T counts the padded frames."""
    nccf, energy = _nccf(raw, fs, hop, f0_floor, window)
    f0_cand, scores = _candidates(nccf, fs, f0_floor, f0_ceil)
    del nccf
    biased = scores - lag_bias * torch.log2(f0_ceil / f0_cand)
    path = _viterbi(f0_cand, biased, uv_cost, trans_w)
    K = f0_cand.shape[1]
    voiced = path < K
    pick = torch.clamp(path, max=K - 1)[:, None]
    picked = torch.gather(f0_cand, 1, pick)[:, 0]
    picked_score = torch.gather(scores, 1, pick)[:, 0]
    # Energy gate: frames 40 dB below the loudest are unvoiced.
    energy_db = 10.0 * torch.log10(energy + 1e-12)
    gate = energy_db > (torch.max(energy_db) - 40.0)
    voiced = voiced & gate & (picked_score > score_th)
    num_frames = _num_frames(raw.shape[0], hop)
    w_ref = int(fs * 0.035)
    inst_freq, mag2, n_fft = _if_spectra(raw, fs, hop, num_frames, w_ref)
    picked = torch.clamp(picked, f0_floor, f0_ceil)
    for _ in range(2):
        picked = _refine_if(inst_freq, mag2, n_fft, fs, w_ref, picked,
                            voiced)
        picked = torch.clamp(picked, f0_floor, f0_ceil)
    return torch.where(voiced, picked, torch.zeros_like(picked))


def correlation_window(fs):
    """The NCCF's correlation window (~30 ms, a power of two)."""
    return int(2 ** np.ceil(np.log2(fs * 0.03)))


def pad_to_bucket(raw, bucket=_LENGTH_BUCKET):
    """float32 copy of ``raw`` zero-padded to a multiple of ``bucket``."""
    raw = np.asarray(raw, dtype=np.float32)
    padded_len = int(np.ceil(max(len(raw), 1) / bucket) * bucket)
    padded = np.zeros(padded_len, dtype=np.float32)
    padded[:len(raw)] = raw
    return padded


def _four_interval_tracks(raw, fs, num_frames, hop, f0_floor, f0_ceil,
                          per_octave=6):
    """Harvest-style voicing evidence (host numpy float64).

    The signal is low-passed at log-spaced cutoffs; a channel's four
    period estimators (negative/positive zero crossings, peaks, dips)
    agree only where the cutoff isolates the fundamental.  Returns
    ``(best_f0, best_dev)`` per frame: the best channel's mean F0 and
    its relative deviation across the four estimators (9.0: no valid
    channel)."""
    raw = np.asarray(raw, dtype=np.float64)
    n = len(raw)
    tgrid = np.arange(num_frames) * hop / fs
    n_fft = int(2 ** np.ceil(np.log2(max(n, 2) + 1)))
    spec = np.fft.rfft(raw, n_fft)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / fs)
    n_oct = np.log2(f0_ceil / f0_floor)
    centers = f0_floor * 2.0 ** (
        (np.arange(int(n_oct * per_octave)) + 1) / per_octave)
    best_f0 = np.zeros(num_frames)
    best_dev = np.full(num_frames, 9.0)
    for c in centers:
        # Raised-cosine low-pass to zero at 1.2*c, rumble high-pass.
        lp = np.where(freqs < 1.2 * c,
                      0.5 * (1.0 + np.cos(np.pi * freqs / (1.2 * c))),
                      0.0)
        lp *= freqs > 35.0
        y = np.fft.irfft(spec * lp, n_fft)[:n]
        dy = np.diff(y)
        ests = []
        for sig in (y, -y, dy, -dy):
            s0, s1 = sig[:-1], sig[1:]
            idx = np.where((s0 < 0) & (s1 >= 0))[0]
            if len(idx) < 3:
                ests = []
                break
            frac = -s0[idx] / (s1[idx] - s0[idx] + 1e-20)
            times = (idx + frac) / fs
            intervals = np.diff(times)
            mids = 0.5 * (times[:-1] + times[1:])
            ests.append(np.interp(tgrid, mids,
                                  1.0 / np.maximum(intervals, 1e-6),
                                  left=0.0, right=0.0))
        if len(ests) < 4:
            continue
        est = np.stack(ests)
        mu = est.mean(axis=0)
        dev = est.std(axis=0) / np.maximum(mu, 1e-6)
        # Trust the channel only where mu sits in about [c/2.2, 1.2c].
        ok = ((mu > max(f0_floor, c / 2.2))
              & (mu < min(f0_ceil, 1.2 * c)))
        dev = np.where(ok, dev, 9.0)
        better = dev < best_dev
        best_f0 = np.where(better, mu, best_f0)
        best_dev = np.where(better, dev, best_dev)
    return best_f0, best_dev


def _voiced_runs(voiced):
    edges = np.diff(np.concatenate([[0], voiced.astype(np.int8), [0]]))
    return list(zip(np.where(edges == 1)[0], np.where(edges == -1)[0]))


def refine_vuv(raw, fs, f0, frame_shift_ms=5.0, f0_floor=71.0,
               f0_ceil=800.0, dev_th=0.007, min_run=6, ext_dev_th=0.02,
               merge_gap=3, max_ext=15):
    """Replace the NCCF voicing decision with the four-interval one
    (host numpy): a frame is voiced when its best channel deviation is
    below ``dev_th``; runs shorter than ``min_run`` frames are dropped;
    runs extend outward through F0-consistent frames with deviation
    below ``ext_dev_th``; gaps of at most ``merge_gap`` frames between
    F0-consistent runs are bridged.  The NCCF estimate is kept where it
    is within half an octave of the interval estimate, else the
    interval estimate is used."""
    f0 = np.asarray(f0).copy()
    hop = int(fs * frame_shift_ms / 1000.0)
    num_frames = len(f0)
    bf, bd = _four_interval_tracks(raw, fs, num_frames, hop, f0_floor,
                                   f0_ceil)
    voiced = bd < dev_th
    for s, e in _voiced_runs(voiced):
        if e - s < min_run:
            voiced[s:e] = False
    for s, e in _voiced_runs(voiced):
        last, i, cnt = bf[s], s - 1, 0
        while (i >= 0 and cnt < max_ext and not voiced[i]
               and bd[i] < ext_dev_th
               and abs(bf[i] - last) < 0.2 * last):
            voiced[i] = True
            last, i, cnt = bf[i], i - 1, cnt + 1
        last, i, cnt = bf[e - 1], e, 0
        while (i < num_frames and cnt < max_ext and not voiced[i]
               and bd[i] < ext_dev_th
               and abs(bf[i] - last) < 0.2 * last):
            voiced[i] = True
            last, i, cnt = bf[i], i + 1, cnt + 1
    runs = _voiced_runs(voiced)
    for (s1, e1), (s2, e2) in zip(runs[:-1], runs[1:]):
        if (s2 - e1 <= merge_gap
                and abs(bf[s2] - bf[e1 - 1]) < 0.25 * max(bf[e1 - 1], 1)):
            voiced[e1:s2] = True
    nccf_ok = (f0 > 0) & (np.abs(np.log2(np.maximum(f0, 1e-3)
                                         / np.maximum(bf, 1e-3))) < 0.5)
    out = np.where(voiced, np.where(nccf_ok, f0, bf), 0.0)
    return out.astype(np.float32)


def extract_f0(raw, fs, frame_shift_ms=5.0, f0_floor=71.0, f0_ceil=800.0,
               uv_cost=_UNVOICED_COST, trans_w=_TRANSITION_W,
               lag_bias=_LAG_BIAS, score_th=_SCORE_TH, vuv_refine=True,
               device="cuda"):
    """F0 track (numpy float32, 1 + (N-1)//hop frames) of a waveform;
    0 marks unvoiced frames.  The analysis runs on ``device``, the
    four-interval voicing refinement (``vuv_refine``) on the host."""
    device = resolve_device(device)
    hop = int(fs * frame_shift_ms / 1000.0)
    raw = np.asarray(raw, dtype=np.float32)
    num_frames = _num_frames(len(raw), hop)
    with torch.inference_mode():
        f0 = _extract_f0_dev(
            torch.from_numpy(pad_to_bucket(raw)).to(device), int(fs), hop,
            float(f0_floor), float(f0_ceil), correlation_window(fs),
            float(uv_cost), float(trans_w), float(lag_bias),
            float(score_th))
        f0 = f0[:num_frames].cpu().numpy()
    if vuv_refine:
        f0 = refine_vuv(raw, fs, f0, frame_shift_ms, f0_floor, f0_ceil)
    return f0
