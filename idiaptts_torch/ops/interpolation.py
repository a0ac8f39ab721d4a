"""Interpolation and delta features: the port of
``idiaptts_tpu/ops/interpolation.py``.

The host half is numpy, as in the JAX package: ``interpolate_lin`` (the
reference's fill semantics for unvoiced gaps), ``sample_linearly``,
``compute_deltas``, ``add_deltas`` and ``surround_with_norm_dist``.
``compute_deltas_jnp`` keeps the JAX package's name for the on-device
variant; here it takes and returns torch tensors.
"""

import math

import numpy as np
import torch


def interpolate_lin(data):
    """Continuous f0/lf0 and a vuv flag from an f0 track with unvoiced
    zeros: ``(ip_data, vuv)``, both (T, 1) float64.

    The reference's Merlin-derived fill, vectorised, with its quirks:
    an interior gap between voiced frames ``p`` and ``n`` uses the slope
    ``(x[n]-x[p])/(n-p-1)`` (so the sample just before ``n`` already
    equals ``x[n]``), a gap whose next voiced frame is the final frame
    is a trailing gap (filled with the previous voiced value), and a
    leading gap takes the first voiced value."""
    data = np.reshape(np.copy(np.asarray(data, dtype=np.float64)), (-1, 1))
    T = data.shape[0]
    vuv = (data > 0.0).astype(np.float64)
    x = data[:, 0]
    voiced = x > 0.0
    if not voiced.any():
        return np.zeros_like(data), vuv
    idx = np.arange(T)
    # prev[k]: last voiced frame <= k (-1 if none); nxt[k]: first voiced
    # frame >= k (T if none).
    prev = np.maximum.accumulate(np.where(voiced, idx, -1))
    nxt = np.minimum.accumulate(np.where(voiced, idx, T)[::-1])[::-1]

    ip = x.copy()
    gap = ~voiced
    p, n = prev[gap], nxt[gap]
    k = idx[gap]
    xp = np.where(p >= 0, x[np.clip(p, 0, T - 1)], 0.0)
    xn = np.where(n < T, x[np.clip(n, 0, T - 1)], 0.0)
    interior = n <= T - 2  # next voiced frame exists and is not the last
    denom = np.maximum(n - p - 1, 1).astype(np.float64)
    interp_val = xp + (xn - xp) * (k - p) / denom
    trail_val = np.where(p >= 0, xp, 0.0)
    ip[gap] = np.where(interior, np.where(p >= 0, interp_val, xn),
                       trail_val)
    # A trailing gap whose next voiced frame is exactly the final frame
    # overwrites that final frame too (the reference's fill runs to T).
    if T >= 2 and voiced[T - 1] and not voiced[T - 2]:
        p_last = prev[T - 2]
        ip[T - 1] = x[p_last] if p_last >= 0 else 0.0
    return ip.reshape(-1, 1), vuv


# float64 values a block of sample_linearly's rows holds (64 KB).
_BLOCK_VALUES = 8192


def sample_linearly(sample, in_to_out_multiplier, dtype=np.float32):
    """Upsample along axis 0 by linear interpolation: the output has
    ``int(multiplier) * len(sample)`` rows, queried at points linspaced
    over [0, len - 1]."""
    if in_to_out_multiplier == 1:
        return sample
    if in_to_out_multiplier < 1:
        raise NotImplementedError("Down-sampling is not supported.")
    sample = np.asarray(sample)
    T = len(sample)
    x_new = np.linspace(0.0, T - 1, num=int(in_to_out_multiplier) * T)
    lo = np.floor(x_new).astype(np.int64)
    hi = np.minimum(lo + 1, T - 1)
    frac = (x_new - lo).reshape((-1,) + (1,) * (sample.ndim - 1))
    # sample[lo] * (1 - frac) + sample[hi] * frac in float64, as NumPy's
    # mixed-type loops compute it, on a float64 copy of the (short) input
    # and in blocks of rows whose temporaries stay in the allocator's
    # small-block pool: fresh megabyte-sized temporaries cost more in page
    # faults than the arithmetic.  The WaveNet trainers upsample every
    # 0.5 s crop on the loader thread; this takes under half the host
    # time of the one-expression form, with the same values.
    wide = sample.astype(np.float64)
    out = np.empty((len(x_new),) + sample.shape[1:], dtype)
    step = max(1, _BLOCK_VALUES // max(1, wide[:1].size))
    for start in range(0, len(x_new), step):
        rows = slice(start, start + step)
        block = wide[lo[rows]]
        block *= 1.0 - frac[rows]
        upper = wide[hi[rows]]
        upper *= frac[rows]
        block += upper
        out[rows] = block
    return out


def compute_deltas(labels):
    """First-order deltas as ``np.gradient`` computes them: central
    differences (-0.5, 0, 0.5) inside, one-sided at the edges (the MLPG
    windows assume this)."""
    return np.gradient(np.asarray(labels), axis=0).astype(np.float32)


def compute_deltas_jnp(labels):
    """:func:`compute_deltas` on a (T, D) tensor, on its device."""
    upper = torch.cat([labels[1:2], labels[2:], labels[-1:]], dim=0)
    lower = torch.cat([labels[:1], labels[:-2], labels[-2:-1]], dim=0)
    deltas = (upper - lower) * 0.5
    deltas[0] = labels[1] - labels[0]
    deltas[-1] = labels[-1] - labels[-2]
    return deltas


def add_deltas(features):
    """Stack [x, dx, ddx] along the feature axis of a (T, D) array."""
    features = np.asarray(features)
    if features.ndim == 1:
        features = features[:, None]
    d1 = compute_deltas(features)
    d2 = compute_deltas(d1)
    return np.concatenate([features, d1, d2], axis=-1).astype(np.float32)


def surround_with_norm_dist(label, window_size=5, std_dev=1.0, mean=0.0,
                            threshold=0.2):
    """Surround each atom row with a normal-distribution bump scaled by
    the atom's signed row values: the window spans +-threshold_x (where
    the pdf falls to ``threshold`` of its peak), atoms are located by
    column 0, and overlapping bumps sum."""
    if window_size % 2 == 0:
        window_size += 1
    half = window_size // 2
    threshold_x = abs(mean + math.sqrt(
        -math.log(threshold) * 2.0 * std_dev ** 2 - mean ** 2))
    x = np.linspace(-threshold_x, threshold_x, window_size)
    coefs = np.exp(-0.5 * ((x - mean) / std_dev) ** 2)
    coefs /= np.exp(-0.5 * ((mean - mean) / std_dev) ** 2)

    label = np.asarray(label, dtype=np.float64)
    squeeze = label.ndim == 1
    if squeeze:
        label = label[:, None]
    out = np.zeros_like(label)
    (atoms_pos,) = np.nonzero(label[:, 0] != 0)
    for pos in atoms_pos:
        start = pos - half
        dist_start, dist_end = 0, window_size
        if start < 0:
            dist_start = -start
            start = 0
        end = pos + half
        if end >= len(label):
            dist_end = window_size - (end - len(label) + 1)
            end = len(label) - 1
        out[start:end + 1] += np.outer(coefs[dist_start:dist_end],
                                       label[pos])
    out = out.astype(np.float32)
    return out[:, 0] if squeeze else out
