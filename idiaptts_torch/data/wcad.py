"""WCAD-style atom decomposition of LF0 contours: the port of
``idiaptts_tpu/data/wcad.py`` (numpy on the host, as there).

A phrase component fit (one long gamma atom plus a bias, weighted least
squares over a theta grid) followed by gamma-kernel matching pursuit
on the residual, one batched FFT cross-correlation over all theta
tracks an iteration.  ``gen_data`` writes ``.atoms`` (raw float32 (T,
|thetas|, 2) amp/theta spikes) and ``.phrase`` (raw float32 (T,)) files
with mean-stddev statistics, the formats :mod:`idiaptts_torch.data.atoms`
and :mod:`idiaptts_torch.data.lf0` read.
"""

import math
import os

import numpy as np

from idiaptts_torch.data.atoms import AtomLabelGen, GammaAtom
from idiaptts_torch.data.normalisation import MeanStdDevExtractor
from idiaptts_torch.ops.interpolation import interpolate_lin


def gamma_curve(theta, k, frame_rate, length):
    """L2-normalised gamma kernel sampled at the frame rate."""
    t = np.arange(1, length + 1, dtype=np.float64) / frame_rate
    g = t ** (k - 1) * np.exp(-t / theta) / (theta ** k * math.gamma(k))
    norm = np.linalg.norm(g)
    return (g / norm if norm > 0 else g).astype(np.float64)


def _kernel_length(theta, k, frame_rate):
    """Support covering >99.9% of the kernel mass."""
    return int(np.ceil((k * theta + 6 * theta * np.sqrt(k))
                       * frame_rate))


def _interp_unvoiced(lf0, vuv):
    """Continuous lf0: linear interpolation through unvoiced regions."""
    lf0 = np.asarray(lf0, np.float64).reshape(-1)
    vuv = np.asarray(vuv).reshape(-1) > 0.5
    if not vuv.any():
        return lf0
    ip, _ = interpolate_lin(np.where(vuv, lf0, 0.0))
    return np.asarray(ip).reshape(-1)


def extract_phrase(lf0, vuv, frame_rate=200, k=6,
                   theta_grid=(0.3, 0.5, 0.75, 1.0, 1.5, 2.0)):
    """Fit the phrase component: bias + one long gamma atom starting at
    the first voiced frame, weighted least squares on voiced frames,
    theta chosen from a small grid.  Returns the (T,) phrase curve."""
    lf0 = np.asarray(lf0, np.float64).reshape(-1)
    vuv01 = (np.asarray(vuv).reshape(-1) > 0.5).astype(np.float64)
    T = len(lf0)
    cont = _interp_unvoiced(lf0, vuv01)
    w = np.where(vuv01 > 0, 1.0, 0.1)
    voiced_idx = np.nonzero(vuv01)[0]
    start = int(voiced_idx[0]) if len(voiced_idx) else 0

    best = None
    for theta in theta_grid:
        curve = np.zeros(T)
        L = min(_kernel_length(theta, k, frame_rate), 8 * T)
        g = gamma_curve(theta, k, frame_rate, L)
        end = min(T, start + L)
        curve[start:end] = g[:end - start]
        # Weighted LS for [bias, amp].
        X = np.stack([np.ones(T), curve], axis=1)
        Xw = X * w[:, None]
        try:
            coef, *_ = np.linalg.lstsq(Xw, cont * w, rcond=None)
        except np.linalg.LinAlgError:
            continue
        resid = cont - X @ coef
        err = float(np.sum(w * resid ** 2))
        if best is None or err < best[0]:
            best = (err, coef, curve)
    if best is None:
        return np.full(T, float(np.mean(cont)), np.float32)
    _, coef, curve = best
    return (coef[0] + coef[1] * curve).astype(np.float32)


def matching_pursuit(residual, weights, thetas, k=6, frame_rate=200,
                     max_atoms=40, min_amp=0.25, min_theta_sep=5):
    """Greedy gamma-atom decomposition of a weighted residual.

    Each iteration computes the cross-correlation of the residual with
    every (L2-normalised) theta kernel in one batched FFT, places the
    atom with the largest |amplitude|, and subtracts it.  Stops at
    ``max_atoms`` or when the best amplitude drops under ``min_amp``.
    Returns a list of GammaAtoms.
    """
    residual = np.asarray(residual, np.float64).copy()
    weights = np.asarray(weights, np.float64).reshape(-1)
    T = len(residual)
    thetas = tuple(thetas)
    kernels = []
    max_L = 0
    for theta in thetas:
        L = min(_kernel_length(theta, k, frame_rate), 4 * T)
        kernels.append(gamma_curve(theta, k, frame_rate, L))
        max_L = max(max_L, L)
    n_fft = 1
    while n_fft < T + max_L:
        n_fft *= 2
    # Kernel spectra, conjugated for correlation: corr[p] =
    # sum_t x[t] kern[t - p].
    kern_mat = np.zeros((len(thetas), n_fft))
    for i, kern in enumerate(kernels):
        kern_mat[i, :len(kern)] = kern
    kern_f = np.conj(np.fft.rfft(kern_mat, axis=1))

    atoms = []
    occupied = np.zeros((len(thetas), T), bool)
    for _ in range(max_atoms):
        x_f = np.fft.rfft(residual * weights, n_fft)
        corr = np.fft.irfft(x_f[None, :] * kern_f, n_fft,
                            axis=1)[:, :T]                 # (Th, T)
        corr = np.where(occupied, 0.0, corr)
        flat = np.argmax(np.abs(corr))
        ti, pos = np.unravel_index(flat, corr.shape)
        amp = float(corr[ti, pos])
        if abs(amp) < min_amp:
            break
        kern = kernels[ti]
        end = min(T, pos + len(kern))
        residual[pos:end] -= amp * kern[:end - pos]
        atoms.append(GammaAtom(k, thetas[ti], frame_rate, amp,
                               int(pos)))
        lo = max(0, pos - min_theta_sep)
        occupied[ti, lo:pos + min_theta_sep + 1] = True
    return atoms


def decompose(lf0, vuv, thetas, k=6, frame_rate=200, max_atoms=40,
              min_amp=0.25):
    """Full WCAD decomposition: phrase curve + atom spikes.

    Returns ``(labels, phrase)`` with labels (T, |thetas|, 2) amp/theta
    and phrase (T,) float32.
    """
    lf0 = np.asarray(lf0, np.float64).reshape(-1)
    T = len(lf0)
    phrase = extract_phrase(lf0, vuv, frame_rate, k)
    cont = _interp_unvoiced(lf0, vuv)
    residual = cont - phrase
    w = np.where(np.asarray(vuv).reshape(-1) > 0.5, 1.0, 0.1)
    atoms = matching_pursuit(residual, w, thetas, k, frame_rate,
                             max_atoms, min_amp)
    labels = AtomLabelGen.atoms_to_labels(atoms, thetas, T)
    return labels, phrase


def gen_data(dir_world, thetas, dir_out, id_list, k=6, frame_rate=200,
             max_atoms=40, min_amp=0.25, file_id_list_name="all"):
    """Extract atoms + phrase curves for a corpus from WORLD lf0/vuv
    files; writes ``.atoms``/``.phrase`` and mean-stddev stats."""
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen

    os.makedirs(dir_out, exist_ok=True)
    extractor = MeanStdDevExtractor()
    for id_name in id_list:
        sample = WorldFeatLabelGen.load_sample(
            id_name, dir_world, add_deltas=False, load_sp=False,
            load_bap=False)
        lf0, vuv = sample[:, 0], sample[:, 1]
        labels, phrase = decompose(lf0, vuv, thetas, k, frame_rate,
                                   max_atoms, min_amp)
        base = os.path.splitext(os.path.basename(id_name))[0]
        labels.astype(np.float32).tofile(
            os.path.join(dir_out, base + AtomLabelGen.ext_atoms))
        phrase.astype(np.float32).tofile(
            os.path.join(dir_out, base + AtomLabelGen.ext_phrase))
        extractor.add_sample(labels[:, :, 0].reshape(-1, 1))
    extractor.save(os.path.join(dir_out, file_id_list_name))
    return extractor.get_params()
