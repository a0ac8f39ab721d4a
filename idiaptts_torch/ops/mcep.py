"""Mel-cepstrum decode: the port of the synthesis half of
``idiaptts_tpu/ops/mcep.py``.

With the all-pass warp ``beta(w) = w + 2*atan(alpha*sin(w) / (1 -
alpha*cos(w)))`` the mel log-amplitude model is ``log|H(w)| = sum_m c_m
cos(m*beta(w))``: a matmul with a precomputed warped-cosine basis.  The
basis matmuls run in full float32 (the reference's
``Precision.HIGHEST``): TF32 would cost about three decimal digits on
the reconstructed spectra, so callers on the GPU keep
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default).
"""

from functools import lru_cache

import numpy as np
import torch


def mcep_alpha(fs):
    """Best all-pass warping coefficient for a sample rate (grid search
    against the mel scale; pysptk.mcepalpha behaviour)."""
    alphas = np.arange(0.0, 1.0, 0.001)
    num = 1000
    omega = np.arange(1, num + 1) / num * np.pi
    nyq = fs / 2.0
    freq = omega / np.pi * nyq
    mel = np.log1p(freq / 1000.0 * 10.0 / 10.0)
    mel = mel / mel[-1] * np.pi
    best_alpha, best_dist = 0.0, np.inf
    for alpha in alphas:
        warped = omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                          1.0 - alpha * np.cos(omega))
        dist = np.sqrt(np.mean((warped - mel) ** 2))
        if dist < best_dist:
            best_alpha, best_dist = alpha, dist
    return round(best_alpha, 3)


@lru_cache(maxsize=None)
def fs_to_mgc_alpha(fs):
    """Known SPTK values for common rates; grid search otherwise."""
    table = {8000: 0.312, 11025: 0.357, 16000: 0.41, 22050: 0.455,
             44100: 0.544, 48000: 0.554}
    return table.get(int(fs), mcep_alpha(fs))


def fs_to_frame_length(fs):
    """CheapTrick FFT size: 2 ** ceil(log2(3 * fs / 71 + 1))."""
    f0_floor = 71.0
    return int(2 ** np.ceil(np.log2(3.0 * fs / f0_floor + 1.0)))


def warp_frequency(omega, alpha):
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega),
                                    1.0 - alpha * np.cos(omega))


@lru_cache(maxsize=None)
def _bases(num_bins, order, alpha):
    """(analysis pinv, synthesis basis) as float32 numpy:
    A (num_bins, order+1) with A[k, m] = cos(m * beta(w_k)), and
    pinv(A) (order+1, num_bins)."""
    omega = np.linspace(0, np.pi, num_bins)
    beta = warp_frequency(omega, alpha)
    m = np.arange(order + 1)
    A = np.cos(beta[:, None] * m[None, :])
    pinv = np.linalg.pinv(A)
    return pinv.astype(np.float32), A.astype(np.float32)


@lru_cache(maxsize=64)
def _synthesis_basis_t(num_bins, order, alpha, device):
    """A^T (order+1, num_bins) as a float32 tensor on ``device``."""
    _, A = _bases(num_bins, order, alpha)
    return torch.as_tensor(np.ascontiguousarray(A.T), device=device)


def _warped_log_amp(mcep, num_bins, alpha):
    order = mcep.shape[-1] - 1
    return torch.matmul(mcep, _synthesis_basis_t(num_bins, order,
                                                 float(alpha),
                                                 mcep.device))


def mcep_to_amp_sp(mcep, num_bins, alpha):
    """Mel-cepstrum (..., order+1) -> amplitude spectrum (..., num_bins).
    The clip before exp keeps divergent model outputs finite."""
    return torch.exp(torch.clamp(_warped_log_amp(mcep, num_bins, alpha),
                                 -60.0, 25.0))


def mcep_to_log_amp_sp(mcep, num_bins, alpha):
    return _warped_log_amp(mcep, num_bins, alpha)


def merlin_post_filter(mgc, alpha, coef=1.4, num_bins=513):
    """Formant-emphasis post filter with energy preservation (nnmnkwii
    merlin_post_filter semantics): boost c_2.. by ``coef``, then correct
    c_0 so the total spectral energy is unchanged."""
    order = mgc.shape[-1] - 1
    weights = torch.ones(order + 1, dtype=mgc.dtype, device=mgc.device)
    weights[2:] = coef
    mgc_p = mgc * weights
    e_orig = torch.sum(torch.exp(2.0 * _warped_log_amp(mgc, num_bins,
                                                       alpha)), dim=-1)
    e_post = torch.sum(torch.exp(2.0 * _warped_log_amp(mgc_p, num_bins,
                                                       alpha)), dim=-1)
    c0_corr = 0.5 * torch.log(e_orig / torch.clamp(e_post, min=1e-20))
    out = mgc_p.clone()
    out[..., 0] = out[..., 0] + c0_corr
    return out
