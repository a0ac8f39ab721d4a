"""Mel-cepstral analysis and decode: the port of
``idiaptts_tpu/ops/mcep.py``.

With the all-pass warp ``beta(w) = w + 2*atan(alpha*sin(w) / (1 -
alpha*cos(w)))`` the mel log-amplitude model is ``log|H(w)| = sum_m c_m
cos(m*beta(w))``: a matmul with a precomputed warped-cosine basis one
way (decode) and with its pseudo-inverse the other (the least-squares
analysis, then 32 fixed-Hessian iterations towards SPTK's UELS
criterion).  The basis matmuls run in full float32 (the reference's
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


@lru_cache(maxsize=64)
def _analysis_bases(num_bins, order, alpha, device):
    """(pinv^T (num_bins, order+1), A (num_bins, order+1), H0^-1
    (order+1, order+1)) as float32 tensors on ``device``: H0 is the UELS
    Hessian at the optimum (w = 1), inverted in float64 on the host."""
    pinv, A = _bases(num_bins, order, alpha)
    h0_inv = np.linalg.inv(4.0 * (A.T @ A) / num_bins
                           + np.eye(order + 1) * 1e-4).astype(np.float32)
    return (torch.as_tensor(np.ascontiguousarray(pinv.T), device=device),
            torch.as_tensor(A, device=device),
            torch.as_tensor(h0_inv, device=device))


def amp_sp_to_mcep_ls(amp_sp, order, alpha):
    """Log-domain least-squares mel-cepstral projection (cepstral
    smoothing): one matmul; the initial point of :func:`amp_sp_to_mcep`."""
    pinv_t, _, _ = _analysis_bases(amp_sp.shape[-1], order, float(alpha),
                                   amp_sp.device)
    return torch.matmul(torch.log(torch.clamp(amp_sp, min=1e-10)), pinv_t)


def amp_sp_to_mcep(amp_sp, order, alpha, num_iters=32):
    """Mel-cepstral analysis of amplitude spectra (..., num_bins) with
    SPTK's UELS criterion (the ``pysptk.mcep(x, order, alpha, itype=3)``
    role): minimise ``mean(exp(R) - R - 1)`` with ``R = log I - 2 c A^T``
    (I the power spectrum) by ``num_iters`` quasi-Newton steps with the
    Hessian fixed at the optimum, each step clipped to +-1."""
    num_bins = amp_sp.shape[-1]
    _, A, h0_inv = _analysis_bases(num_bins, order, float(alpha),
                                   amp_sp.device)
    log_I = 2.0 * torch.log(torch.clamp(amp_sp, min=1e-10))
    c = amp_sp_to_mcep_ls(amp_sp, order, alpha)
    A_t = A.t()
    for _ in range(num_iters):
        R = log_I - 2.0 * torch.matmul(c, A_t)
        w = torch.exp(torch.clamp(R, -30.0, 30.0))
        g = -2.0 * torch.matmul(w - 1.0, A) / num_bins
        c = c + torch.clamp(-torch.matmul(g, h0_inv), -1.0, 1.0)
    return c


def min_phase_log_spectrum(log_amp):
    """Minimum-phase complex log spectrum from a real log-amplitude
    spectrum (..., num_bins) by the cepstral method: zero the anti-causal
    cepstrum, double the causal part."""
    num_bins = log_amp.shape[-1]
    n_fft = 2 * (num_bins - 1)
    cep = torch.fft.irfft(log_amp, n=n_fft, dim=-1)
    lifter = torch.cat([
        torch.ones(1), 2.0 * torch.ones(n_fft // 2 - 1), torch.ones(1),
        torch.zeros(n_fft // 2 - 1)]).to(device=log_amp.device,
                                         dtype=cep.dtype)
    return torch.fft.rfft(cep * lifter, n=n_fft, dim=-1)


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
