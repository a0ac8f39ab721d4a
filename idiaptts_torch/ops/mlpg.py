"""Maximum-probability parameter generation (MLPG) trajectory smoothing:
the port of ``idiaptts_tpu/ops/mlpg.py``.

Windows ``(1)``, ``(-0.5, 0, 0.5)``, ``(1, -2, 1)`` and the 1e11
boundary variances on the delta windows are the reference's.  The
precision matrix is symmetric pentadiagonal, so a solve is a
bandwidth-2 Cholesky factorisation plus two substitutions, vectorised
over all feature dimensions (lanes).  Three paths:

- :func:`mlpg_torch` (``MLPG.generation``, one utterance at a time):
  assembles the banded system on the device and runs factorisation and
  both substitutions in one :func:`~idiaptts_torch.ops.cuda_mlpg.
  mlpg_oneshot` launch.
- :func:`mlpg_factorise` + :func:`mlpg_solve` (the batch path): the
  system depends only on the variances and the frame count, so the
  Cholesky runs once per length bucket and each batch runs only the two
  substitutions, with batch x feature folded into the lanes of one
  :func:`~idiaptts_torch.ops.cuda_mlpg.solve_banded` call.
- :func:`mlpg_numpy` (``backend="numpy"``): scipy ``solveh_banded`` in
  float64 on the host, the numerical reference.
"""

import numpy as np
import scipy.linalg
import torch

from idiaptts_torch.ops.cuda_mlpg import (cholesky_banded_plain,
                                          mlpg_oneshot, solve_banded)
from idiaptts_torch.ops.dispatch import resolve_device

_WINDOWS = (
    np.array([0.0, 1.0, 0.0]),        # static
    np.array([-0.5, 0.0, 0.5]),       # delta (np.gradient convention)
    np.array([1.0, -2.0, 1.0]),       # delta-delta
)
_BOUNDARY_VAR = 1e11


# -- host reference (numpy, float64) ----------------------------------------

def _window_variances(covariance, feature_dim, frames):
    """Per-window per-frame variances (frames, 3, D) with boundary
    overrides, from the diagonal of a (3D, 3D) covariance."""
    diag = np.diagonal(np.asarray(covariance, dtype=np.float64))
    var = np.empty((frames, 3, feature_dim))
    for w in range(3):
        var[:, w, :] = diag[w * feature_dim:(w + 1) * feature_dim]
    var[0, 1:, :] = _BOUNDARY_VAR
    var[-1, 1:, :] = _BOUNDARY_VAR
    return var


def _banded_precision_and_b(features, var):
    """Pentadiagonal precision (lower-banded storage) and b vector for
    every dimension at once.  features, var: (T, 3, D).  Returns ab
    (3, T, D) rows [diag, sub1, sub2] and b (T, D)."""
    T, _, D = features.shape
    tau = 1.0 / var
    btau = features * tau
    ab = np.zeros((3, T, D))
    b = np.zeros((T, D))
    for w, c in enumerate(_WINDOWS):
        # Window matrix W has W[t, t+k] = c[k+1], rows clipped at the
        # boundaries.
        for k in (-1, 0, 1):
            rows = np.arange(max(0, -k), T - max(0, k))
            b[rows + k] += c[k + 1] * btau[rows, w]
        # P += W^T diag(tau) W, lower band only.
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                if j < i:
                    continue
                rows = np.arange(max(0, -i, -j), T - max(0, i, j))
                ab[j - i, rows + i] += c[i + 1] * c[j + 1] * tau[rows, w]
    return ab, b


def mlpg_numpy(features, covariance, feature_dim):
    """Host reference via scipy ``solveh_banded`` in float64.
    features: (T, 3*feature_dim) [static, delta, delta-delta];
    covariance: (3*feature_dim, 3*feature_dim).  Returns (T, D)."""
    features = np.asarray(features, dtype=np.float64)
    T = features.shape[0]
    feats = features.reshape(T, 3, feature_dim)
    ab, b = _banded_precision_and_b(
        feats, _window_variances(covariance, feature_dim, T))
    out = np.empty((T, feature_dim))
    for d in range(feature_dim):
        out[:, d] = scipy.linalg.solveh_banded(ab[:, :, d], b[:, d],
                                               lower=True)
    return out


# -- the banded system in torch -----------------------------------------------

def _shift(x, k):
    """x[..., t, :] -> x[..., t - k, :] along the time axis (-2), zero
    filled."""
    if k == 0:
        return x
    zeros = torch.zeros_like(x[..., :abs(k), :])
    if k > 0:
        return torch.cat([zeros, x[..., :-k, :]], dim=-2)
    return torch.cat([x[..., -k:, :], zeros], dim=-2)


def _boundary_variances(variances, feature_dim, num_frames):
    """(3*D,) diagonal variances -> (T, 3, D) float32 per-frame window
    variances with the 1e11 delta variances on the first and last
    frame."""
    T, D = int(num_frames), int(feature_dim)
    var_row = torch.tensor(np.asarray(variances, np.float32)).reshape(3, D)
    var = var_row[None].expand(T, 3, D).clone()
    var[0, 1:, :] = _BOUNDARY_VAR
    var[-1, 1:, :] = _BOUNDARY_VAR
    return var


def _banded_precision(variances):
    """Lower-banded pentadiagonal precision rows [ab0, ab1, ab2], each
    (T, D), from per-frame window variances (T, 3, D), on their
    device."""
    T, _, D = variances.shape
    tau = 1.0 / variances
    bands = [torch.zeros(T, D, dtype=tau.dtype, device=tau.device)
             for _ in range(3)]
    idx = torch.arange(T, device=tau.device)
    for w, c in enumerate(_WINDOWS):
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                band = j - i
                if band < 0:
                    continue
                contrib = float(c[i + 1] * c[j + 1]) * _shift(
                    tau[:, w], i)
                valid = ((idx - i >= 0) & (idx - i < T)
                         & (idx - i + j >= 0) & (idx - i + j < T))
                contrib = torch.where(valid[:, None], contrib,
                                      torch.zeros_like(contrib))
                bands[band] = bands[band] + contrib
    return bands


def _b_vector(btau):
    """b = sum_w W_w^T btau_w from the precision-weighted window means
    btau (..., T, 3, D); returns (..., T, D)."""
    b = torch.zeros(btau.shape[:-2] + btau.shape[-1:], dtype=btau.dtype,
                    device=btau.device)
    for w, coeff in enumerate(_WINDOWS):
        for k in (-1, 0, 1):
            if coeff[k + 1] != 0.0:
                b = b + float(coeff[k + 1]) * _shift(btau[..., w, :], k)
    return b


def _banded_system(features, variances):
    """The banded system of one utterance (the role of
    ``_banded_system_jnp``): features and variances (T, 3, D) ->
    ([ab0, ab1, ab2], b), each (T, D), on the inputs' device."""
    return _banded_precision(variances), _b_vector(
        features * (1.0 / variances))


# -- one-shot path (MLPG.generation) -----------------------------------------

def mlpg_torch(features, variances, feature_dim, device="cuda"):
    """One utterance's MLPG on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA), the role of
    ``mlpg_jax``/``mlpg_pallas``.

    features: (T, 3*feature_dim) [static, delta, delta-delta] window
    means; variances: (3*feature_dim,) diagonal variances.  Returns the
    smoothed (T, feature_dim) float32 trajectory as a tensor on
    ``device``."""
    device = resolve_device(device)
    feats = torch.tensor(np.asarray(features, np.float32), device=device)
    T, D = feats.shape[0], int(feature_dim)
    var = _boundary_variances(variances, D, T).to(device)
    (ab0, ab1, ab2), b = _banded_system(feats.reshape(T, 3, D), var)
    return mlpg_oneshot(b.contiguous(), ab0.contiguous(), ab1.contiguous(),
                        ab2.contiguous())


class MLPG:
    """Front door of the reference's ``MLPG.generation``."""

    def generation(self, features, covariance, feature_dim, backend="torch",
                   device="cuda"):
        """features (T, 3*feature_dim), covariance (3*feature_dim,
        3*feature_dim) -> (T, feature_dim) numpy trajectory.
        ``backend="torch"`` runs :func:`mlpg_torch` on ``device`` (float32);
        ``backend="numpy"`` the float64 host reference."""
        if backend == "numpy":
            return mlpg_numpy(features, covariance, feature_dim)
        if backend != "torch":
            raise ValueError("unknown MLPG backend " + repr(backend))
        variances = np.diagonal(np.asarray(covariance, dtype=np.float32))
        return mlpg_torch(features, variances, feature_dim,
                          device=device).cpu().numpy()


# -- batch path (factor once per length bucket) -------------------------------

def mlpg_factorise(variances, feature_dim, num_frames, device="cuda"):
    """Banded Cholesky factors for ``num_frames`` frames.

    variances: (3*feature_dim,) diagonal variances [static | delta |
    delta-delta].  Returns ``(factors (3, T, D), tau (T, 3, D))`` as
    float32 tensors on ``device`` (the card unless ``device="cpu"``;
    raises without CUDA).  Computed on the CPU in float32 (the
    reference's precision), then moved."""
    device = resolve_device(device)
    var = _boundary_variances(variances, feature_dim, num_frames)
    l0, l1, l2 = cholesky_banded_plain(*_banded_precision(var))
    factors = torch.stack([l0, l1, l2])
    tau = 1.0 / var
    return factors.to(device), tau.to(device)


def mlpg_solve(features, factors, tau, feature_dim):
    """MLPG with precomputed factors.

    features: (..., T, 3*feature_dim) window means; factors (3, T, D) and
    tau (T, 3, D) from :func:`mlpg_factorise`.  Returns (..., T, D).
    Leading dims fold with the feature dim into the lanes of one banded
    solve: (T, B*D)."""
    T = features.shape[-2]
    D = int(feature_dim)
    feats = features.reshape(features.shape[:-2] + (T, 3, D))
    b = _b_vector(feats * tau)
    flat = b.reshape(-1, T, D)
    B = flat.shape[0]
    lanes = flat.permute(1, 0, 2).reshape(T, B * D).contiguous()
    l0, l1, l2 = (factors[i].repeat(1, B).contiguous() for i in range(3))
    solved = solve_banded(lanes, l0, l1, l2)
    return solved.reshape(T, B, D).permute(1, 0, 2).reshape(b.shape)
