"""Maximum-probability parameter generation (MLPG) trajectory smoothing:
the port of ``idiaptts_tpu/ops/mlpg.py``.

Windows ``(1)``, ``(-0.5, 0, 0.5)``, ``(1, -2, 1)`` and the 1e11
boundary variances on the delta windows are the reference's.  The
precision matrix is symmetric pentadiagonal, so a solve is a
bandwidth-2 Cholesky factorisation plus two substitutions, vectorised
over all feature dimensions (lanes).  Three paths:

- :func:`mlpg_torch` (``MLPG.generation``, one utterance at a time):
  uploads the window means and the variances, and one
  :func:`~idiaptts_torch.ops.cuda_mlpg.mlpg_utterance` launch (K1)
  assembles the banded system and runs the factorisation and both
  substitutions.
- :func:`mlpg_factorise` + :func:`mlpg_solve` (the batch path): the
  system depends only on the variances and the frame count, so the
  Cholesky runs once per length bucket and each batch runs only the two
  substitutions, the batch's utterances sharing the factor, in one
  :func:`~idiaptts_torch.ops.cuda_mlpg.mlpg_served` launch (K2), which
  also assembles the right-hand side.
- :func:`mlpg_numpy` (``backend="numpy"``): scipy ``solveh_banded`` in
  float64 on the host, the numerical reference.
"""

import numpy as np
import scipy.linalg
import torch

from idiaptts_torch.ops import cuda_mlpg
from idiaptts_torch.ops.dispatch import resolve_device

_WINDOWS = cuda_mlpg.WINDOWS
_BOUNDARY_VAR = cuda_mlpg.BOUNDARY_VAR


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


# The torch assembly lives beside the kernels that build the system
# themselves (their plain versions use it); these names are its callers'.
_boundary_variances = cuda_mlpg.boundary_variances
_banded_precision = cuda_mlpg.banded_precision
_banded_system = cuda_mlpg.banded_system


# -- one-shot path (MLPG.generation) -----------------------------------------

def mlpg_torch(features, variances, feature_dim, device="cuda"):
    """One utterance's MLPG on ``device`` (the card unless
    ``device="cpu"``; raises without CUDA), the role of
    ``mlpg_jax``/``mlpg_pallas``.

    features: (T, 3*feature_dim) [static, delta, delta-delta] window
    means; variances: (3*feature_dim,) diagonal variances.  Returns the
    smoothed (T, feature_dim) float32 trajectory as a tensor on
    ``device``: one upload of each input and one K1 launch, which builds
    the banded system itself."""
    device = resolve_device(device)
    means = torch.tensor(np.asarray(features, np.float32), device=device)
    var = torch.tensor(np.asarray(variances, np.float32), device=device)
    if var.shape != (3 * int(feature_dim),):
        raise ValueError("variances must be (3*feature_dim,) = ({},), got "
                         "{}".format(3 * int(feature_dim), tuple(var.shape)))
    return cuda_mlpg.mlpg_utterance(means, var)


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
    l0, l1, l2 = cuda_mlpg.cholesky_banded_plain(*_banded_precision(var))
    factors = torch.stack([l0, l1, l2])
    tau = 1.0 / var
    return factors.to(device), tau.to(device)


def mlpg_solve(features, factors, tau, feature_dim):
    """MLPG with precomputed factors.

    features: (..., T, 3*feature_dim) window means; factors (3, T, D) and
    tau (T, 3, D) from :func:`mlpg_factorise`.  Returns (..., T, D).
    Leading dims fold into the batch of one
    :func:`~idiaptts_torch.ops.cuda_mlpg.mlpg_served` call (the column map
    the identity)."""
    T = features.shape[-2]
    D = int(feature_dim)
    means = features.reshape(-1, T, 3 * D).contiguous()
    colmap = torch.arange(3 * D, dtype=torch.int32, device=means.device)
    out = cuda_mlpg.mlpg_served(means, colmap, factors, tau)
    return out.reshape(features.shape[:-1] + (D,))
