"""Maximum-probability parameter generation (MLPG) trajectory smoothing.

Port of ``idiaptts_tpu/ops/mlpg.py``'s batch path: the banded precision
matrix depends only on the variances and the frame count, so
:func:`mlpg_factorise` runs the bandwidth-2 Cholesky once per length
bucket, and :func:`mlpg_solve` runs only the two substitutions per
batch, with batch x feature folded into the lanes of one
:func:`~idiaptts_torch.ops.cuda_mlpg.solve_banded` call.

Windows ``(1)``, ``(-0.5, 0, 0.5)``, ``(1, -2, 1)`` and the 1e11
boundary variances on the delta windows are the reference's.
"""

import numpy as np
import torch

from idiaptts_torch.ops.cuda_mlpg import solve_banded
from idiaptts_torch.ops.dispatch import resolve_device

_WINDOWS = (
    np.array([0.0, 1.0, 0.0]),        # static
    np.array([-0.5, 0.0, 0.5]),       # delta (np.gradient convention)
    np.array([1.0, -2.0, 1.0]),       # delta-delta
)
_BOUNDARY_VAR = 1e11


def _shift(x, k):
    """x[..., t, :] -> x[..., t - k, :] along the time axis (-2), zero
    filled."""
    if k == 0:
        return x
    zeros = torch.zeros_like(x[..., :abs(k), :])
    if k > 0:
        return torch.cat([zeros, x[..., :-k, :]], dim=-2)
    return torch.cat([x[..., -k:, :], zeros], dim=-2)


def _banded_precision(variances):
    """Lower-banded pentadiagonal precision rows (ab0, ab1, ab2), each
    (T, D), from per-frame window variances (T, 3, D) (the role of
    ``_banded_system_jnp`` without the b vector)."""
    T, _, D = variances.shape
    tau = 1.0 / variances
    bands = [torch.zeros(T, D, dtype=tau.dtype) for _ in range(3)]
    idx = torch.arange(T)
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


def _cholesky_banded(a0, a1, a2):
    """Bandwidth-2 banded Cholesky (the role of ``_cholesky_banded_scan``):
    a0/a1/a2 (T, D) lower-banded SPD rows -> l0, l1, l2 (T, D) with
    L[t, t] = l0[t], L[t+1, t] = l1[t], L[t+2, t] = l2[t].  A plain loop:
    it runs once per length bucket."""
    T, D = a0.shape
    l0 = torch.empty_like(a0)
    l1 = torch.empty_like(a0)
    l2 = torch.empty_like(a0)
    zero = torch.zeros(D, dtype=a0.dtype)
    l1_pm1, l2_pm1, l2_pm2 = zero, zero, zero
    for t in range(T):
        l0t = torch.sqrt(torch.clamp(a0[t] - l1_pm1 ** 2 - l2_pm2 ** 2,
                                     min=1e-20))
        l1t = (a1[t] - l1_pm1 * l2_pm1) / l0t
        l2t = a2[t] / l0t
        l0[t], l1[t], l2[t] = l0t, l1t, l2t
        l2_pm2 = l2_pm1
        l1_pm1, l2_pm1 = l1t, l2t
    return l0, l1, l2


def mlpg_factorise(variances, feature_dim, num_frames, device="cuda"):
    """Banded Cholesky factors for ``num_frames`` frames.

    variances: (3*feature_dim,) diagonal variances [static | delta |
    delta-delta].  Returns ``(factors (3, T, D), tau (T, 3, D))`` as
    float32 tensors on ``device`` (the card unless ``device="cpu"``;
    raises without CUDA).  Computed on the CPU in float32 (the
    reference's precision), then moved."""
    device = resolve_device(device)
    T, D = int(num_frames), int(feature_dim)
    var_row = torch.as_tensor(np.asarray(variances, np.float32)).reshape(
        3, D)
    var = var_row[None].expand(T, 3, D).clone()
    var[0, 1:, :] = _BOUNDARY_VAR
    var[-1, 1:, :] = _BOUNDARY_VAR
    l0, l1, l2 = _cholesky_banded(*_banded_precision(var))
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
    btau = feats * tau
    b = torch.zeros(feats.shape[:-2] + (D,), dtype=feats.dtype,
                    device=feats.device)
    for w, coeff in enumerate(_WINDOWS):
        for k in (-1, 0, 1):
            if coeff[k + 1] != 0.0:
                b = b + float(coeff[k + 1]) * _shift(btau[..., w, :], k)
    flat = b.reshape(-1, T, D)
    B = flat.shape[0]
    lanes = flat.permute(1, 0, 2).reshape(T, B * D).contiguous()
    l0, l1, l2 = (factors[i].repeat(1, B).contiguous() for i in range(3))
    solved = solve_banded(lanes, l0, l1, l2)
    return solved.reshape(T, B, D).permute(1, 0, 2).reshape(b.shape)
