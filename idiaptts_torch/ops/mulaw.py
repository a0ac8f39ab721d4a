"""µ-law companding: the port's copy of ``idiaptts_tpu/ops/mulaw.py``.

Pure functions on numpy arrays (host) or torch tensors (any device); the
result has the input's kind.  ``mulaw_quantize`` gives int64 for numpy
and int32 for tensors, as the JAX package gives int64 for numpy and
int32 for device arrays.
"""

import math

import numpy as np
import torch


def mulaw(x, mu=255):
    mu = float(mu)
    if isinstance(x, torch.Tensor):
        return torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def inv_mulaw(y, mu=255):
    mu = float(mu)
    if isinstance(y, torch.Tensor):
        return torch.sign(y) * (1.0 / mu) * (
            torch.pow(1.0 + mu, y.abs()) - 1.0)
    return np.sign(y) * (1.0 / mu) * ((1.0 + mu) ** np.abs(y) - 1.0)


def mulaw_quantize(x, mu=255):
    """[-1, 1] float -> [0, mu] int."""
    y = mulaw(x, mu)
    q = (y + 1) / 2 * mu + 0.5
    if isinstance(q, torch.Tensor):
        return torch.floor(q).to(torch.int32)
    return np.floor(q).astype(np.int64)


def inv_mulaw_quantize(y, mu=255):
    """[0, mu] int -> [-1, 1] float."""
    if isinstance(y, torch.Tensor):
        x = 2.0 * y.to(torch.float32) / mu - 1.0
    else:
        x = 2.0 * np.asarray(y).astype(np.float32) / mu - 1.0
    return inv_mulaw(x, mu)
