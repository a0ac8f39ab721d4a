"""Frame -> sample-rate upsampling of conditioning features: the port's
copy of ``sample_linearly`` from ``idiaptts_tpu/ops/interpolation.py``
(numpy, on the host)."""

import numpy as np


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
    out = sample[lo] * (1.0 - frac) + sample[hi] * frac
    return out.astype(dtype)
