"""Parity of the port's one-shot MLPG (``MLPG.generation`` ->
``mlpg_torch`` -> ``cuda_mlpg.mlpg_oneshot``, whose CPU path is the plain
version of the K1 kernel) with the JAX package's ``MLPG().generation``.

On the CPU the JAX front door runs ``mlpg_jax`` (its scan path): the
Pallas kernel ``mlpg_pallas`` does not run in interpret mode on this jax
version (tests/unit/test_mlpg.py skips it), so ``mlpg_jax`` is the JAX
reference and ``mlpg_numpy`` (scipy, float64) the truth.  Inputs come
from numpy with a fixed seed.
"""

import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import mlpg as jax_mlpg
from idiaptts_torch.ops import cuda_mlpg, dispatch
from idiaptts_torch.ops import mlpg as torch_mlpg


def _system(T, D, seed=0):
    rs = np.random.RandomState(seed)
    var = (rs.rand(3 * D) * 0.5 + 0.05).astype(np.float32)
    feats = rs.randn(T, 3 * D).astype(np.float32)
    return feats, np.diag(var), var


# T = 1 and 2 exercise the zero carries (the TPU kernel needs T >= 3).
@pytest.mark.parametrize("D", [1, 4, 20])
@pytest.mark.parametrize("T", [1, 2, 3, 64, 487])
def test_generation_matches_jax_and_float64(T, D):
    feats, cov, var = _system(T, D)
    out = torch_mlpg.MLPG().generation(feats, cov, D, device="cpu")
    ref_jax = np.asarray(jax_mlpg.MLPG().generation(feats, cov, D))
    truth = jax_mlpg.mlpg_numpy(feats, cov, D)
    assert out.shape == (T, D) and out.dtype == np.float32
    # float32 recurrences of 2T steps on both sides; measured 1.1e-6 of
    # the largest value against mlpg_jax and 1.5e-6 against float64.
    top = np.abs(truth).max()
    np.testing.assert_allclose(out, ref_jax, rtol=0, atol=5e-6 * top)
    np.testing.assert_allclose(out, truth, rtol=0, atol=5e-6 * top)
    # The one-shot path computes the same float32 operations in the same
    # order as the batch path (factorise once, then substitute).
    factors, tau = torch_mlpg.mlpg_factorise(var, D, T, device="cpu")
    batch = torch_mlpg.mlpg_solve(torch.from_numpy(feats), factors, tau, D)
    np.testing.assert_array_equal(out, batch.numpy())


@pytest.mark.parametrize("T,D", [(1, 1), (5, 4), (64, 20)])
def test_numpy_backend_matches_jax_numpy(T, D):
    feats, cov, _ = _system(T, D, seed=T)
    out = torch_mlpg.MLPG().generation(feats, cov, D, backend="numpy")
    ref = jax_mlpg.mlpg_numpy(feats, cov, D)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)


def test_banded_system_matches_jax():
    """The system assembled on the device (the role of
    ``_banded_system_jnp``) against the float64 host assembly."""
    T, D = 37, 6
    feats, cov, _ = _system(T, D, seed=2)
    var = jax_mlpg._window_variances(cov, D, T)
    ab_ref, b_ref = jax_mlpg._banded_precision_and_b(
        feats.astype(np.float64).reshape(T, 3, D), var)
    bands, b = torch_mlpg._banded_system(
        torch.from_numpy(feats.reshape(T, 3, D)),
        torch.from_numpy(var.astype(np.float32)))
    for got, ref in zip(bands + [b], list(ab_ref) + [b_ref]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())


def test_cpu_tensors_take_the_plain_path():
    T, L = 9, 5
    rs = np.random.RandomState(4)
    b = torch.from_numpy(rs.randn(T, L).astype(np.float32))
    bands = torch_mlpg._banded_precision(torch.from_numpy(
        (rs.rand(T, 3, L) + 0.1).astype(np.float32)))
    before = cuda_mlpg.ONESHOT.launches
    x = cuda_mlpg.mlpg_oneshot(b, *bands)
    assert cuda_mlpg.ONESHOT.launches == before
    torch.testing.assert_close(x, cuda_mlpg.mlpg_oneshot_plain(b, *bands),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        dispatch.use_kernel(b, torch.zeros(T, L, device="meta"))


def test_unknown_backend_raises():
    feats, cov, _ = _system(4, 1)
    with pytest.raises(ValueError, match="backend"):
        torch_mlpg.MLPG().generation(feats, cov, 1, backend="jax")
