"""Parity of the port's MLPG (idiaptts_torch.ops.mlpg, cuda_mlpg) with the
JAX package's (idiaptts_tpu.ops.mlpg, pallas_mlpg).

On the CPU the port runs the banded solve's plain version; the JAX side
runs its scan oracle ``_solve_banded`` and the Pallas kernel in interpret
mode.  Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import mlpg as jax_mlpg
from idiaptts_tpu.ops.pallas_mlpg import solve_banded_pallas
from idiaptts_torch.ops import cuda_mlpg, dispatch
from idiaptts_torch.ops import mlpg as torch_mlpg

D = 22          # fused MLPG feature dim of the serving path (20 + 1 + 1)


def _variances(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(3 * D) * 0.5 + 0.05).astype(np.float32)


def _jax_factors(T):
    return jax_mlpg.mlpg_factorise(jnp.asarray(_variances()), D, T)


# T < 3, T < 8 and T not a multiple of 8 exercise the zero-carry boundary.
@pytest.mark.parametrize("T", [1, 2, 5, 13, 64])
def test_mlpg_factorise_matches_jax(T):
    factors_j, tau_j = _jax_factors(T)
    factors_t, tau_t = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                                   device="cpu")
    assert factors_t.shape == (3, T, D) and tau_t.shape == (T, 3, D)
    # Same float32 operations in the same order (sqrt, divide); the
    # banded precision sums differ only in association: a few ulps.
    np.testing.assert_allclose(factors_t.numpy(), np.asarray(factors_j),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tau_t.numpy(), np.asarray(tau_j))


@pytest.mark.parametrize("T", [1, 2, 5, 13, 64])
def test_solve_banded_plain_matches_jax(T):
    factors, _ = _jax_factors(T)
    rs = np.random.RandomState(T)
    L = 40                                      # lanes not a multiple of 128
    b = rs.randn(T, L).astype(np.float32)
    l0, l1, l2 = (np.tile(np.asarray(factors[i]), (1, 2))[:, :L]
                  for i in range(3))
    x_scan = np.asarray(jax_mlpg._solve_banded(
        jnp.asarray(l0), jnp.asarray(l1), jnp.asarray(l2), jnp.asarray(b)))
    x_pallas = np.asarray(solve_banded_pallas(
        jnp.asarray(b), jnp.asarray(l0), jnp.asarray(l1), jnp.asarray(l2),
        interpret=True))
    x = cuda_mlpg.solve_banded(*(torch.from_numpy(a)
                                 for a in (b, l0, l1, l2))).numpy()
    # Float32 recurrences of 2T steps; the scan divides like the port,
    # the Pallas kernel multiplies by 1/l0 (about one ulp per step).
    tol = 1e-6 * max(1.0, np.abs(x_scan).max())
    np.testing.assert_allclose(x, x_scan, rtol=0, atol=tol)
    np.testing.assert_allclose(x, x_pallas, rtol=0, atol=tol)


@pytest.mark.parametrize("T", [5, 13, 64])
def test_mlpg_solve_batched_matches_jax(T):
    factors_j, tau_j = _jax_factors(T)
    factors_t, tau_t = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                                   device="cpu")
    feats = np.random.RandomState(7).randn(3, T, 3 * D).astype(np.float32)
    out_j = np.asarray(jax_mlpg.mlpg_solve(jnp.asarray(feats), factors_j,
                                           tau_j, D))
    out_t = torch_mlpg.mlpg_solve(torch.from_numpy(feats), factors_t,
                                  tau_t, D).numpy()
    assert out_t.shape == (3, T, D)
    # Batch x feature folded into (T, 3*22) lanes on both sides; factors
    # agree to a few ulps and the solve carries them through.
    np.testing.assert_allclose(out_t, out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())


def test_mlpg_solve_matches_dense_numpy_reference():
    """Against the reference's dense float64 solve (scipy solveh_banded),
    independently of the JAX package."""
    T = 37
    var = _variances()
    feats = np.random.RandomState(3).randn(T, 3 * D).astype(np.float32)
    ref = jax_mlpg.mlpg_numpy(feats, np.diag(var), D)
    factors, tau = torch_mlpg.mlpg_factorise(var, D, T, device="cpu")
    out = torch_mlpg.mlpg_solve(torch.from_numpy(feats), factors, tau,
                                D).numpy()
    # float32 vs float64 on a well-conditioned pentadiagonal system.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_cpu_tensors_take_the_plain_path():
    T, L = 9, 5
    factors, _ = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                                   device="cpu")
    l0, l1, l2 = (factors[i, :, :L].contiguous() for i in range(3))
    b = torch.randn(T, L, generator=torch.Generator().manual_seed(0))
    before = cuda_mlpg.SOLVE.launches
    x = cuda_mlpg.solve_banded(b, l0, l1, l2)
    assert cuda_mlpg.SOLVE.launches == before
    torch.testing.assert_close(x, cuda_mlpg.solve_banded_plain(b, l0, l1,
                                                               l2))


def test_mixed_devices_raise():
    cpu = torch.zeros(2, 2)
    with pytest.raises(ValueError):
        dispatch.use_kernel(cpu, torch.zeros(2, 2, device="meta"))
