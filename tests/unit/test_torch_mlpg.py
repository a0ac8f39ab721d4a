"""Parity of the port's MLPG (idiaptts_torch.ops.mlpg, cuda_mlpg) with the
JAX package's (idiaptts_tpu.ops.mlpg, pallas_mlpg).

On the CPU the port runs the banded solve's plain version; the JAX side
runs its scan oracle ``_solve_banded`` and the Pallas kernel in interpret
mode.  Inputs come from numpy with a fixed seed.
"""

import os

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


# -- the served MLPG in one launch (K2's fused mode) and its chunked scheme --

FIXTURE_STATS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, "fixtures",
    "WORLD", "cmp_mcep20", "{}-mean-covariance.npz")


def _fixture_variances():
    """The serving pipeline's fused MLPG variances (20 mcep + lf0 + bap,
    [statics | deltas | delta-deltas]) from the fixture corpus's
    covariance diagonals, as chip_smoke.py:load_corpus reads them."""
    def diag(name):
        with np.load(FIXTURE_STATS.format(name)) as f:
            return np.diagonal(f["covariance"]).astype(np.float32)
    sp, lf0, bap = diag("mcep20"), diag("lf0"), diag("bap")
    n, nb = 20, bap.shape[0] // 3
    return np.concatenate([
        sp[:n], lf0[:1], bap[:nb], sp[n:2 * n], lf0[1:2], bap[nb:2 * nb],
        sp[2 * n:], lf0[2:], bap[2 * nb:]]), n + 1 + nb


def _model_output(B, T, seed):
    """A (B, T, C) model output whose columns hold the window means in a
    seeded order with spare columns between them, and the column map of
    the (B, T, 3D) means."""
    rs = np.random.RandomState(seed)
    C = 3 * D + 5
    colmap = rs.permutation(C)[:3 * D].astype(np.int32)
    return rs.randn(B, T, C).astype(np.float32), colmap


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 2, 5, 13, 64])
def test_mlpg_served_plain_matches_jax(T, B):
    out, colmap = _model_output(B, T, seed=10 * T + B)
    factors_j, tau_j = _jax_factors(T)
    factors_t, tau_t = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                                   device="cpu")
    ref = np.asarray(jax_mlpg.mlpg_solve(jnp.asarray(out[..., colmap]),
                                         factors_j, tau_j, D))
    got = cuda_mlpg.mlpg_served(torch.from_numpy(out),
                                torch.from_numpy(colmap), factors_t,
                                tau_t).numpy()
    assert got.shape == (B, T, D)
    # The same float32 system; factors a few ulps apart (as in
    # test_mlpg_solve_batched_matches_jax), carried through 2T steps:
    # measured at most 5.9e-7 of the largest |x|.
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_mlpg_served_plain_is_mlpg_solve_on_the_gathered_means():
    """The column map replaces the gathered copy: bit for bit."""
    T, B = 21, 3
    out, colmap = _model_output(B, T, seed=5)
    factors, tau = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                             device="cpu")
    got = cuda_mlpg.mlpg_served(torch.from_numpy(out),
                                torch.from_numpy(colmap), factors, tau)
    want = torch_mlpg.mlpg_solve(torch.from_numpy(out[..., colmap]),
                                 factors, tau, D)
    assert torch.equal(got, want)


# T = 1, 2 and 5 lie inside one chunk of 16 (and 1-31 inside one of 64);
# 31, 517 leave a ragged last chunk at 16 rows, 7 rows one at every T > 2.
# 4097 and 16640 pass the 256 chunks of 16 rows a block holds, so the
# kernel walks them as 2 and 5 super-chunks: the carries cross 257 and
# 1040 chunks.
@pytest.mark.parametrize("rows", [16, 7, 64])
@pytest.mark.parametrize("T", [1, 2, 5, 31, 64, 517, 2048, 4097, 16640])
def test_chunked_model_matches_sequential(T, rows):
    """K2's scheme (chunks from zero carries, unit-carry responses, the
    carries walked across the chunks, the chunks again) against the
    sequential substitutions, on the fixture variances with the 1e11
    boundary rows, and against the float64 solve."""
    var, n_feat = _fixture_variances()
    factors, _ = torch_mlpg.mlpg_factorise(var, n_feat, T, device="cpu")
    L = 2 * n_feat
    l0, l1, l2 = (factors[i].repeat(1, 2) for i in range(3))
    b = torch.from_numpy(np.random.RandomState(T).randn(T, L)
                         .astype(np.float32))
    seq = cuda_mlpg.solve_banded_plain(b, l0, l1, l2)
    got = cuda_mlpg.solve_banded_chunked(b, l0, l1, l2, rows=rows)
    truth = cuda_mlpg.solve_banded_plain(
        *(a.double() for a in (b, l0, l1, l2))).numpy()
    top = np.abs(truth).max()
    # Measured at most 9.1e-7 of the largest |x| against the sequential
    # float32 solve and 7.3e-7 against float64, over these cases.
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                               atol=5e-6 * top)
    np.testing.assert_allclose(got.numpy(), truth, rtol=0, atol=5e-6 * top)


@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_carry_responses_stay_bounded(sweep):
    """The responses to a unit carry, which phase (b) composes across the
    chunks, do not grow over a chunk on the fixture variances at T = 2048
    with the 1e11 boundary rows (measured at most 1.53)."""
    var, n_feat = _fixture_variances()
    T, R = 2048, cuda_mlpg.SOLVE_ROWS
    l0, l1, l2 = torch_mlpg.mlpg_factorise(var, n_feat, T, device="cpu")[0]
    P = T // R
    if sweep == "forward":
        def rows(a, k):
            return torch.cat([a.new_zeros(k, n_feat), a[:T - k]]) \
                .reshape(P, R, n_feat)
        inv, s1, s2 = rows(1.0 / l0, 0), rows(l1, 1), rows(l2, 2)
    else:
        def rows(a):
            return torch.flip(a, [0]).reshape(P, R, n_feat)
        inv, s1, s2 = rows(1.0 / l0), rows(l1), rows(l2)
    zero, one = torch.zeros(P, n_feat), torch.ones(P, n_feat)
    rhs = torch.zeros(P, R, n_feat)
    for carry in ((one, zero), (zero, one)):
        resp = cuda_mlpg._chunk_sweep(rhs, inv, s1, s2, carry)
        assert torch.isfinite(resp).all()
        assert resp.abs().max().item() <= 2.0


def test_mlpg_served_cpu_tensors_take_the_plain_path():
    T, B = 6, 2
    out, colmap = _model_output(B, T, seed=1)
    factors, tau = torch_mlpg.mlpg_factorise(_variances(), D, T,
                                             device="cpu")
    args = (torch.from_numpy(out), torch.from_numpy(colmap), factors, tau)
    before = cuda_mlpg.SOLVE.launches
    got = cuda_mlpg.mlpg_served(*args)
    assert cuda_mlpg.SOLVE.launches == before
    assert torch.equal(got, cuda_mlpg.mlpg_served_plain(*args))
