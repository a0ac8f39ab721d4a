"""Parity of the port's BiLSTM layer ops (idiaptts_torch.ops.cuda_lstm)
with the JAX package's (idiaptts_tpu.ops.pallas_lstm).

On the CPU the port runs the plain versions of its kernels; the JAX side
runs its scan oracles (``bilstm_recurrence_scan``, ``_scan_layer_tmajor``)
and the Pallas kernels in interpret mode.  Shapes are those of
``test_pallas_lstm.py``, unaligned batch and time included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import pallas_lstm
from idiaptts_torch.ops import cuda_lstm

# Recurrence: the port and the reference both feed h to the matmul rounded
# to bf16 and accumulate in float32, in another order.  A float32
# difference in h can flip that rounding, which moves one gate by one bf16
# ulp of h times |w|; measured at most 5.2e-6 on these inputs (the JAX
# kernel itself is 2.2e-6 from its scan, ROADMAP fault 3.1).
REC_ATOL = 2e-5


def _rand_recurrence(B, T, F, seed=0):
    rs = np.random.RandomState(seed)
    x_proj = rs.randn(2, B, T, 4 * F).astype(np.float32) * 0.1
    wh = rs.randn(2, F, 4 * F).astype(np.float32) * 0.02
    return x_proj, wh


@pytest.mark.parametrize("B,T,F", [(3, 37, 128), (1, 8, 256), (9, 96, 128),
                                   (5, 23, 64)])
def test_recurrence_plain_matches_jax_scan(B, T, F):
    x_proj, wh = _rand_recurrence(B, T, F)
    ref = np.asarray(pallas_lstm.bilstm_recurrence_scan(
        jnp.asarray(x_proj), jnp.asarray(wh)))
    out = cuda_lstm.bilstm_recurrence_scan(torch.from_numpy(x_proj),
                                           torch.from_numpy(wh)).numpy()
    assert out.shape == (2, B, T, F)
    np.testing.assert_allclose(out, ref, rtol=0, atol=REC_ATOL)


@pytest.mark.parametrize("B,T,F", [(3, 37, 128), (1, 8, 256), (2, 19, 64)])
def test_recurrence_tmajor_matches_pallas_interpret(B, T, F):
    x_proj, wh = _rand_recurrence(B, T, F, seed=1)
    ref = np.asarray(pallas_lstm.bilstm_recurrence_pallas(
        jnp.asarray(x_proj), jnp.asarray(wh), interpret=True))
    # The time-major entry point on the JAX package's row layout.
    xp_t = torch.from_numpy(x_proj).permute(2, 0, 1, 3).reshape(
        T, 2 * B, 4 * F).contiguous()
    wh_cat = torch.cat([torch.from_numpy(wh[0]), torch.from_numpy(wh[1])])
    out = cuda_lstm.bilstm_recurrence_tmajor(xp_t, wh_cat)
    out = out.reshape(T, 2, B, F).permute(1, 2, 0, 3).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=REC_ATOL)


def _layer_inputs(B, T, D, F, seed=3):
    rs = np.random.RandomState(seed)
    Bp = -(-B // 8) * 8                       # the JAX layout's row padding
    xin = jnp.asarray(rs.randn(T, 2 * Bp, D).astype(np.float32)
                      * 0.3).astype(jnp.bfloat16)
    wx = rs.randn(2, D, 4 * F).astype(np.float32) * 0.05
    wh_cat = rs.randn(2 * F, 4 * F).astype(np.float32) * 0.02
    b = rs.randn(2, 4 * F).astype(np.float32) * 0.1
    xin_t = torch.from_numpy(np.array(xin.astype(jnp.float32))).to(
        torch.bfloat16)
    return (xin, jnp.asarray(wx), jnp.asarray(wh_cat), jnp.asarray(b)), \
        (xin_t, torch.from_numpy(wx), torch.from_numpy(wh_cat),
         torch.from_numpy(b))


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("B,T,D,F", [(2, 19, 96, 128), (8, 16, 256, 128),
                                     (3, 11, 409, 128)])
def test_projection_rounds_like_jax(B, T, D, F):
    """bf16(x . Wx) + b: both sides accumulate in float32 and round to
    bf16, in another summation order, so a product at a rounding midpoint
    may land one bf16 ulp away; that must be rare and never more."""
    (xin, wx, _, b), (xin_t, wx_t, _, b_t) = _layer_inputs(B, T, D, F)
    Tn, R, _ = xin.shape
    xd = jnp.transpose(xin.reshape(Tn, 2, R // 2, D), (1, 2, 0, 3))
    prod = jnp.einsum("dbtc,dcg->dbtg", xd, wx.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    prod = prod.astype(jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(jnp.transpose(prod, (2, 0, 1, 3)).reshape(Tn, R, -1))
    out = cuda_lstm.bilstm_projection_tmajor(
        xin_t, wx_t, torch.zeros_like(b_t)).numpy()
    diff = np.abs(out - ref)
    # 1e-6 absolute covers sums that cancel to near zero.
    assert np.all(diff <= _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))
                  + 1e-6)
    assert np.mean(diff > 0) < 1e-3
    with_bias = cuda_lstm.bilstm_projection_tmajor(xin_t, wx_t, b_t)
    rows_b = b_t[:, None, :].expand(2, R // 2, 4 * F).reshape(R, 4 * F)
    torch.testing.assert_close(with_bias, torch.from_numpy(out) + rows_b,
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,T,D,F", [(2, 19, 96, 128), (8, 16, 256, 128),
                                     (3, 11, 409, 128)])
def test_layer_plain_matches_jax(B, T, D, F):
    jax_args, torch_args = _layer_inputs(B, T, D, F)
    ref_scan = np.asarray(pallas_lstm._scan_layer_tmajor(*jax_args))
    ref_kernel = np.asarray(pallas_lstm._layer_tmajor(*jax_args,
                                                      interpret=True))
    out = cuda_lstm.bilstm_layer_tmajor(*torch_args).numpy()
    assert out.shape == ref_scan.shape
    # On top of REC_ATOL: a projection one bf16 ulp away (see
    # test_projection_rounds_like_jax; up to 2^-7 * max|xp| = 1e-2 here)
    # moves one gate pre-activation by that much and h by a fraction of
    # it (gate slopes <= 1, scaled by the other gates < 1).  Measured
    # 2.3e-4.
    for ref in (ref_scan, ref_kernel):
        np.testing.assert_allclose(out, ref, rtol=0, atol=3e-3)


def test_state_carries_over_all_steps():
    """Constant input with zero recurrent weights: the cell integrates a
    constant, so h rises strictly at every step."""
    B, T, F = 2, 40, 128
    xp_t = torch.full((T, 2 * B, 4 * F), 0.5)
    out = cuda_lstm.bilstm_recurrence_tmajor(xp_t, torch.zeros(2 * F, 4 * F))
    assert torch.all(torch.diff(out[:, 0, 0]) > 0)


def test_cpu_tensors_take_the_plain_path():
    (_, _, _, _), args = _layer_inputs(2, 5, 32, 128)
    before = (cuda_lstm.PROJECTION.launches, cuda_lstm.RECURRENCE.launches)
    out = cuda_lstm.bilstm_layer_tmajor(*args)
    assert (cuda_lstm.PROJECTION.launches,
            cuda_lstm.RECURRENCE.launches) == before
    torch.testing.assert_close(out, cuda_lstm.scan_layer_tmajor(*args),
                               rtol=0, atol=0)
