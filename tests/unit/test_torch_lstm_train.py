"""Parity of the port's BiLSTM training ops (idiaptts_torch.ops.cuda_lstm:
the training-mode forward, the reverse-time backward and the autograd
functions) with the JAX package's Pallas kernels in interpret mode and
its custom VJPs.

On the CPU the port runs its kernels' plain versions.  Shapes are small:
Bp = 8 rows per direction, T <= 19, D = 64, F = 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import pallas_ctx, pallas_lstm
from idiaptts_torch.ops import cuda_lstm

Bp, D, F = 8, 64, 128
# Forward: float32 sums in another order, fed back through bf16-rounded h
# (see test_torch_lstm.REC_ATOL); gates and cells carry the same error.
# Measured 1.1e-5 (gates), 5.8e-6 (cells) and 2.7e-6 (h) on these inputs.
FWD_ATOL = 5e-5
# Gradients: the tolerance class of the JAX package's own kernel-vs-scan
# gradient test (test_pallas_lstm.py), and for bf16 residuals its
# bf16-vs-f32 one.
GRAD_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_TOL_BF16 = dict(rtol=5e-2, atol=2e-2)


def _layer_inputs(T, seed=0):
    rs = np.random.RandomState(seed)
    xin = (rs.randn(T, 2 * Bp, D) * 0.5).astype(np.float32)
    xin = np.array(jnp.asarray(xin).astype(jnp.bfloat16).astype(
        jnp.float32))
    wx = (rs.randn(2, D, 4 * F) * 0.05).astype(np.float32)
    wh_cat = (rs.randn(2 * F, 4 * F) * 0.02).astype(np.float32)
    b = (rs.randn(2, 4 * F) * 0.1).astype(np.float32)
    return xin, wx, wh_cat, b


def _jax(xin, wx, wh_cat, b):
    return (jnp.asarray(xin).astype(jnp.bfloat16), jnp.asarray(wx),
            jnp.asarray(wh_cat), jnp.asarray(b))


def _torch(xin, wx, wh_cat, b):
    return (torch.from_numpy(xin).to(torch.bfloat16), torch.from_numpy(wx),
            torch.from_numpy(wh_cat), torch.from_numpy(b))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not torch.is_tensor(x) else x.to(torch.float32).numpy()


@pytest.mark.parametrize("res_bf16", [False, True])
def test_train_recurrence_matches_pallas_interpret(res_bf16):
    T = 13
    rs = np.random.RandomState(1)
    xp = (rs.randn(T, 2 * Bp, 4 * F) * 0.1).astype(np.float32)
    wh_cat = (rs.randn(2 * F, 4 * F) * 0.02).astype(np.float32)
    ref = pallas_lstm._recurrence_train_tmajor(
        jnp.asarray(xp), jnp.asarray(wh_cat), res_bf16=res_bf16,
        interpret=True)
    got = cuda_lstm.bilstm_recurrence_train_tmajor(
        torch.from_numpy(xp), torch.from_numpy(wh_cat), res_bf16=res_bf16)
    rdt = torch.bfloat16 if res_bf16 else torch.float32
    assert got[1].dtype == rdt and got[2].dtype == rdt
    # bf16 residuals: one bf16 ulp of a value in (-1, 1) plus FWD_ATOL.
    res_atol = 2 ** -8 + FWD_ATOL if res_bf16 else FWD_ATOL
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(_f32(g), _f32(r), rtol=0,
                                   atol=FWD_ATOL if k == 0 else res_atol)
    # h is the inference recurrence's, bit for bit.
    h_inf = cuda_lstm.bilstm_recurrence_tmajor(torch.from_numpy(xp),
                                               torch.from_numpy(wh_cat))
    assert torch.equal(got[0], h_inf)


def test_train_layer_matches_pallas_interpret():
    """K7 = projection + training recurrence against
    ``_layer_train_tmajor``; the residuals obey the LSTM equations."""
    args = _layer_inputs(T=19)
    h_r, a_r, c_r = pallas_lstm._layer_train_tmajor(*_jax(*args),
                                                    interpret=True)
    xin, wx, wh_cat, b = _torch(*args)
    xp = cuda_lstm.bilstm_projection_tmajor(xin, wx, b)
    h, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh_cat)
    # A projection one bf16 ulp away (test_torch_lstm) moves a gate by
    # that much; measured 2e-4.
    for got, ref in ((h, h_r), (a, a_r), (c, c_r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=3e-3)
    i, f, g, o = a.split(F, dim=-1)
    cprev = torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    torch.testing.assert_close(f * cprev + i * g, c, rtol=0, atol=1e-6)
    torch.testing.assert_close(o * torch.tanh(c), h, rtol=0, atol=1e-6)


# (T, Bp, F): the module's shape, then the narrow widths the card's
# backward kernel takes (F = 64 of the quality-pin recipe; F = 80, a
# width that is not a multiple of 32, at Bp = 65 rows a direction).
@pytest.mark.parametrize("T,Bp_,F_,res_bf16", [
    (17, Bp, F, False), (17, Bp, F, True), (9, 3, 64, False),
    (9, 3, 64, True), (7, 65, 80, False), (7, 65, 80, True)],
    ids=["False", "True", "T9-Bp3-F64-False", "T9-Bp3-F64-True",
         "T7-Bp65-F80-False", "T7-Bp65-F80-True"])
def test_dz_backward_matches_pallas_interpret(T, Bp_, F_, res_bf16):
    """The plain reverse-time backward against ``_dz_bwd_tmajor`` on the
    same residuals and cotangent."""
    rs = np.random.RandomState(2)
    xp = jnp.asarray((rs.randn(T, 2 * Bp_, 4 * F_) * 0.3).astype(
        np.float32))
    wh_cat = (rs.randn(2 * F_, 4 * F_) * 0.05).astype(np.float32)
    gout = (rs.randn(T, 2 * Bp_, F_) * 0.1).astype(np.float32)
    _, a, c = pallas_lstm._recurrence_train_tmajor(
        xp, jnp.asarray(wh_cat), res_bf16=res_bf16, interpret=True)
    ref = pallas_lstm._dz_bwd_tmajor(a, c, jnp.asarray(gout),
                                     jnp.asarray(wh_cat), interpret=True)
    rdt = torch.bfloat16 if res_bf16 else torch.float32
    got = cuda_lstm.dz_bwd_tmajor(torch.from_numpy(_f32(a)).to(rdt),
                                  torch.from_numpy(_f32(c)).to(rdt),
                                  torch.from_numpy(gout),
                                  torch.from_numpy(wh_cat))
    assert got.dtype == torch.float32
    # Same inputs; dh is a float32 sum of exact bf16 products in another
    # order, so a dz at a bf16 rounding boundary may feed the next step
    # one bf16 ulp apart.  Measured 3.6e-6 (f32 residuals) and 6.9e-6
    # (bf16) on |dz| up to 0.22 at the module's shape; 2.6e-7 at F = 64
    # and 9.6e-7 at F = 80 on |dz| up to 0.15 and 0.18.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=3e-5)


def _loss_weights(T, seed=5):
    return (np.random.RandomState(seed).randn(T, 2 * Bp, F)
            .astype(np.float32))


@pytest.mark.parametrize("res_bf16", [False, True])
def test_layer_gradients_match_jax_custom_vjp(res_bf16):
    """BiLSTMLayerFn's dxin, dWx, dWh and db against jax.grad through
    ``bilstm_layer_tmajor`` (train-mode kernel forward and backward in
    interpret mode)."""
    T = 11
    args = _layer_inputs(T, seed=3)
    wgt = _loss_weights(T)

    def loss(*a):
        return jnp.sum(pallas_lstm.bilstm_layer_tmajor(*a) * wgt)

    with pallas_ctx.force_interpret():
        if res_bf16:
            with pallas_ctx.train_profile(bf16_residuals=True):
                ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*_jax(*args))
        else:
            ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*_jax(*args))
    leaves = [t.requires_grad_() for t in _torch(*args)]
    h = cuda_lstm.BiLSTMLayerFn.apply(*leaves, res_bf16)
    (h * torch.from_numpy(wgt)).sum().backward()
    tol = GRAD_TOL_BF16 if res_bf16 else GRAD_TOL
    assert leaves[0].grad.dtype == torch.bfloat16
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(_f32(leaf.grad), _f32(r), **tol)


@pytest.mark.parametrize("res_bf16", [False, True])
def test_recurrence_gradients_match_jax_custom_vjp(res_bf16):
    """BiLSTMRecurrenceFn's dxp and dWh against jax.grad through
    ``bilstm_recurrence_tmajor``."""
    T = 16
    rs = np.random.RandomState(4)
    xp = (rs.randn(T, 2 * Bp, 4 * F) * 0.1).astype(np.float32)
    wh_cat = (rs.randn(2 * F, 4 * F) * 0.02).astype(np.float32)
    wgt = _loss_weights(T, seed=6)

    def loss(x, w):
        return jnp.sum(pallas_lstm.bilstm_recurrence_tmajor(x, w) * wgt)

    with pallas_ctx.force_interpret():
        if res_bf16:
            with pallas_ctx.train_profile(bf16_residuals=True):
                ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp),
                                                     jnp.asarray(wh_cat))
        else:
            ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp),
                                                 jnp.asarray(wh_cat))
    x_t = torch.from_numpy(xp).requires_grad_()
    w_t = torch.from_numpy(wh_cat).requires_grad_()
    h = cuda_lstm.BiLSTMRecurrenceFn.apply(x_t, w_t, res_bf16)
    (h * torch.from_numpy(wgt)).sum().backward()
    tol = GRAD_TOL_BF16 if res_bf16 else GRAD_TOL
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(ref[0]), **tol)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(ref[1]), **tol)


def test_layer_gradients_match_autograd_of_the_plain_layer():
    """The hand backward against PyTorch autograd through the plain
    layer (scan_layer_tmajor), which rounds nothing but the forward's
    matmul operands: the backward's bf16 dz in the GEMMs and its float32
    carries are the difference.  Those roundings (2^-9 relative per term)
    add up over T*Bp terms that partly cancel, so the bound is relative
    to each gradient's largest entry: measured 5.0e-3 (dxin), 2.1e-3
    (dWx), 2.8e-3 (dWh), 1.9e-4 (db)."""
    T = 9
    args = _torch(*_layer_inputs(T, seed=7))
    wgt = torch.from_numpy(_loss_weights(T, seed=8))
    ours = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    (cuda_lstm.BiLSTMLayerFn.apply(*ours, False) * wgt).sum().backward()
    (cuda_lstm.scan_layer_tmajor(*plain) * wgt).sum().backward()
    for o, p in zip(ours, plain):
        scale = np.abs(_f32(p.grad)).max()
        assert np.abs(_f32(o.grad) - _f32(p.grad)).max() <= 2e-2 * scale


def test_cpu_training_takes_the_plain_path():
    args = [t.requires_grad_() for t in _torch(*_layer_inputs(5))]
    before = {k: cuda_lstm.__dict__[k].launches
              for k in ("PROJECTION", "RECURRENCE_TRAIN", "BACKWARD")}
    cuda_lstm.BiLSTMLayerFn.apply(*args, False).sum().backward()
    after = {k: cuda_lstm.__dict__[k].launches for k in before}
    assert after == before
    assert all(a.grad is not None for a in args)
