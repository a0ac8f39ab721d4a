"""The hand CUDA kernels against their plain PyTorch versions, on the
card.  Skipped where CUDA is unavailable.

The port's GPU environment need not have JAX, which tests/conftest.py
imports, so run this file without the conftest:

    python -m pytest --noconftest -m cuda tests/unit/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from idiaptts_torch.models.wavenet import WaveNetWrapper
from idiaptts_torch.ops import cuda_lstm, cuda_mlpg, cuda_wavenet, dispatch
from idiaptts_torch.ops.mlpg import mlpg_factorise

pytestmark = pytest.mark.cuda

# Recurrence kernel vs plain recurrence, absolute on h in (-1, 1): float32
# sums in another order, and h enters the next step rounded to bf16, so a
# rare rounding flip moves a gate by one bf16 ulp of h times |w|.
REC_TOL = 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("T,L", [(1, 3), (5, 40), (64, 133), (512, 1056)])
def test_banded_solve_kernel_matches_plain(dev, T, L):
    var = np.random.RandomState(0).rand(66).astype(np.float32) + 0.05
    factors, _ = mlpg_factorise(var, 22, T, device=dev)
    reps = -(-L // 22)
    l0, l1, l2 = (factors[i].repeat(1, reps)[:, :L].contiguous()
                  for i in range(3))
    b = torch.randn(T, L, generator=_gen(dev), device=dev)
    before = cuda_mlpg.SOLVE.launches
    x = cuda_mlpg.solve_banded(b, l0, l1, l2)
    assert cuda_mlpg.SOLVE.launches == before + 1
    ref = cuda_mlpg.solve_banded_plain(b, l0, l1, l2)
    # Same operations; nvcc contracts multiply-subtract into FMAs.
    torch.testing.assert_close(x, ref, rtol=0,
                               atol=1e-5 * max(1.0, ref.abs().max().item()))


def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


@pytest.mark.parametrize("T,B,D,F", [(19, 2, 96, 128), (16, 8, 256, 128),
                                     (64, 3, 1024, 512)])
def test_projection_kernel_matches_plain(dev, T, B, D, F):
    g = _gen(dev, 1)
    xin = torch.randn(T, 2 * B, D, generator=g, device=dev).to(
        torch.bfloat16)
    wx = (torch.randn(2, D, 4 * F, generator=g, device=dev)
          / D ** 0.5).to(torch.bfloat16)
    zero = torch.zeros(2, 4 * F, device=dev)
    out = cuda_lstm.bilstm_projection_tmajor(xin, wx, zero)
    ref = cuda_lstm.projection_tmajor_plain(xin, wx, zero)
    diff = (out - ref).abs()
    # bf16 products of float32 sums in another order: one bf16 ulp at
    # most (1e-5 for sums cancelling to near zero), rarely.
    assert torch.all(diff <= _bf16_ulp(torch.maximum(out.abs(), ref.abs()))
                     + 1e-5)
    assert (diff > 0).float().mean().item() < 1e-2


@pytest.mark.parametrize("T,B,F", [(37, 3, 128), (8, 1, 256), (96, 9, 512),
                                   (64, 48, 512)])
def test_recurrence_kernel_matches_plain(dev, T, B, F):
    g = _gen(dev, 2)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F, generator=g, device=dev)
    wh = (torch.randn(2 * F, 4 * F, generator=g, device=dev)
          / F ** 0.5).to(torch.bfloat16)
    before = cuda_lstm.RECURRENCE.launches
    out = cuda_lstm.bilstm_recurrence_tmajor(xp, wh)
    assert cuda_lstm.RECURRENCE.launches == before + 1
    ref = cuda_lstm.recurrence_tmajor_plain(xp, wh)
    torch.testing.assert_close(out, ref, rtol=0, atol=REC_TOL)


def test_recurrence_kernel_refuses_unsupported_width(dev):
    xp = torch.zeros(4, 2, 4 * 96, device=dev)
    with pytest.raises(dispatch.KernelError):
        cuda_lstm.bilstm_recurrence_tmajor(xp, torch.zeros(192, 384,
                                                           device=dev))


def test_kernels_refuse_wrong_dtype(dev):
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_projection_tmajor(
            torch.zeros(4, 2, 8, device=dev), torch.zeros(2, 8, 16,
                                                          device=dev),
            torch.zeros(2, 16, device=dev))


@pytest.mark.parametrize("T,B,F,res_bf16", [(37, 3, 128, False),
                                            (19, 8, 256, True),
                                            (64, 32, 512, False),
                                            (48, 8, 512, True)])
def test_train_recurrence_kernel(dev, T, B, F, res_bf16):
    """The training instance returns the inference kernel's h bit for bit,
    and gates and cells within the recurrence tolerance of the plain
    version (bf16 residuals: plus one bf16 ulp of a value in (-1, 1))."""
    g = _gen(dev, 3)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F, generator=g, device=dev)
    wh = (torch.randn(2 * F, 4 * F, generator=g, device=dev)
          / F ** 0.5).to(torch.bfloat16)
    before = cuda_lstm.RECURRENCE_TRAIN.launches
    h, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh, res_bf16)
    assert cuda_lstm.RECURRENCE_TRAIN.launches == before + 1
    assert torch.equal(h, cuda_lstm.bilstm_recurrence_tmajor(xp, wh))
    h_p, a_p, c_p = cuda_lstm.recurrence_train_tmajor_plain(xp, wh,
                                                            res_bf16)
    tol = REC_TOL + (2 ** -8 if res_bf16 else 0.0)
    torch.testing.assert_close(h, h_p, rtol=0, atol=REC_TOL)
    torch.testing.assert_close(a.float(), a_p.float(), rtol=0, atol=tol)
    # Cells are not bounded by 1: one bf16 ulp relative.
    torch.testing.assert_close(c.float(), c_p.float(),
                               rtol=2 ** -8 if res_bf16 else 0, atol=tol)


@pytest.mark.parametrize("T,B,F,res_bf16", [(37, 3, 128, False),
                                            (19, 8, 256, True),
                                            (64, 32, 512, False),
                                            (48, 8, 512, True)])
def test_backward_kernel_matches_plain(dev, T, B, F, res_bf16):
    """dz of the reverse-time kernel against the plain backward on the
    same residuals: float32 sums in another order; a dz at a bf16
    rounding boundary feeds the next step one bf16 ulp apart."""
    g = _gen(dev, 4)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F, generator=g, device=dev)
    wh = (torch.randn(2 * F, 4 * F, generator=g, device=dev)
          / F ** 0.5).to(torch.bfloat16)
    _, a, c = cuda_lstm.recurrence_train_tmajor_plain(xp, wh, res_bf16)
    gout = 0.1 * torch.randn(T, 2 * B, F, generator=g, device=dev)
    before = cuda_lstm.BACKWARD.launches
    dz = cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
    assert cuda_lstm.BACKWARD.launches == before + 1
    ref = cuda_lstm.dz_bwd_tmajor_plain(a, c, gout, wh)
    torch.testing.assert_close(dz, ref, rtol=0,
                               atol=1e-3 * max(1.0, ref.abs().max().item()))


def test_layer_autograd_on_the_card_matches_plain_autograd(dev):
    """BiLSTMLayerFn (projection kernel, training recurrence, backward
    kernel, bf16 GEMMs) against autograd through the plain layer; bound
    relative to each gradient's largest entry, as the CPU test."""
    T, B, D, F = 24, 4, 256, 256
    g = _gen(dev, 5)
    args = [torch.randn(T, 2 * B, D, generator=g, device=dev).to(
                torch.bfloat16),
            torch.randn(2, D, 4 * F, generator=g, device=dev) / D ** 0.5,
            torch.randn(2 * F, 4 * F, generator=g, device=dev) / F ** 0.5,
            0.1 * torch.randn(2, 4 * F, generator=g, device=dev)]
    wgt = torch.randn(T, 2 * B, F, generator=g, device=dev)
    ours = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    (cuda_lstm.BiLSTMLayerFn.apply(*ours, False) * wgt).sum().backward()
    (cuda_lstm.scan_layer_tmajor(*plain) * wgt).sum().backward()
    for o, p in zip(ours, plain):
        scale = p.grad.float().abs().max().item()
        assert (o.grad.float() - p.grad.float()).abs().max().item() \
            <= 2e-2 * scale


# WaveNet sampler kernel vs its plain version: bf16 operands and float32
# sums in both, summed in other orders, so z (rounded to bf16) can land
# one bf16 ulp apart and move later logits; bound: 4 bf16 ulps (2**-6)
# of the logits' largest magnitude.
WAVENET_TOL = 2.0 ** -6


def _wavenet(dev, layers=4, C=23, out_channels=256, seed=0):
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                out_channels=out_channels,
                                num_layers=layers, num_stacks=2,
                                cond_channels=C)
    model = cfg.create_model(torch.Generator().manual_seed(seed)).to(dev)
    return model.sampler().weights


def _wavenet_inputs(dev, T, B, C=23, seed=0):
    g = _gen(dev, seed)
    cond = torch.randn(T, B, C, generator=g, device=dev)
    forced = torch.randint(0, 256, (T, B), generator=g, device=dev,
                           dtype=torch.int32)
    uniforms = torch.rand(T, B, generator=g, device=dev)
    return cond, forced, uniforms


@pytest.mark.parametrize("T,B,layers,C", [(1, 1, 2, 23), (70, 3, 4, 23),
                                          (200, 17, 6, 63), (40, 33, 4, 9)])
def test_wavenet_forced_logits_match_plain(dev, T, B, layers, C):
    w = _wavenet(dev, layers, C)
    cond, forced, _ = _wavenet_inputs(dev, T, B, C)
    before = cuda_wavenet.SAMPLER.launches
    s, logits = cuda_wavenet.sample(w, cond, forced=forced,
                                    want_logits=True)
    assert cuda_wavenet.SAMPLER.launches == before + 1
    assert torch.equal(s, forced)
    _, ref = cuda_wavenet.sample_plain(w, cond, forced=forced,
                                       want_logits=True)
    torch.testing.assert_close(logits, ref, rtol=0, atol=WAVENET_TOL
                               * ref.abs().max().item())


def test_wavenet_greedy_is_argmax_of_kernel_logits(dev):
    w = _wavenet(dev)
    cond, _, _ = _wavenet_inputs(dev, 50, 5)
    s, logits = cuda_wavenet.sample(w, cond, temperature=0.0,
                                    want_logits=True)
    assert torch.equal(s.long(), torch.argmax(logits, dim=-1))


@pytest.mark.parametrize("B", [1, 16, 20])
def test_wavenet_free_run_matches_plain_given_uniforms(dev, B):
    """Each kernel draw equals the plain draw from the plain version's
    logits on the kernel's own history, except where U lies within
    2 * the logits tolerance of a CDF boundary."""
    w = _wavenet(dev, seed=B)
    T = 120
    cond, _, u = _wavenet_inputs(dev, T, B, seed=B)
    s, _ = cuda_wavenet.sample(w, cond, uniforms=u)
    _, ref_logits = cuda_wavenet.sample_plain(w, cond, forced=s,
                                              want_logits=True)
    tol = 2 * WAVENET_TOL * ref_logits.abs().max().item()
    ref = cuda_wavenet.draw(ref_logits.reshape(T * B, -1), u.reshape(-1),
                            1.0, 256).reshape(T, B)
    margin = cuda_wavenet.cdf_margin(ref_logits.reshape(T * B, -1),
                                     u.reshape(-1)).reshape(T, B)
    assert torch.all((s == ref) | (margin <= tol))
    assert len(torch.unique(s)) > 5


def test_wavenet_never_draws_a_padding_class(dev):
    w = _wavenet(dev, out_channels=200)
    cond, _, _ = _wavenet_inputs(dev, 60, 4)
    top = torch.full((60, 4), 1.0 - 2.0 ** -24, device=dev)
    s, _ = cuda_wavenet.sample(w, cond, uniforms=top)
    assert int(s.max()) <= 199
    low, _ = cuda_wavenet.sample(w, cond, uniforms=torch.zeros_like(top))
    assert int(low.min()) == 0


def test_wavenet_kernel_refuses_unsupported_width(dev):
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",), num_layers=2,
                                residual_channels=32, cond_channels=8)
    w = cfg.create_model().to(dev).sampler().weights
    with pytest.raises(ValueError, match="built for"):
        cuda_wavenet.sample(w, torch.zeros(3, 1, 8, device=dev),
                            temperature=0.0)


def _mlpg_system(dev, T, L, seed=0):
    """A one-shot MLPG system as ``mlpg_torch`` assembles it: seeded
    window means and variances (1e11 delta variances on the boundary
    frames), assembled on the card."""
    from idiaptts_torch.ops import mlpg
    rs = np.random.RandomState(seed)
    var = mlpg._boundary_variances(
        (rs.rand(3 * L) * 0.5 + 0.05).astype(np.float32), L, T).to(dev)
    feats = torch.from_numpy(rs.randn(T, 3, L).astype(np.float32)).to(dev)
    bands, b = mlpg._banded_system(feats, var)
    return [b.contiguous()] + [a.contiguous() for a in bands]


# K1 against its plain version; the relative tolerance is the one
# chip_smoke.py holds it to.
MLPG_ONESHOT_TOL = 1e-5


@pytest.mark.parametrize("L", [1, 20, 60])
@pytest.mark.parametrize("T", [1, 2, 3, 512])
def test_mlpg_oneshot_kernel_matches_plain(dev, T, L):
    args = _mlpg_system(dev, T, L)
    before = cuda_mlpg.ONESHOT.launches
    x = cuda_mlpg.mlpg_oneshot(*args)
    torch.cuda.synchronize()
    assert cuda_mlpg.ONESHOT.launches == before + 1
    ref = cuda_mlpg.mlpg_oneshot_plain(*args)
    # The same float32 operations; nvcc contracts multiply-subtract into
    # FMAs, and the system's conditioning amplifies those few ulps.
    torch.testing.assert_close(
        x, ref, rtol=0, atol=MLPG_ONESHOT_TOL * ref.abs().max().item())


def test_mlpg_generation_launches_the_oneshot_kernel(dev):
    from idiaptts_torch.ops.mlpg import MLPG
    rs = np.random.RandomState(1)
    feats = rs.randn(300, 60).astype(np.float32)
    cov = np.diag((rs.rand(60) + 0.1).astype(np.float32))
    before = cuda_mlpg.ONESHOT.launches
    out = MLPG().generation(feats, cov, 20, device=dev)
    assert cuda_mlpg.ONESHOT.launches == before + 1
    ref = MLPG().generation(feats, cov, 20, device="cpu")
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=MLPG_ONESHOT_TOL * np.abs(ref).max())


def test_mlpg_oneshot_refuses_wrong_dtype(dev):
    args = [a.double() for a in _mlpg_system(dev, 8, 4)]
    with pytest.raises(ValueError, match="float32"):
        cuda_mlpg.mlpg_oneshot(*args)
