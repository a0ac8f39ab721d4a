"""The hand CUDA kernels against their plain PyTorch versions, on the
card.  Skipped where CUDA is unavailable.

The port's GPU environment need not have JAX, which tests/conftest.py
imports, so run this file without the conftest:

    python -m pytest --noconftest -m cuda tests/unit/test_torch_cuda_kernels.py
"""

import os

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


# 4097 and 16640 pass the 4096 rows a block holds: 2 and 5 super-chunks.
@pytest.mark.parametrize("T,L", [(1, 3), (2, 40), (3, 40), (5, 40), (64, 133),
                                 (512, 1056), (2048, 1056), (4097, 40),
                                 (16640, 44)])
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
    # Same recurrences, in chunks of 16 rows, with FMAs and a multiply by
    # the rounded 1/l0 in place of the divide.
    torch.testing.assert_close(x, ref, rtol=0,
                               atol=1e-5 * max(1.0, ref.abs().max().item()))


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "fixtures", "WORLD", "cmp_mcep20")


def _stream_variances(name):
    with np.load(os.path.join(FIXTURES, name + "-mean-covariance.npz")) as f:
        return np.diagonal(f["covariance"]).astype(np.float32)


def _served_inputs(dev, B, T, seed=0):
    """A served batch as FusedAcousticPipeline.mlpg_stage sees it: a
    seeded (B, T, 67) model output, the pipeline's column map and the
    bucket's factor from the fixture variances."""
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    variances = {k: _stream_variances(n) for k, n in (
        ("sp", "mcep20"), ("lf0", "lf0"), ("bap", "bap"))}
    pipe = FusedAcousticPipeline(None, variances, 20, device=dev)
    factors, tau = pipe.factors_for(T)
    out = torch.randn(B, T, 67, generator=_gen(dev, seed), device=dev)
    return out, pipe._colmap, factors, tau


@pytest.mark.parametrize("B,T", [(1, 1), (1, 2), (3, 3), (6, 512),
                                 (48, 512), (48, 2048), (2, 16640)])
def test_mlpg_served_kernel_matches_plain(dev, B, T):
    args = _served_inputs(dev, B, T)
    before = cuda_mlpg.SOLVE.launches
    x = cuda_mlpg.mlpg_served(*args)
    torch.cuda.synchronize()
    assert cuda_mlpg.SOLVE.launches == before + 1
    ref = cuda_mlpg.mlpg_served_plain(*args)
    assert x.shape == ref.shape == (B, T, 22)
    # The right-hand side assembled in the same float32 order; the
    # substitutions as in test_banded_solve_kernel_matches_plain.
    torch.testing.assert_close(x, ref, rtol=0,
                               atol=1e-5 * max(1.0, ref.abs().max().item()))


def test_mlpg_served_refuses_what_it_does_not_take(dev):
    out, colmap, factors, tau = _served_inputs(dev, 2, 8)
    with pytest.raises(ValueError, match="int32"):
        cuda_mlpg.mlpg_served(out, colmap.long(), factors, tau)
    with pytest.raises(ValueError, match="float32"):
        cuda_mlpg.mlpg_served(out.double(), colmap, factors, tau)
    with pytest.raises(ValueError, match="shape"):
        cuda_mlpg.mlpg_served(out, colmap, factors[:, :4], tau)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mlpg.mlpg_served(out.transpose(0, 1).contiguous()
                              .transpose(0, 1), colmap, factors, tau)


def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


# The projection kernel's tile is 128 rows (BT steps of BR rows, BR a
# divisor of Bp, or 128 rows of one step when Bp > 128) by 256 columns,
# 64 deep a stage.  These shapes hit every edge: Bp from 1 to 200 (the
# 128 rows as 1 x 128, 2 x 64, 8 x 16, 16 x 8 and 64 x 2 rows x steps;
# Bp = 131 and 200 split into 128 rows and the rest), a partial last
# step tile, N = 4F with F = 72 and
# 96 (column tiles of 32 and 128 of 256 columns, whole TMA boxes past
# N), K not a multiple of 64, and K = 409 (padded to 416 by the
# wrapper).
@pytest.mark.parametrize("T,B,D,F", [
    (19, 2, 96, 128), (16, 8, 256, 128), (64, 3, 1024, 512),
    (37, 1, 1000, 96), (37, 7, 1000, 96), (50, 6, 409, 128),
    (9, 48, 1024, 72), (5, 64, 96, 512), (3, 128, 409, 96),
    (33, 7, 1024, 512), (3, 200, 96, 128), (4, 131, 64, 128)])
def test_projection_kernel_matches_plain(dev, T, B, D, F):
    g = _gen(dev, 1)
    xin = torch.randn(T, 2 * B, D, generator=g, device=dev).to(
        torch.bfloat16)
    wx = (torch.randn(2, D, 4 * F, generator=g, device=dev)
          / D ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(2, 4 * F, generator=g, device=dev)
    zero = torch.zeros(2, 4 * F, device=dev)
    before = cuda_lstm.PROJECTION.launches
    out = cuda_lstm.bilstm_projection_tmajor(xin, wx, zero)
    torch.cuda.synchronize()
    assert cuda_lstm.PROJECTION.launches == before + 1
    ref = cuda_lstm.projection_tmajor_plain(xin, wx, zero)
    diff = (out - ref).abs()
    # bf16 products of float32 sums in another order: one bf16 ulp at
    # most (1e-5 for sums cancelling to near zero), rarely.
    assert torch.all(diff <= _bf16_ulp(torch.maximum(out.abs(), ref.abs()))
                     + 1e-5)
    assert (diff > 0).float().mean().item() < 1e-2
    # The bias is one float32 add after the rounding.
    rows_b = bias[None, :, None, :].expand(T, 2, B, 4 * F).reshape(
        T, 2 * B, 4 * F)
    assert torch.equal(cuda_lstm.bilstm_projection_tmajor(xin, wx, bias),
                       out + rows_b)


# The recurrence kernel's edges: T = 1 (no barrier), Bp = 1 and 7 (a
# partly filled 64-row m-tile), 64 and 65 (one full tile, then one row
# more), 130 (three tiles), 256 (four, the most); F = 64 (8 blocks a
# direction, one 64-deep k block) to 512, and F = 80 (a k block of 16).
@pytest.mark.parametrize("T,B,F", [(37, 3, 128), (8, 1, 256), (96, 9, 512),
                                   (64, 48, 512), (1, 6, 512), (1, 1, 64),
                                   (29, 1, 512), (33, 7, 64), (20, 64, 256),
                                   (20, 65, 128), (12, 130, 512),
                                   (12, 130, 64), (8, 256, 64),
                                   (15, 5, 80)])
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


@pytest.mark.parametrize("B,F", [(1, 100), (257, 64), (6, 1024)],
                         ids=["F%16", "Bp>256", "not-co-resident"])
def test_recurrence_kernel_refuses_unsupported_width(dev, B, F):
    """F must be a multiple of 16 and Bp at most 256; F = 1024 needs 256
    blocks of ~193 KB of shared memory, which cannot all be resident.
    The wrapper raises and never falls back to the plain version."""
    xp = torch.zeros(4, 2 * B, 4 * F, device=dev)
    before = cuda_lstm.RECURRENCE.launches
    with pytest.raises(dispatch.KernelError):
        cuda_lstm.bilstm_recurrence_tmajor(xp, torch.zeros(2 * F, 4 * F,
                                                           device=dev))
    assert cuda_lstm.RECURRENCE.launches == before


def test_projection_refuses_a_width_tma_cannot_stride(dev):
    """4F must be a multiple of 8 (16-byte rows of Wx for TMA); the
    wrapper pads only K."""
    with pytest.raises(dispatch.KernelError):
        cuda_lstm.bilstm_projection_tmajor(
            torch.zeros(4, 2, 16, device=dev, dtype=torch.bfloat16),
            torch.zeros(2, 16, 12, device=dev), torch.zeros(2, 12,
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
                                            (48, 8, 512, True),
                                            (1, 1, 64, False),
                                            (1, 6, 512, True),
                                            (25, 7, 64, True),
                                            (16, 64, 256, False),
                                            (16, 65, 128, True),
                                            (10, 130, 512, False),
                                            (10, 130, 64, True),
                                            (6, 200, 128, True),
                                            (9, 3, 80, False)])
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


def _backward_inputs(dev, T, B, F, res_bf16, seed=4):
    """Residuals of the plain training recurrence, an upstream cotangent
    and Wh (bf16)."""
    g = _gen(dev, seed)
    xp = 0.5 * torch.randn(T, 2 * B, 4 * F, generator=g, device=dev)
    wh = (torch.randn(2 * F, 4 * F, generator=g, device=dev)
          / F ** 0.5).to(torch.bfloat16)
    _, a, c = cuda_lstm.recurrence_train_tmajor_plain(xp, wh, res_bf16)
    gout = 0.1 * torch.randn(T, 2 * B, F, generator=g, device=dev)
    return a, c, gout, wh


# The backward kernel's edges: T = 1 (no barrier), Bp = 1 and 7 (a partly
# filled m16 tile), 46 and 47 at F = 512 (the whole dz in the four ring
# slots, then a ring refilled in 8 chunks), 64 and 65 (four tiles, then
# one row more), 130, 192 at F = 512 and 256 at F = 256 (the most rows,
# chunks of 64 columns); F = 64 (8 blocks a direction, 16-column k
# steps shared by four warps), 80 (5 k steps a chunk) to 512.
@pytest.mark.parametrize("T,B,F,res_bf16", [(37, 3, 128, False),
                                            (19, 8, 256, True),
                                            (64, 32, 512, False),
                                            (48, 8, 512, True),
                                            (1, 1, 64, False),
                                            (1, 6, 512, True),
                                            (25, 7, 64, True),
                                            (8, 46, 512, False),
                                            (8, 47, 512, True),
                                            (16, 64, 256, False),
                                            (16, 65, 128, True),
                                            (10, 130, 512, False),
                                            (10, 130, 64, True),
                                            (6, 192, 512, True),
                                            (6, 256, 256, False),
                                            (9, 3, 80, False),
                                            (12, 65, 80, True)])
def test_backward_kernel_matches_plain(dev, T, B, F, res_bf16):
    """dz of the reverse-time kernel against the plain backward on the
    same residuals: float32 sums in another order; a dz at a bf16
    rounding boundary feeds the next step one bf16 ulp apart."""
    a, c, gout, wh = _backward_inputs(dev, T, B, F, res_bf16)
    before = cuda_lstm.BACKWARD.launches
    dz = cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
    assert cuda_lstm.BACKWARD.launches == before + 1
    ref = cuda_lstm.dz_bwd_tmajor_plain(a, c, gout, wh)
    torch.testing.assert_close(dz, ref, rtol=0,
                               atol=1e-3 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("T,B,F", [(64, 32, 512), (10, 130, 64)])
def test_backward_kernel_is_deterministic(dev, T, B, F):
    """The warps' partial sums meet in a fixed order: two launches on the
    same inputs give the same dz bit for bit."""
    a, c, gout, wh = _backward_inputs(dev, T, B, F, False)
    first = cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
    assert torch.equal(first, cuda_lstm.dz_bwd_tmajor(a, c, gout, wh))


def test_backward_accepts_every_shape_the_train_recurrence_accepts(dev):
    """A shape that the training forward (K4) takes and the backward (K5)
    refuses would stop training after its forward.  Over widths and row
    counts around every limit of K4 (F % 16, shared memory at Bp = 192 /
    256, co-residency at F = 528 / 1024, Bp <= 256), K5 launches wherever
    K4 launches; both refuse F = 1024 and F % 16 != 0 with KernelError
    and launch nothing."""
    accepted, refused = [], {}
    for F in (16, 64, 80, 100, 128, 256, 384, 448, 512, 528, 1024):
        for B in (1, 128, 129, 192, 193, 256, 257):
            xp = torch.zeros(1, 2 * B, 4 * F, device=dev)
            wh = torch.zeros(2 * F, 4 * F, device=dev)
            try:
                _, a, c = cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh)
            except dispatch.KernelError as e:
                refused[(B, F)] = str(e)
                if F in (100, 1024):
                    a = torch.zeros(1, 2 * B, 4 * F, device=dev)
                    c = torch.zeros(1, 2 * B, F, device=dev)
                    before = cuda_lstm.BACKWARD.launches
                    with pytest.raises(dispatch.KernelError):
                        cuda_lstm.dz_bwd_tmajor(a, c, torch.zeros_like(c),
                                                wh)
                    assert cuda_lstm.BACKWARD.launches == before
                continue
            assert F not in (100, 1024)
            before = cuda_lstm.BACKWARD.launches
            dz = cuda_lstm.dz_bwd_tmajor(a, c, torch.zeros_like(c), wh)
            torch.cuda.synchronize()
            assert cuda_lstm.BACKWARD.launches == before + 1
            assert not dz.any()         # zero cotangent, zero dz
            accepted.append((B, F))
    for shape in ((192, 512), (256, 256)):
        assert shape in accepted, refused.get(shape)


@pytest.mark.parametrize("D,F", [(256, 256), (128, 64)])
def test_layer_autograd_on_the_card_matches_plain_autograd(dev, D, F):
    """BiLSTMLayerFn (projection kernel, training recurrence, backward
    kernel, bf16 GEMMs) against autograd through the plain layer; bound
    relative to each gradient's largest entry, as the CPU test.  F = 64
    is the quality-pin recipe's width."""
    T, B = 24, 4
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


# The one-direction instances (ndir = 1, a tensor-parallel rank's
# launches) at the edges of every kernel: T = 1, Bp = 1, 7, 64, 65, 130,
# D = 409 (padded K), F = 64, 80 and 512.  Each block or tile does the
# arithmetic it does in the two-direction launch, so a direction's inputs
# give that direction's half bit for bit.
@pytest.mark.parametrize("T,B,D,F", [(1, 1, 96, 64), (37, 7, 409, 80),
                                     (16, 64, 256, 128), (12, 65, 128, 64),
                                     (10, 130, 96, 512), (33, 8, 1024, 512)])
def test_one_direction_instances_are_the_halves(dev, T, B, D, F):
    g = _gen(dev, 6)
    xin = torch.randn(T, 2 * B, D, generator=g, device=dev).to(
        torch.bfloat16)
    wx = (torch.randn(2, D, 4 * F, generator=g, device=dev)
          / D ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(2, 4 * F, generator=g, device=dev)
    wh = (torch.randn(2 * F, 4 * F, generator=g, device=dev)
          / F ** 0.5).to(torch.bfloat16)
    gout = 0.1 * torch.randn(T, 2 * B, F, generator=g, device=dev)
    xp = cuda_lstm.bilstm_projection_tmajor(xin, wx, bias)
    h = cuda_lstm.bilstm_recurrence_tmajor(xp, wh)
    halves = {res: cuda_lstm.bilstm_recurrence_train_tmajor(xp, wh, res)
              for res in (False, True)}
    dz = {res: cuda_lstm.dz_bwd_tmajor(a, c, gout, wh)
          for res, (_, a, c) in halves.items()}
    kernels = (cuda_lstm.PROJECTION_ONEDIR, cuda_lstm.RECURRENCE_ONEDIR,
               cuda_lstm.RECURRENCE_TRAIN_ONEDIR, cuda_lstm.BACKWARD_ONEDIR)
    two = (cuda_lstm.PROJECTION, cuda_lstm.RECURRENCE,
           cuda_lstm.RECURRENCE_TRAIN, cuda_lstm.BACKWARD)
    before = [k.launches for k in kernels + two]
    for d in range(2):
        rows = slice(d * B, (d + 1) * B)
        units = slice(d * F, (d + 1) * F)
        xp1 = cuda_lstm.bilstm_projection_tmajor(
            xin[:, rows].contiguous(), wx[d:d + 1], bias[d:d + 1])
        assert torch.equal(xp1, xp[:, rows])
        assert torch.equal(cuda_lstm.bilstm_recurrence_tmajor(xp1, wh[units]),
                           h[:, rows])
        for res, (h2, a2, c2) in halves.items():
            h1, a1, c1 = cuda_lstm.bilstm_recurrence_train_tmajor(
                xp1, wh[units], res)
            assert torch.equal(h1, h2[:, rows])
            assert torch.equal(a1, a2[:, rows])
            assert torch.equal(c1, c2[:, rows])
            assert torch.equal(cuda_lstm.dz_bwd_tmajor(
                a1, c1, gout[:, rows].contiguous(), wh[units]),
                dz[res][:, rows])
    torch.cuda.synchronize()
    after = [k.launches for k in kernels + two]
    assert [n - b for n, b in zip(after, before)] == [2, 2, 4, 4, 0, 0, 0, 0]
    # And against the plain versions on the direction's inputs.
    xp1 = cuda_lstm.bilstm_projection_tmajor(xin[:, :B].contiguous(),
                                             wx[:1], bias[:1])
    torch.testing.assert_close(
        cuda_lstm.bilstm_recurrence_tmajor(xp1, wh[:F]),
        cuda_lstm.recurrence_tmajor_plain(xp1, wh[:F]), rtol=0,
        atol=REC_TOL)


def test_one_direction_layer_autograd_matches_plain_autograd(dev):
    """BiLSTMLayerFn on one direction's weights (a tensor-parallel rank's
    layer) against autograd through the plain one-direction layer."""
    T, B, D, F = 24, 4, 256, 256
    g = _gen(dev, 7)
    args = [torch.randn(T, B, D, generator=g, device=dev).to(torch.bfloat16),
            torch.randn(1, D, 4 * F, generator=g, device=dev) / D ** 0.5,
            torch.randn(F, 4 * F, generator=g, device=dev) / F ** 0.5,
            0.1 * torch.randn(1, 4 * F, generator=g, device=dev)]
    wgt = torch.randn(T, B, F, generator=g, device=dev)
    ours = [t.clone().requires_grad_() for t in args]
    plain = [t.clone().requires_grad_() for t in args]
    before = cuda_lstm.BACKWARD_ONEDIR.launches
    (cuda_lstm.BiLSTMLayerFn.apply(*ours, False) * wgt).sum().backward()
    assert cuda_lstm.BACKWARD_ONEDIR.launches == before + 1
    (cuda_lstm.scan_layer_tmajor(*plain) * wgt).sum().backward()
    for o, p in zip(ours, plain):
        scale = p.grad.float().abs().max().item()
        assert (o.grad.float() - p.grad.float()).abs().max().item() \
            <= 2e-2 * scale


def test_one_direction_instances_refuse_what_they_do_not_take(dev):
    """Wh of neither one nor two directions, rows that the directions do
    not divide, and F % 16 raise before any launch."""
    launches = [k.launches for k in (cuda_lstm.RECURRENCE_ONEDIR,
                                     cuda_lstm.PROJECTION_ONEDIR)]
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_recurrence_tmajor(
            torch.zeros(4, 3, 256, device=dev),
            torch.zeros(192, 256, device=dev))
    with pytest.raises(ValueError):
        cuda_lstm.bilstm_projection_tmajor(
            torch.zeros(4, 3, 16, device=dev, dtype=torch.bfloat16),
            torch.zeros(3, 16, 256, device=dev),
            torch.zeros(3, 256, device=dev))
    with pytest.raises(dispatch.KernelError):
        cuda_lstm.bilstm_recurrence_tmajor(
            torch.zeros(4, 3, 400, device=dev),
            torch.zeros(100, 400, device=dev))
    assert [k.launches for k in (cuda_lstm.RECURRENCE_ONEDIR,
                                 cuda_lstm.PROJECTION_ONEDIR)] == launches


# WaveNet sampler kernel vs its plain version: bf16 operands and float32
# sums in both, summed in other orders, so z (rounded to bf16) can land
# one bf16 ulp apart and move later logits; bound: 4 bf16 ulps (2**-6)
# of the logits' largest magnitude.
WAVENET_TOL = 2.0 ** -6


def _wavenet(dev, layers=4, C=23, out_channels=256, seed=0):
    cfg = WaveNetWrapper.Config(input_names=("cond",),
                                output_names=("logits",),
                                out_channels=out_channels,
                                num_layers=layers,
                                num_stacks=min(2, layers),
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


# Layers: 1 (a 2-CTA cluster), 4, 20 (the default), 21 (the most an
# 8-CTA cluster holds), 22 (the first that needs 16 CTAs), 45 (the
# limit); conditioning widths at Cp = 16, 32 and 64; B = 1, 17, 33.
@pytest.mark.parametrize("T,B,layers,C", [
    (1, 1, 2, 23), (70, 3, 4, 23), (200, 17, 6, 63), (40, 33, 4, 9),
    (50, 1, 1, 23), (60, 16, 20, 23), (40, 17, 21, 16), (40, 33, 22, 63),
    (24, 5, 45, 63), (30, 1, 20, 63), (30, 17, 4, 16)])
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


def test_wavenet_kernel_refuses_past_its_layer_limit(dev):
    w = _wavenet(dev, layers=cuda_wavenet.MAX_LAYERS + 1)
    with pytest.raises(dispatch.KernelError, match="at most 45 layers"):
        cuda_wavenet.sample(w, torch.zeros(3, 1, 23, device=dev),
                            temperature=0.0)
    # The plain version, on the CPU, takes any depth.
    cpu = _wavenet(torch.device("cpu"), layers=cuda_wavenet.MAX_LAYERS + 1)
    s, _ = cuda_wavenet.sample(cpu, torch.zeros(3, 1, 23), temperature=0.0)
    assert s.shape == (3, 1)


def test_wavenet_batch_of_256_runs_in_one_wave_with_groups_in_flight(dev):
    """At the default depth, B = 256 launches no more clusters than can
    be resident; a batch of one row group more than the resident
    clusters carry one each runs with G = 2 row groups a cluster, and
    its logits hold against the plain version."""
    w = _wavenet(dev, layers=20)
    plan = cuda_wavenet.launch_plan(w, 256)
    assert plan["cluster"] == 8
    assert plan["clusters"] <= plan["active_clusters"]
    assert plan["G"] * plan["clusters"] * 16 >= 256
    B = 16 * (plan["active_clusters"] + 1)
    plan = cuda_wavenet.launch_plan(w, B)
    assert plan["G"] == 2 and plan["clusters"] <= plan["active_clusters"]
    cond, forced, _ = _wavenet_inputs(dev, 12, B)
    _, logits = cuda_wavenet.sample(w, cond, forced=forced,
                                    want_logits=True)
    _, ref = cuda_wavenet.sample_plain(w, cond, forced=forced,
                                       want_logits=True)
    torch.testing.assert_close(logits, ref, rtol=0, atol=WAVENET_TOL
                               * ref.abs().max().item())


def test_wavenet_row_groups_in_flight_give_the_same_draws(dev):
    """Rows are independent: the first 16 rows of a batch that the launch
    carries as G = 2 row groups a cluster draw bit for bit what the same
    16 rows draw alone (one group, one cluster)."""
    w = _wavenet(dev, layers=20)
    B = 16 * (cuda_wavenet.launch_plan(w, 16)["active_clusters"] + 1)
    assert cuda_wavenet.launch_plan(w, B)["G"] == 2
    cond, _, u = _wavenet_inputs(dev, 60, B)
    many, _ = cuda_wavenet.sample(w, cond, uniforms=u)
    one, _ = cuda_wavenet.sample(w, cond[:, :16].contiguous(),
                                 uniforms=u[:, :16].contiguous())
    assert torch.equal(one, many[:, :16])


def test_wavenet_two_launches_are_identical(dev):
    w = _wavenet(dev, layers=20, C=63)
    cond, _, u = _wavenet_inputs(dev, 80, 17, C=63)
    a, _ = cuda_wavenet.sample(w, cond, uniforms=u)
    b, _ = cuda_wavenet.sample(w, cond, uniforms=u)
    assert torch.equal(a, b)


@pytest.mark.parametrize("temperature", [0.6, 1.5])
def test_wavenet_free_run_at_a_temperature_matches_plain(dev, temperature):
    """As the free run at temperature 1: the kernel's draws are the plain
    draws at this temperature from the plain logits on the kernel's own
    history, except where U lies within the logits tolerance (scaled by
    1 / temperature) of a CDF boundary."""
    w = _wavenet(dev, layers=20, seed=7)
    T, B = 100, 17
    cond, _, u = _wavenet_inputs(dev, T, B, seed=7)
    s, _ = cuda_wavenet.sample(w, cond, uniforms=u, temperature=temperature)
    _, ref_logits = cuda_wavenet.sample_plain(w, cond, forced=s,
                                              want_logits=True)
    tol = 2 * WAVENET_TOL * ref_logits.abs().max().item() / temperature
    flat = ref_logits.reshape(T * B, -1)
    ref = cuda_wavenet.draw(flat, u.reshape(-1), temperature,
                            256).reshape(T, B)
    margin = cuda_wavenet.cdf_margin(flat, u.reshape(-1),
                                     temperature).reshape(T, B)
    assert torch.all((s == ref) | (margin <= tol))
    assert len(torch.unique(s)) > 5


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


@pytest.mark.parametrize("L", [1, 20, 60])
@pytest.mark.parametrize("T", [1, 2, 3, 512, 2048])
def test_mlpg_utterance_kernel_matches_plain(dev, T, L):
    """K1 assembling the system itself from the window means and
    variances, against the plain fused version."""
    rs = np.random.RandomState(T + L)
    means = torch.from_numpy(rs.randn(T, 3 * L).astype(np.float32)).to(dev)
    var = torch.from_numpy((rs.rand(3 * L) * 0.5 + 0.05).astype(
        np.float32)).to(dev)
    before = cuda_mlpg.ONESHOT.launches
    x = cuda_mlpg.mlpg_utterance(means, var)
    torch.cuda.synchronize()
    assert cuda_mlpg.ONESHOT.launches == before + 1
    ref = cuda_mlpg.mlpg_utterance_plain(means, var)
    torch.testing.assert_close(
        x, ref, rtol=0, atol=MLPG_ONESHOT_TOL * ref.abs().max().item())


# The MLPG post-processing of a stream on the card against the CPU path,
# relative to the stream's largest magnitude (chip_smoke.py's
# MLPG_STREAM_TOL): the fixture variances span 6e-5 to 70.
MLPG_STREAM_TOL = 1e-4


@pytest.mark.parametrize("stream", ["mcep20", "lf0", "bap"])
def test_mlpg_utterance_kernel_on_fixture_variances(dev, stream):
    var = _stream_variances(stream)
    T = 487
    rs = np.random.RandomState(7)
    means = (np.sqrt(var) * rs.randn(T, var.shape[0])).astype(np.float32)
    x = cuda_mlpg.mlpg_utterance(torch.from_numpy(means).to(dev),
                                 torch.from_numpy(var).to(dev)).cpu()
    ref = cuda_mlpg.mlpg_utterance_plain(torch.from_numpy(means),
                                         torch.from_numpy(var))
    torch.testing.assert_close(
        x, ref, rtol=0, atol=MLPG_STREAM_TOL * ref.abs().max().item())


@pytest.mark.parametrize("mode", ["fused", "thin"])
def test_mlpg_oneshot_global_scratch(dev, mode):
    """Where one lane's store does not fit shared memory (T > ~14,500),
    K1 runs from a global scratch: same code, same result."""
    T, L = 15000, 2
    assert cuda_mlpg.oneshot_plan(dev, T, L)[1] > 0
    rs = np.random.RandomState(11)
    means = torch.from_numpy(rs.randn(T, 3 * L).astype(np.float32))
    var = torch.from_numpy((rs.rand(3 * L) * 0.5 + 0.05).astype(np.float32))
    if mode == "fused":
        ref = cuda_mlpg.mlpg_utterance_plain(means, var)
        x = cuda_mlpg.mlpg_utterance(means.to(dev), var.to(dev)).cpu()
    else:
        from idiaptts_torch.ops import mlpg
        bands, b = mlpg._banded_system(
            means.reshape(T, 3, L), mlpg._boundary_variances(var, L, T))
        ref = cuda_mlpg.mlpg_oneshot_plain(b, *bands)
        x = cuda_mlpg.mlpg_oneshot(*(a.contiguous().to(dev)
                                     for a in [b] + bands)).cpu()
    torch.testing.assert_close(
        x, ref, rtol=0, atol=MLPG_ONESHOT_TOL * ref.abs().max().item())


@pytest.mark.parametrize("T,L", [(1, 1), (512, 20), (2048, 60),
                                 (14000, 2), (20000, 3)])
def test_oneshot_plan_fits_shared_memory(dev, T, L):
    """K1's plan from the card's shared memory: the store of T x LC
    float4 rows in shared memory where one lane fits (LC = 20 at T = 512,
    6 at T = 2048), else a global scratch of (ceil(L / LC), T, LC) float4
    for a warp of lanes; either way the launch runs and is right."""
    lc, scratch = cuda_mlpg.oneshot_plan(dev, T, L)
    assert 1 <= lc <= min(L, 32)
    # A block's shared memory, less a margin for the kernel's own static
    # bytes (384), beside the store and one 8-byte mbarrier a 32-row chunk.
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    room = optin - 1024 - -(-T // 32) * 8
    if scratch == 0:
        assert 16 * T * lc <= optin
        assert lc == min(L, 32) or 16 * T * (lc + 1) > room
    else:
        assert 16 * T > room
        assert lc == min(L, 32) and scratch == -(-L // lc) * T * lc * 16
    rs = np.random.RandomState(T)
    means = torch.from_numpy(rs.randn(T, 3 * L).astype(np.float32))
    var = torch.from_numpy((rs.rand(3 * L) * 0.5 + 0.05).astype(np.float32))
    x = cuda_mlpg.mlpg_utterance(means.to(dev), var.to(dev)).cpu()
    ref = cuda_mlpg.mlpg_utterance_plain(means, var)
    torch.testing.assert_close(
        x, ref, rtol=0, atol=MLPG_ONESHOT_TOL * ref.abs().max().item())


def test_mlpg_utterance_refuses_what_it_does_not_take(dev):
    means = torch.zeros(8, 6, device=dev)
    var = torch.ones(6, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_mlpg.mlpg_utterance(means.double(), var.double())
    with pytest.raises(ValueError, match="expected"):
        cuda_mlpg.mlpg_utterance(means, torch.ones(9, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mlpg.mlpg_utterance(torch.zeros(6, 8, device=dev).t(), var)
