"""The hand CUDA kernels against their plain PyTorch versions, on the
card.  Skipped where CUDA is unavailable.

The port's GPU environment need not have JAX, which tests/conftest.py
imports, so run this file without the conftest:

    python -m pytest --noconftest -m cuda tests/unit/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from idiaptts_torch.ops import cuda_lstm, cuda_mlpg, dispatch
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
