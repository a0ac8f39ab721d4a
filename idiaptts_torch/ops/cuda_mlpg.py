"""MLPG banded substitution: the CUDA kernel ``csrc/banded_solve.cu`` and
its plain PyTorch version.

Replaces ``idiaptts_tpu/ops/pallas_mlpg.py:solve_banded_pallas`` (kernel
``_solve_kernel``).  The one-shot factor-and-solve kernel ``mlpg_pallas``
(``_mlpg_kernel``) is not ported yet.
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch

SOLVE = dispatch.Kernel(
    "banded_solve", "idt_banded_solve",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int])


def solve_banded_plain(b, l0, l1, l2):
    """Plain PyTorch substitution pair (the role of
    ``idiaptts_tpu.ops.mlpg._solve_banded``): solve L L^T x = b with the
    bandwidth-2 factor (l0, l1, l2); every argument (T, L), lanes
    independent.  Zero carries at both boundaries."""
    T = b.shape[0]
    zero = torch.zeros_like(b[0])
    y = torch.empty_like(b)
    ym1, ym2 = zero, zero
    for t in range(T):
        acc = b[t]
        if t >= 1:
            acc = acc - l1[t - 1] * ym1
        if t >= 2:
            acc = acc - l2[t - 2] * ym2
        y[t] = acc / l0[t]
        ym1, ym2 = y[t], ym1
    x = torch.empty_like(b)
    xp1, xp2 = zero, zero
    for t in range(T - 1, -1, -1):
        x[t] = (y[t] - l1[t] * xp1 - l2[t] * xp2) / l0[t]
        xp1, xp2 = x[t], xp1
    return x


def solve_banded(b, l0, l1, l2):
    """Solve L L^T x = b.  b, l0, l1, l2: (T, L) float32 (the factor
    already tiled to the L lanes).  Returns (T, L) float32.

    CPU tensors take :func:`solve_banded_plain`; CUDA tensors launch the
    hand kernel, one thread per lane."""
    if not dispatch.use_kernel(b, l0, l1, l2):
        return solve_banded_plain(b, l0, l1, l2)
    T, L = b.shape
    for name, t in (("b", b), ("l0", l0), ("l1", l1), ("l2", l2)):
        dispatch.check(t, name, torch.float32, (T, L))
    y = torch.empty_like(b)
    x = torch.empty_like(b)
    SOLVE(b.device, b.data_ptr(), l0.data_ptr(), l1.data_ptr(),
          l2.data_ptr(), y.data_ptr(), x.data_ptr(), T, L)
    return x
