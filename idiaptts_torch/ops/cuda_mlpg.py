"""MLPG banded solves: the CUDA kernels ``csrc/banded_solve.cu`` and
``csrc/mlpg_oneshot.cu`` and their plain PyTorch versions.

- :func:`solve_banded` replaces ``idiaptts_tpu/ops/pallas_mlpg.py:
  solve_banded_pallas`` (kernel ``_solve_kernel``): both substitutions
  with cached Cholesky factors (the batch path, ``mlpg_solve``).
- :func:`mlpg_oneshot` replaces ``mlpg_pallas``'s body (kernel
  ``_mlpg_kernel``): the banded Cholesky and both substitutions in one
  launch, for one utterance's system (``MLPG.generation``).
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch

SOLVE = dispatch.Kernel(
    "banded_solve", "idt_banded_solve",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int])
ONESHOT = dispatch.Kernel(
    "mlpg_oneshot", "idt_mlpg_oneshot",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int])


def cholesky_banded_plain(a0, a1, a2):
    """Bandwidth-2 banded Cholesky (the role of ``_cholesky_banded_scan``):
    a0/a1/a2 (T, L) lower-banded SPD rows -> l0, l1, l2 (T, L) with
    L[t, t] = l0[t], L[t+1, t] = l1[t], L[t+2, t] = l2[t].  Zero carries
    before row 0."""
    T = a0.shape[0]
    l0 = torch.empty_like(a0)
    l1 = torch.empty_like(a0)
    l2 = torch.empty_like(a0)
    zero = torch.zeros_like(a0[0])
    l1_pm1, l2_pm1, l2_pm2 = zero, zero, zero
    for t in range(T):
        l0t = torch.sqrt(torch.clamp(a0[t] - l1_pm1 ** 2 - l2_pm2 ** 2,
                                     min=1e-20))
        l1t = (a1[t] - l1_pm1 * l2_pm1) / l0t
        l2t = a2[t] / l0t
        l0[t], l1[t], l2[t] = l0t, l1t, l2t
        l2_pm2 = l2_pm1
        l1_pm1, l2_pm1 = l1t, l2t
    return l0, l1, l2


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


def mlpg_oneshot_plain(b, ab0, ab1, ab2):
    """Plain PyTorch one-shot solve: :func:`cholesky_banded_plain` of the
    banded system, then :func:`solve_banded_plain`."""
    return solve_banded_plain(b, *cholesky_banded_plain(ab0, ab1, ab2))


def mlpg_oneshot(b, ab0, ab1, ab2):
    """Solve (L L^T) x = b where L is the banded Cholesky factor of the
    lower-banded SPD rows (ab0, ab1, ab2).  Every argument is (T, L)
    float32, lanes independent.  Returns (T, L) float32.

    CPU tensors take :func:`mlpg_oneshot_plain`; CUDA tensors launch the
    hand kernel, one thread per lane, with a (4, T, L) scratch for the
    factor rows and y."""
    if not dispatch.use_kernel(b, ab0, ab1, ab2):
        return mlpg_oneshot_plain(b, ab0, ab1, ab2)
    T, L = b.shape
    for name, t in (("b", b), ("ab0", ab0), ("ab1", ab1), ("ab2", ab2)):
        dispatch.check(t, name, torch.float32, (T, L))
    scratch = torch.empty((4, T, L), dtype=torch.float32, device=b.device)
    x = torch.empty_like(b)
    ONESHOT(b.device, b.data_ptr(), ab0.data_ptr(), ab1.data_ptr(),
            ab2.data_ptr(), scratch.data_ptr(), x.data_ptr(), T, L)
    return x
