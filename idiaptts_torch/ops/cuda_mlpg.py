"""MLPG banded solves: the CUDA kernels ``csrc/banded_solve.cu`` (K2) and
``csrc/mlpg_oneshot.cu`` (K1), their plain PyTorch versions, and the
banded system's assembly in torch.

- K2 replaces ``idiaptts_tpu/ops/pallas_mlpg.py:solve_banded_pallas``
  (kernel ``_solve_kernel``): both substitutions with cached Cholesky
  factors, the time axis split into chunks that run in parallel.
  :func:`mlpg_served` is the served MLPG stage in one launch (the
  right-hand side assembled in the kernel from the model output through a
  column map); :func:`solve_banded` its lane-wise form (b given).
- K1 replaces ``mlpg_pallas``'s body (kernel ``_mlpg_kernel``): the
  banded Cholesky and both substitutions in one launch, for one
  utterance.  :func:`mlpg_utterance` assembles the system in the kernel
  from the window means and variances (``MLPG.generation``);
  :func:`mlpg_oneshot` takes it assembled.

Windows ``(1)``, ``(-0.5, 0, 0.5)``, ``(1, -2, 1)`` and the 1e11
boundary variances on the delta windows are the reference's.
"""

import ctypes

import numpy as np
import torch

from idiaptts_torch.ops import dispatch

WINDOWS = (
    np.array([0.0, 1.0, 0.0]),        # static
    np.array([-0.5, 0.0, 0.5]),       # delta (np.gradient convention)
    np.array([1.0, -2.0, 1.0]),       # delta-delta
)
BOUNDARY_VAR = 1e11

SOLVE = dispatch.Kernel(
    "banded_solve", "idt_banded_solve",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4)
ONESHOT = dispatch.Kernel(
    "mlpg_oneshot", "idt_mlpg_oneshot",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2)
ONESHOT_PLAN = dispatch.HostEntry(
    "idt_mlpg_oneshot_plan",
    [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
     ctypes.POINTER(ctypes.c_longlong)])

# K2's rows a thread owns (csrc/banded_solve.cu:R), for the chunk model.
SOLVE_ROWS = 16


# -- the banded system in torch -----------------------------------------------

def _shift(x, k):
    """x[..., t, :] -> x[..., t - k, :] along the time axis (-2), zero
    filled."""
    if k == 0:
        return x
    zeros = torch.zeros_like(x[..., :abs(k), :])
    if k > 0:
        return torch.cat([zeros, x[..., :-k, :]], dim=-2)
    return torch.cat([x[..., -k:, :], zeros], dim=-2)


def boundary_variances(variances, feature_dim, num_frames):
    """(3*D,) diagonal variances (array or tensor) -> (T, 3, D) float32
    per-frame window variances with the 1e11 delta variances on the first
    and last frame, on the variances' device (the CPU for an array)."""
    T, D = int(num_frames), int(feature_dim)
    var_row = torch.as_tensor(variances, dtype=torch.float32).reshape(3, D)
    var = var_row[None].expand(T, 3, D).clone()
    var[0, 1:, :] = BOUNDARY_VAR
    var[-1, 1:, :] = BOUNDARY_VAR
    return var


def banded_precision(variances):
    """Lower-banded pentadiagonal precision rows [ab0, ab1, ab2], each
    (T, D), from per-frame window variances (T, 3, D), on their
    device."""
    T, _, D = variances.shape
    tau = 1.0 / variances
    bands = [torch.zeros(T, D, dtype=tau.dtype, device=tau.device)
             for _ in range(3)]
    idx = torch.arange(T, device=tau.device)
    for w, c in enumerate(WINDOWS):
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                band = j - i
                if band < 0:
                    continue
                contrib = float(c[i + 1] * c[j + 1]) * _shift(
                    tau[:, w], i)
                valid = ((idx - i >= 0) & (idx - i < T)
                         & (idx - i + j >= 0) & (idx - i + j < T))
                contrib = torch.where(valid[:, None], contrib,
                                      torch.zeros_like(contrib))
                bands[band] = bands[band] + contrib
    return bands


def b_vector(btau):
    """b = sum_w W_w^T btau_w from the precision-weighted window means
    btau (..., T, 3, D); returns (..., T, D)."""
    b = torch.zeros(btau.shape[:-2] + btau.shape[-1:], dtype=btau.dtype,
                    device=btau.device)
    for w, coeff in enumerate(WINDOWS):
        for k in (-1, 0, 1):
            if coeff[k + 1] != 0.0:
                b = b + float(coeff[k + 1]) * _shift(btau[..., w, :], k)
    return b


def banded_system(features, variances):
    """The banded system of one utterance (the role of
    ``_banded_system_jnp``): features and variances (T, 3, D) ->
    ([ab0, ab1, ab2], b), each (T, D), on the inputs' device."""
    return banded_precision(variances), b_vector(
        features * (1.0 / variances))


# -- plain versions -----------------------------------------------------------

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


def _chunk_sweep(rhs, inv, s1, s2, carries):
    """One substitution sweep of every chunk at once, the recurrence
    z_r = (rhs_r - s1_r z_{r-1} - s2_r z_{r-2}) * inv_r over the chunk's
    rows r, from the carries (z_{-1}, z_{-2}).  Arguments (P, R, L),
    carries a pair of (P, L); returns z (P, R, L)."""
    z1, z2 = carries
    out = torch.empty_like(rhs)
    for r in range(rhs.shape[1]):
        zn = (rhs[:, r] - s1[:, r] * z1 - s2[:, r] * z2) * inv[:, r]
        out[:, r] = zn
        z1, z2 = zn, z1
    return out


def _chunked_substitution(rhs, inv, s1, s2):
    """K2's three phases for one sweep, rows already in sweep order:
    (a) every chunk from zero carries and from the unit carries (1, 0)
    and (0, 1); (b) the true carries walked across the chunks; (c) every
    chunk again from them.  Arguments (P, R, L).  (The kernel's
    super-chunks of 256 chunks change nothing here: phase (a) is each
    chunk's own, and the walk goes on across them in the same order.)"""
    P, R, L = rhs.shape
    zero, one = torch.zeros(P, L), torch.ones(P, L)
    z = _chunk_sweep(rhs, inv, s1, s2, (zero, zero))
    u = _chunk_sweep(torch.zeros_like(rhs), inv, s1, s2, (one, zero))
    v = _chunk_sweep(torch.zeros_like(rhs), inv, s1, s2, (zero, one))
    # A chunk's outgoing carries are its last two rows; with one row a
    # chunk, the second is the incoming p itself.
    p, q = torch.zeros(L), torch.zeros(L)
    carry_p, carry_q = torch.empty(P, L), torch.empty(P, L)
    for k in range(P):
        carry_p[k], carry_q[k] = p, q
        p, q = (z[k, -1] + u[k, -1] * p + v[k, -1] * q,
                z[k, -2] + u[k, -2] * p + v[k, -2] * q if R >= 2 else p)
    return _chunk_sweep(rhs, inv, s1, s2, (carry_p, carry_q))


def solve_banded_chunked(b, l0, l1, l2, rows=SOLVE_ROWS):
    """A plain, vectorised model of K2's chunked scheme (for the tests):
    the T rows in chunks of ``rows``, each sweep in the kernel's three
    phases, multiplying by 1/l0.  Every argument (T, L); returns x
    (T, L)."""
    T, L = b.shape
    P = -(-T // rows)
    pad = P * rows - T

    def chunks(a):
        return torch.cat([a, a.new_zeros(pad, L)]).reshape(P, rows, L)

    def shifted(a, k):
        return torch.cat([a.new_zeros(k, L), a[:T - k]]) if T > k \
            else a.new_zeros(T, L)

    inv = chunks(1.0 / l0)
    # Rows past T are identity rows: zero coefficients and 1/l0 = 0.
    y = _chunked_substitution(chunks(b), inv, chunks(shifted(l1, 1)),
                              chunks(shifted(l2, 2)))
    y = y.reshape(-1, L)[:T]
    # Backward: the same recurrence over the reversed rows.
    rev = torch.flip(torch.cat([y, y.new_zeros(pad, L)]), [0])
    x = _chunked_substitution(
        rev.reshape(P, rows, L),
        torch.flip(inv.reshape(-1, L), [0]).reshape(P, rows, L),
        torch.flip(chunks(l1).reshape(-1, L), [0]).reshape(P, rows, L),
        torch.flip(chunks(l2).reshape(-1, L), [0]).reshape(P, rows, L))
    return torch.flip(x.reshape(-1, L), [0])[:T]


def mlpg_served_plain(means, colmap, factors, tau):
    """Plain PyTorch version of the served MLPG: the window means gathered
    from the model output by ``colmap``, b by :func:`b_vector`, then
    :func:`solve_banded_plain` with the factor tiled over the batch.
    Arguments as :func:`mlpg_served`."""
    B, T, _ = means.shape
    D = factors.shape[-1]
    feats = means.index_select(-1, colmap.long()).reshape(B, T, 3, D)
    b = b_vector(feats * tau)
    lanes = b.permute(1, 0, 2).reshape(T, B * D)
    l0, l1, l2 = (factors[i].repeat(1, B) for i in range(3))
    x = solve_banded_plain(lanes, l0, l1, l2)
    return x.reshape(T, B, D).permute(1, 0, 2).contiguous()


def mlpg_oneshot_plain(b, ab0, ab1, ab2):
    """Plain PyTorch one-shot solve: :func:`cholesky_banded_plain` of the
    banded system, then :func:`solve_banded_plain`."""
    return solve_banded_plain(b, *cholesky_banded_plain(ab0, ab1, ab2))


def mlpg_utterance_plain(means, variances):
    """Plain PyTorch version of the fused one-shot MLPG: the system by
    :func:`banded_system`, then :func:`mlpg_oneshot_plain`.  Arguments
    as :func:`mlpg_utterance`."""
    T = means.shape[0]
    D = variances.shape[0] // 3
    (ab0, ab1, ab2), b = banded_system(
        means.reshape(T, 3, D), boundary_variances(variances, D, T))
    return mlpg_oneshot_plain(b, ab0, ab1, ab2)


# -- K2 -----------------------------------------------------------------------

def solve_banded(b, l0, l1, l2):
    """Solve L L^T x = b.  b, l0, l1, l2: (T, L) float32 (the factor
    already tiled to the L lanes).  Returns (T, L) float32.

    CPU tensors take :func:`solve_banded_plain`; CUDA tensors launch K2
    in its thin mode (one lane a column, the time axis in chunks)."""
    if not dispatch.use_kernel(b, l0, l1, l2):
        return solve_banded_plain(b, l0, l1, l2)
    T, L = b.shape
    for name, t in (("b", b), ("l0", l0), ("l1", l1), ("l2", l2)):
        dispatch.check(t, name, torch.float32, (T, L))
    x = torch.empty_like(b)
    SOLVE(b.device, b.data_ptr(), None, None, l0.data_ptr(), l1.data_ptr(),
          l2.data_ptr(), x.data_ptr(), 1, T, L, L)
    return x


def mlpg_served(means, colmap, factors, tau):
    """The served MLPG in one launch: smoothed statics (B, T, D) from the
    model output ``means`` (B, T, C) float32, whose columns ``colmap``
    ((3D,) int32: [statics | deltas | delta-deltas] of the D MLPG
    dimensions) hold the window means, with the cached factor ``factors``
    (3, T, D) and window precisions ``tau`` (T, 3, D) of
    ``mlpg_factorise``.

    CPU tensors take :func:`mlpg_served_plain`; CUDA tensors launch K2,
    which assembles b itself and reads the factor for every utterance of
    the batch."""
    if not dispatch.use_kernel(means, colmap, factors, tau):
        return mlpg_served_plain(means, colmap, factors, tau)
    if means.dim() != 3:
        raise ValueError("means must be (B, T, C), got shape {}".format(
            tuple(means.shape)))
    B, T, C = means.shape
    D = factors.shape[-1]
    dispatch.check(means, "means", torch.float32, (B, T, C))
    dispatch.check(colmap, "colmap", torch.int32, (3 * D,))
    dispatch.check(factors, "factors", torch.float32, (3, T, D))
    dispatch.check(tau, "tau", torch.float32, (T, 3, D))
    x = torch.empty((B, T, D), dtype=torch.float32, device=means.device)
    SOLVE(means.device, means.data_ptr(), colmap.data_ptr(), tau.data_ptr(),
          factors[0].data_ptr(), factors[1].data_ptr(),
          factors[2].data_ptr(), x.data_ptr(), B, T, D, C)
    return x


# -- K1 -----------------------------------------------------------------------

def oneshot_plan(device, T, L):
    """K1's launch plan for (T, L) on the CUDA ``device``, as the kernel's
    source makes it from the device's shared memory: (lanes a block,
    bytes of global scratch a launch needs), the bytes 0 when the store
    fits shared memory."""
    lanes, scratch = ctypes.c_int(), ctypes.c_longlong()
    ONESHOT_PLAN(device, T, L, ctypes.byref(lanes), ctypes.byref(scratch))
    return lanes.value, scratch.value


def _launch_oneshot(device, T, L, inputs):
    """Launch K1: ``inputs`` are the (in, var, a0, a1, a2) pointers."""
    scratch_bytes = oneshot_plan(device, T, L)[1]
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=device) \
        if scratch_bytes else None
    x = torch.empty((T, L), dtype=torch.float32, device=device)
    ONESHOT(device, *inputs, None if scratch is None
            else scratch.data_ptr(), x.data_ptr(), T, L)
    return x


def mlpg_oneshot(b, ab0, ab1, ab2):
    """Solve (L L^T) x = b where L is the banded Cholesky factor of the
    lower-banded SPD rows (ab0, ab1, ab2).  Every argument is (T, L)
    float32, lanes independent.  Returns (T, L) float32.

    CPU tensors take :func:`mlpg_oneshot_plain`; CUDA tensors launch K1
    in its thin mode (the rows copied into its shared-memory store)."""
    if not dispatch.use_kernel(b, ab0, ab1, ab2):
        return mlpg_oneshot_plain(b, ab0, ab1, ab2)
    T, L = b.shape
    for name, t in (("b", b), ("ab0", ab0), ("ab1", ab1), ("ab2", ab2)):
        dispatch.check(t, name, torch.float32, (T, L))
    return _launch_oneshot(b.device, T, L, (
        b.data_ptr(), None, ab0.data_ptr(), ab1.data_ptr(), ab2.data_ptr()))


def mlpg_utterance(means, variances):
    """One utterance's MLPG in one launch: the smoothed (T, D) float32
    trajectory from the window means ``means`` (T, 3D) float32
    [statics | deltas | delta-deltas] and the diagonal variances
    ``variances`` (3D,) float32; the 1e11 delta variances of the first
    and last frame are applied here.

    CPU tensors take :func:`mlpg_utterance_plain`; CUDA tensors launch
    K1, which assembles the banded system itself."""
    if not dispatch.use_kernel(means, variances):
        return mlpg_utterance_plain(means, variances)
    if means.dim() != 2 or variances.dim() != 1 \
            or means.shape[1] != variances.shape[0] \
            or variances.shape[0] % 3:
        raise ValueError("means (T, 3D) and variances (3D,) expected, got "
                         "{} and {}".format(tuple(means.shape),
                                            tuple(variances.shape)))
    T, L = means.shape[0], variances.shape[0] // 3
    dispatch.check(means, "means", torch.float32, (T, 3 * L))
    dispatch.check(variances, "variances", torch.float32, (3 * L,))
    return _launch_oneshot(means.device, T, L, (
        means.data_ptr(), variances.data_ptr(), None, None, None))
