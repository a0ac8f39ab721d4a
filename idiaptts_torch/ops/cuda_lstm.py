"""BiLSTM layer kernels, inference and training: the CUDA kernels
``csrc/bilstm_proj.cu``, ``csrc/bilstm_recurrence.cu`` and
``csrc/bilstm_bwd.cu``, their plain PyTorch versions, and the autograd
functions that train through them.

Replaces, from ``idiaptts_tpu/ops/pallas_lstm.py``:

- ``_bilstm_layer_kernel`` (wrapper ``_layer_tmajor``): one BiLSTM layer,
  input projection plus recurrence.  Here it is two hand kernels in
  sequence, :func:`bilstm_projection_tmajor` then
  :func:`bilstm_recurrence_tmajor`; :func:`bilstm_layer_tmajor` runs both.
- ``_bilstm_kernel`` (wrapper ``_recurrence_tmajor``): the recurrence over
  precomputed projections, :func:`bilstm_recurrence_tmajor`.
- ``_bilstm_kernel_train`` (wrapper ``_recurrence_train_tmajor``): the
  recurrence that also streams out the backward's residuals (gates and
  cells), :func:`bilstm_recurrence_train_tmajor`; and
  ``_bilstm_layer_kernel_train`` as the projection kernel followed by it.
- ``_bilstm_bwd_kernel`` (wrapper ``_dz_bwd_tmajor``): the reverse-time
  backward, :func:`dz_bwd_tmajor`.
- the custom VJPs ``bilstm_layer_tmajor`` and ``bilstm_recurrence_tmajor``:
  :class:`BiLSTMLayerFn` and :class:`BiLSTMRecurrenceFn`.  Their forward
  saves h, the gates and the cells; their backward runs the backward
  kernel, then the weight and input gradients as GEMMs with bf16
  operands and float32 results (``_dwh_from_dz``, ``_layer_bwd``).  There
  is no forward recompute and no scan-VJP fallback.

The public layouts are the JAX package's time-major ones: rows are
``[fwd Bp | bwd Bp]`` with the backward direction pre-reversed by
``masked_flip``.  Every function also takes one direction alone: the
number of directions ``ndir`` (1 or 2) is read from the weights (``Wx``
(ndir, D, 4F), ``wh_cat`` (ndir*F, 4F), ``b`` (ndir, 4F)), and the rows
are then ``ndir*Bp``.  A tensor-parallel rank that holds one direction
launches the kernels' one-direction instances (their own launch
counters, ``*_onedir``), whose results on a direction's inputs are that
direction's half of the two-direction launch bit for bit.  Numerics as ``pallas_lstm.py``: bf16 matmul operands
with float32 accumulation, the input projection rounded to bf16 before
the bias, forget-gate bias +1, gate order [i, f, g, o], float32 state.
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch

_ARGS = {"idt_bilstm_proj": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
         "idt_bilstm_recurrence": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
         "idt_bilstm_recurrence_train": ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int] * 5),
         "idt_bilstm_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5}


def _instances(name, symbol):
    """The two-direction kernel and its one-direction instance: one C
    entry point (``ndir`` is its argument), two launch counters."""
    return (dispatch.Kernel(name, symbol, _ARGS[symbol]),
            dispatch.Kernel(name + "_onedir", symbol, _ARGS[symbol]))


PROJECTION, PROJECTION_ONEDIR = _instances("bilstm_proj", "idt_bilstm_proj")
RECURRENCE, RECURRENCE_ONEDIR = _instances("bilstm_recurrence",
                                           "idt_bilstm_recurrence")
RECURRENCE_TRAIN, RECURRENCE_TRAIN_ONEDIR = _instances(
    "bilstm_recurrence_train", "idt_bilstm_recurrence_train")
BACKWARD, BACKWARD_ONEDIR = _instances("bilstm_bwd", "idt_bilstm_bwd")
_ONEDIR = {PROJECTION: PROJECTION_ONEDIR, RECURRENCE: RECURRENCE_ONEDIR,
           RECURRENCE_TRAIN: RECURRENCE_TRAIN_ONEDIR,
           BACKWARD: BACKWARD_ONEDIR}


def _launch(kernel, ndir, device, *args):
    """Launch ``kernel``, or its one-direction instance when ``ndir`` is 1
    (``ndir`` is also the C entry point's argument after the shape
    arguments, before ``res_bf16``)."""
    (kernel if ndir == 2 else _ONEDIR[kernel])(device, *args)


def _ndir(wh_cat, F):
    """The number of directions of a (ndir*F, 4F) ``wh_cat``."""
    ndir = wh_cat.shape[0] // F if F else 0
    if ndir not in (1, 2) or wh_cat.shape[0] != ndir * F:
        raise ValueError("wh_cat must be (F, 4F) or (2F, 4F) for F={}, got "
                         "{}".format(F, tuple(wh_cat.shape)))
    return ndir


def _bf16_exact(x):
    """Round to bf16 and return float32: the product of two such values
    is exact in float32, so a float32 matmul of them is a bf16 matmul
    with float32 accumulation on any device."""
    return x.to(torch.bfloat16).to(torch.float32)


# -- plain versions ------------------------------------------------------

def _recurrence_plain(xp_t, wh_cat, residuals):
    T, R, G = xp_t.shape
    F = G // 4
    ndir = _ndir(wh_cat, F)
    Bp = R // ndir
    wh = _bf16_exact(wh_cat).reshape(ndir, F, G)
    xp = xp_t.reshape(T, ndir, Bp, G)
    h = torch.zeros(ndir, Bp, F, dtype=torch.float32, device=xp_t.device)
    c = torch.zeros_like(h)
    out = torch.empty(T, ndir, Bp, F, dtype=torch.float32,
                      device=xp_t.device)
    if residuals:
        gates_out = torch.empty(T, ndir, Bp, G, dtype=torch.float32,
                                device=xp_t.device)
        cells = torch.empty_like(out)
    for t in range(T):
        gates = xp[t] + torch.bmm(_bf16_exact(h), wh)
        i, f, g, o = gates.split(F, dim=-1)
        si, sf = torch.sigmoid(i), torch.sigmoid(f + 1.0)
        tg, so = torch.tanh(g), torch.sigmoid(o)
        c = sf * c + si * tg
        h = so * torch.tanh(c)
        out[t] = h
        if residuals:
            gates_out[t] = torch.cat([si, sf, tg, so], dim=-1)
            cells[t] = c
    if residuals:
        return (out.reshape(T, R, F), gates_out.reshape(T, R, G),
                cells.reshape(T, R, F))
    return out.reshape(T, R, F)


def recurrence_tmajor_plain(xp_t, wh_cat):
    """Plain recurrence (the role of ``pallas_lstm._scan_tmajor``).

    xp_t: (T, 2*Bp, 4F) float32; wh_cat: (2F, 4F) = vstack(W_f, W_b)
    (one direction: (T, Bp, 4F) and (F, 4F)).  Returns (T, 2*Bp, F)
    float32 hidden states."""
    return _recurrence_plain(xp_t, wh_cat, residuals=False)


def recurrence_train_tmajor_plain(xp_t, wh_cat, res_bf16=False):
    """Plain training-mode recurrence (the role of
    ``pallas_lstm._recurrence_train_tmajor``): returns ``(h, a, c)``, the
    hidden states (T, 2*Bp, F) float32, the post-activation gates
    ``[sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o)]`` (T, 2*Bp, 4F)
    and the cells (T, 2*Bp, F), the last two in bf16 when ``res_bf16``
    (float32 otherwise).  h is that of :func:`recurrence_tmajor_plain`
    bit for bit."""
    h, a, c = _recurrence_plain(xp_t, wh_cat, residuals=True)
    rdt = torch.bfloat16 if res_bf16 else torch.float32
    return h, a.to(rdt), c.to(rdt)


def dz_bwd_tmajor_plain(a, c, gout, wh_cat):
    """Plain reverse-time LSTM backward (the role of
    ``pallas_lstm._dz_bwd_tmajor``): pre-activation gate cotangents dz
    (T, 2*Bp, 4F) float32 from the training-mode residuals ``a``
    (T, 2*Bp, 4F) and ``c`` (T, 2*Bp, F), float32 or bf16, and the
    upstream cotangent ``gout`` (T, 2*Bp, F), which is rounded to the
    residuals' type first, as the JAX wrapper does.  The recurrent dh is
    bf16(dz) . Wh_d^T with float32 accumulation."""
    T, R, G = a.shape
    F = G // 4
    ndir = _ndir(wh_cat, F)
    Bp = R // ndir
    a32 = a.to(torch.float32)
    c32 = c.to(torch.float32)
    g32 = gout.to(a.dtype).to(torch.float32)
    wh_t = _bf16_exact(wh_cat).reshape(ndir, F, G).transpose(1, 2)
    dh = torch.zeros(R, F, dtype=torch.float32, device=a.device)
    dc = torch.zeros_like(dh)
    dz = torch.empty(T, R, G, dtype=torch.float32, device=a.device)
    for t in range(T - 1, -1, -1):
        i, f, g, o = a32[t].split(F, dim=-1)
        tc = torch.tanh(c32[t])
        cprev = c32[t - 1] if t > 0 else torch.zeros_like(tc)
        dh_tot = g32[t] + dh
        dc = dc + dh_tot * o * (1.0 - tc * tc)
        dzt = torch.cat([dc * g * (i * (1.0 - i)),
                         dc * cprev * (f * (1.0 - f)),
                         dc * i * (1.0 - g * g),
                         dh_tot * tc * (o * (1.0 - o))], dim=-1)
        dc = dc * f
        dz[t] = dzt
        dh = torch.bmm(_bf16_exact(dzt).reshape(ndir, Bp, G),
                       wh_t).reshape(R, F)
    return dz


def bilstm_recurrence_scan(x_proj, wh):
    """Plain recurrence in ``_BiFastLSTM``'s layout (the role of
    ``pallas_lstm.bilstm_recurrence_scan``).

    x_proj: (2, B, T, 4F) float32, direction 1 pre-reversed; wh:
    (2, F, 4F).  Returns (2, B, T, F)."""
    _, B, T, G = x_proj.shape
    xp_t = x_proj.permute(2, 0, 1, 3).reshape(T, 2 * B, G)
    out = recurrence_tmajor_plain(xp_t, torch.cat([wh[0], wh[1]], 0))
    return out.reshape(T, 2, B, G // 4).permute(1, 2, 0, 3)


def projection_tmajor_plain(xin_t, wx, b):
    """Plain input projection: bf16(xin . Wx[d]) + b[d] per direction.

    xin_t: (T, ndir*Bp, D) bf16; wx: (ndir, D, 4F); b: (ndir, 4F).
    Returns (T, ndir*Bp, 4F) float32."""
    T, R, D = xin_t.shape
    ndir = wx.shape[0]
    Bp = R // ndir
    x = _bf16_exact(xin_t).reshape(T, ndir, Bp, D)
    m = torch.einsum("tdbc,dcg->tdbg", x, _bf16_exact(wx))
    xp = _bf16_exact(m) + b.to(torch.float32)[None, :, None, :]
    return xp.reshape(T, R, -1)


def scan_layer_tmajor(xin_t, wx, wh_cat, b):
    """Plain BiLSTM layer (the role of ``pallas_lstm._scan_layer_tmajor``):
    projection then recurrence.  Returns (T, 2*Bp, F) float32."""
    return recurrence_tmajor_plain(projection_tmajor_plain(xin_t, wx, b),
                                   wh_cat)


# -- dispatching wrappers -------------------------------------------------

def _gates_shape(x, name, wh_cat):
    """(T, R, G, F, ndir) of a (T, ndir*Bp, 4F) gate-width tensor, ndir
    read from ``wh_cat``; raises on another shape."""
    T, R, G = x.shape
    F = G // 4
    ndir = _ndir(wh_cat, F)
    if R % ndir or G != 4 * F:
        raise ValueError("{} must be (T, {}*Bp, 4F), got {}".format(
            name, ndir, tuple(x.shape)))
    return T, R, G, F, ndir

def bilstm_projection_tmajor(xin_t, wx, b):
    """Input projection of one BiLSTM layer (the projection half of
    ``_bilstm_layer_kernel`` and ``_bilstm_layer_kernel_train``).  Same
    contract as :func:`projection_tmajor_plain`; CUDA tensors launch the
    hand GEMM.  Its TMA loads need rows of a multiple of 16 bytes, so an
    input width D that is not a multiple of 8 is padded with zeros along
    K (xin and Wx alike), which leaves the product unchanged; 4F must be
    a multiple of 8."""
    if not dispatch.use_kernel(xin_t, wx, b):
        return projection_tmajor_plain(xin_t, wx, b)
    T, R, D = xin_t.shape
    ndir = wx.shape[0]
    if ndir not in (1, 2) or R % ndir:
        raise ValueError("xin_t rows must be [fwd Bp | bwd Bp] and wx "
                         "(ndir, D, 4F) with ndir 1 or 2, got R={}, wx {}"
                         .format(R, tuple(wx.shape)))
    G = wx.shape[-1]
    wx = wx.to(torch.bfloat16).contiguous()
    b = b.to(torch.float32).contiguous()
    dispatch.check(xin_t, "xin_t", torch.bfloat16, (T, R, D))
    dispatch.check(wx, "wx", torch.bfloat16, (ndir, D, G))
    dispatch.check(b, "b", torch.float32, (ndir, G))
    pad = -D % 8
    if pad:
        xin_t = torch.nn.functional.pad(xin_t, (0, pad))
        wx = torch.nn.functional.pad(wx, (0, 0, 0, pad))
    xp = torch.empty(T, R, G, dtype=torch.float32, device=xin_t.device)
    _launch(PROJECTION, ndir, xin_t.device, xin_t.data_ptr(), wx.data_ptr(),
            b.data_ptr(), xp.data_ptr(), T, R // ndir, D + pad, G, ndir)
    return xp


def _recurrence_counters(device):
    """The persistent kernels' (recurrence and backward) arrival
    counters, one per direction, each on its own 128-byte line (the
    kernel zeroes them)."""
    return torch.empty(64, dtype=torch.int32, device=device)


def bilstm_recurrence_tmajor(xp_t, wh_cat):
    """Both directions' recurrence over precomputed projections (the role
    of ``pallas_lstm.bilstm_recurrence_tmajor``).

    xp_t: (T, ndir*Bp, 4F) float32; wh_cat: (ndir*F, 4F).  Returns
    (T, ndir*Bp, F) float32.  CUDA tensors launch the persistent hand
    kernel, which takes F a multiple of 16 and Bp <= 256 as far as its
    shared memory (the F x 32 Wh slice and ceil(Bp/64) tiles of 64 x F
    bf16) and the co-residency of its ndir*F/8 blocks admit, and raises
    :class:`dispatch.KernelError` beyond (for example F = 1024 with both
    directions)."""
    if not dispatch.use_kernel(xp_t, wh_cat):
        return recurrence_tmajor_plain(xp_t, wh_cat)
    T, R, G, F, ndir = _gates_shape(xp_t, "xp_t", wh_cat)
    wh_cat = wh_cat.to(torch.bfloat16).contiguous()
    dispatch.check(xp_t, "xp_t", torch.float32, (T, R, G))
    dispatch.check(wh_cat, "wh_cat", torch.bfloat16, (ndir * F, G))
    out = torch.empty(T, R, F, dtype=torch.float32, device=xp_t.device)
    hbuf = torch.empty(2, R, F, dtype=torch.bfloat16, device=xp_t.device)
    bar = _recurrence_counters(xp_t.device)
    _launch(RECURRENCE, ndir, xp_t.device, xp_t.data_ptr(),
            wh_cat.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
            bar.data_ptr(), T, R // ndir, F, ndir)
    return out


def bilstm_layer_tmajor(xin_t, wx, wh_cat, b):
    """One BiLSTM layer (the role of ``pallas_lstm.bilstm_layer_tmajor``).

    xin_t: (T, 2*Bp, D) bf16, rows [fwd Bp | bwd Bp] with direction 1
    pre-reversed; wx: (2, D, 4F); wh_cat: (2F, 4F); b: (2, 4F) (one
    direction: Bp rows, (1, D, 4F), (F, 4F), (1, 4F)).  Returns
    (T, 2*Bp, F) float32.  CUDA tensors run the projection kernel and
    then the recurrence kernel."""
    if not dispatch.use_kernel(xin_t, wx, wh_cat, b):
        return scan_layer_tmajor(xin_t, wx, wh_cat, b)
    return bilstm_recurrence_tmajor(bilstm_projection_tmajor(xin_t, wx, b),
                                    wh_cat)


def bilstm_recurrence_train_tmajor(xp_t, wh_cat, res_bf16=False):
    """Training-mode recurrence (the role of
    ``pallas_lstm._recurrence_train_tmajor``): ``(h, a, c)`` as
    :func:`recurrence_train_tmajor_plain`.  CUDA tensors launch the
    training instance of the persistent recurrence kernel, whose h is
    bit-identical to :func:`bilstm_recurrence_tmajor`'s."""
    if not dispatch.use_kernel(xp_t, wh_cat):
        return recurrence_train_tmajor_plain(xp_t, wh_cat, res_bf16)
    T, R, G, F, ndir = _gates_shape(xp_t, "xp_t", wh_cat)
    wh_cat = wh_cat.to(torch.bfloat16).contiguous()
    dispatch.check(xp_t, "xp_t", torch.float32, (T, R, G))
    dispatch.check(wh_cat, "wh_cat", torch.bfloat16, (ndir * F, G))
    rdt = torch.bfloat16 if res_bf16 else torch.float32
    dev = xp_t.device
    out = torch.empty(T, R, F, dtype=torch.float32, device=dev)
    a = torch.empty(T, R, G, dtype=rdt, device=dev)
    c = torch.empty(T, R, F, dtype=rdt, device=dev)
    hbuf = torch.empty(2, R, F, dtype=torch.bfloat16, device=dev)
    bar = _recurrence_counters(dev)
    _launch(RECURRENCE_TRAIN, ndir, dev, xp_t.data_ptr(), wh_cat.data_ptr(),
            out.data_ptr(), a.data_ptr(), c.data_ptr(), hbuf.data_ptr(),
            bar.data_ptr(), T, R // ndir, F, ndir, int(bool(res_bf16)))
    return out, a, c


def dz_bwd_tmajor(a, c, gout, wh_cat):
    """Reverse-time LSTM backward (the role of
    ``pallas_lstm._dz_bwd_tmajor``): dz (T, 2*Bp, 4F) float32, as
    :func:`dz_bwd_tmajor_plain`.  CUDA tensors launch the persistent
    backward kernel; the residuals may be float32 or bf16, and ``gout``
    is rounded to their type.  The kernel takes every shape that
    :func:`bilstm_recurrence_train_tmajor` takes (F a multiple of 16,
    Bp <= 256 as far as shared memory and co-residency admit) and raises
    :class:`dispatch.KernelError` beyond."""
    if not dispatch.use_kernel(a, c, gout, wh_cat):
        return dz_bwd_tmajor_plain(a, c, gout, wh_cat)
    T, R, G, F, ndir = _gates_shape(a, "a", wh_cat)
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("a must be float32 or bf16, got {}".format(
            a.dtype))
    gout = gout.to(a.dtype).contiguous()
    wh_cat = wh_cat.to(torch.bfloat16).contiguous()
    dispatch.check(a, "a", a.dtype, (T, R, G))
    dispatch.check(c, "c", a.dtype, (T, R, F))
    dispatch.check(gout, "gout", a.dtype, (T, R, F))
    dispatch.check(wh_cat, "wh_cat", torch.bfloat16, (ndir * F, G))
    dev = a.device
    dz = torch.empty(T, R, G, dtype=torch.float32, device=dev)
    # dz_{t+1} / dz_t in the kernel's chunk-major layout: 4F columns a
    # row plus at most 2F of row padding.
    dzbuf = torch.empty(2, R, 6 * F, dtype=torch.bfloat16, device=dev)
    bar = _recurrence_counters(dev)
    _launch(BACKWARD, ndir, dev, a.data_ptr(), c.data_ptr(), gout.data_ptr(),
            wh_cat.data_ptr(), dz.data_ptr(), dzbuf.data_ptr(),
            bar.data_ptr(), T, R // ndir, F, ndir,
            int(a.dtype == torch.bfloat16))
    return dz


# -- gradients: GEMMs around the backward kernel ----------------------------

def mm_f32(x, y):
    """x @ y with bf16 operands and a float32 result: float32
    accumulation of exact bf16 products, the rounding class of the JAX
    package's ``preferred_element_type=f32`` einsums.  On the card one
    bf16 cuBLAS GEMM with a float32 output (``out_dtype``); on the CPU,
    which has no such kernel, a float32 GEMM of the bf16-rounded
    operands."""
    x16 = x.to(torch.bfloat16)
    y16 = y.to(torch.bfloat16)
    if x16.device.type == "cuda":
        return torch.mm(x16, y16, out_dtype=torch.float32)
    return torch.mm(x16.to(torch.float32), y16.to(torch.float32))


def dwh_from_dz(h, dz, F, ndir=2):
    """dWh_cat = sum_t h[t-1]^T dz[t] per direction (the role of
    ``pallas_lstm._dwh_from_dz``): (ndir*F, 4F) float32."""
    T, R, G = dz.shape
    Bp = R // ndir
    hprev = torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)
    return torch.cat([
        mm_f32(hprev[:, d * Bp:(d + 1) * Bp].reshape(T * Bp, F).t(),
               dz[:, d * Bp:(d + 1) * Bp].reshape(T * Bp, G))
        for d in range(ndir)], dim=0)


def layer_grads(xin_t, wx, dz):
    """dWx (ndir, D, 4F), db (ndir, 4F) and dxin (T, ndir*Bp, D) of the
    projection ``bf16(xin . Wx) + b`` from dz (the GEMMs of
    ``pallas_lstm._layer_bwd``); dxin takes xin's dtype."""
    T, R, D = xin_t.shape
    G = dz.shape[-1]
    ndir = wx.shape[0]
    Bp = R // ndir
    dwx, db, dx = [], [], []
    for d in range(ndir):
        x_d = xin_t[:, d * Bp:(d + 1) * Bp].reshape(T * Bp, D)
        dz_d = dz[:, d * Bp:(d + 1) * Bp].reshape(T * Bp, G)
        dwx.append(mm_f32(x_d.t(), dz_d))
        db.append(dz_d.sum(dim=0))
        dx.append(mm_f32(dz_d, wx[d].t()).reshape(T, Bp, D))
    return (torch.stack(dwx), torch.stack(db),
            torch.cat(dx, dim=1).to(xin_t.dtype))


class BiLSTMRecurrenceFn(torch.autograd.Function):
    """Differentiable recurrence over precomputed projections (the role
    of the custom VJP ``pallas_lstm.bilstm_recurrence_tmajor``):
    ``apply(xp_t, wh_cat, res_bf16)`` -> h (T, 2*Bp, F).  Forward runs
    the training-mode recurrence; backward runs the backward kernel and
    the dWh GEMMs on the saved states."""

    @staticmethod
    def forward(ctx, xp_t, wh_cat, res_bf16=False):
        h, a, c = bilstm_recurrence_train_tmajor(xp_t, wh_cat, res_bf16)
        ctx.save_for_backward(wh_cat, h, a, c)
        return h

    @staticmethod
    def backward(ctx, g):
        wh_cat, h, a, c = ctx.saved_tensors
        dz = dz_bwd_tmajor(a, c, g.contiguous(), wh_cat)
        F = h.shape[-1]
        dwh = dwh_from_dz(h, dz, F, wh_cat.shape[0] // F)
        return dz, dwh.to(wh_cat.dtype), None


class BiLSTMLayerFn(torch.autograd.Function):
    """Differentiable BiLSTM layer (the role of the custom VJP
    ``pallas_lstm.bilstm_layer_tmajor``): ``apply(xin_t, wx, wh_cat, b,
    res_bf16)`` -> h (T, 2*Bp, F).  Forward runs the projection kernel
    then the training-mode recurrence (K7 = projection + K4) and saves h,
    the gates and the cells; backward runs the backward kernel, then
    dWh, dWx, db and dxin as GEMMs and a reduction."""

    @staticmethod
    def forward(ctx, xin_t, wx, wh_cat, b, res_bf16=False):
        xp = bilstm_projection_tmajor(xin_t, wx, b)
        h, a, c = bilstm_recurrence_train_tmajor(xp, wh_cat, res_bf16)
        ctx.save_for_backward(xin_t, wx, wh_cat, h, a, c)
        return h

    @staticmethod
    def backward(ctx, g):
        xin_t, wx, wh_cat, h, a, c = ctx.saved_tensors
        dz = dz_bwd_tmajor(a, c, g.contiguous(), wh_cat)
        dwh = dwh_from_dz(h, dz, h.shape[-1], wx.shape[0])
        dwx, db, dxin = layer_grads(xin_t, wx, dz)
        return dxin, dwx.to(wx.dtype), dwh.to(wh_cat.dtype), db, None
