"""BiLSTM layer kernels, inference half: the CUDA kernels
``csrc/bilstm_proj.cu`` and ``csrc/bilstm_recurrence.cu`` and their plain
PyTorch versions.

Replaces, from ``idiaptts_tpu/ops/pallas_lstm.py``:

- ``_bilstm_layer_kernel`` (wrapper ``_layer_tmajor``): one BiLSTM layer,
  input projection plus recurrence.  Here it is two hand kernels in
  sequence, :func:`bilstm_projection_tmajor` then
  :func:`bilstm_recurrence_tmajor`; :func:`bilstm_layer_tmajor` runs both.
- ``_bilstm_kernel`` (wrapper ``_recurrence_tmajor``): the recurrence over
  precomputed projections, :func:`bilstm_recurrence_tmajor`.

The public layouts are the JAX package's time-major ones: rows are
``[fwd Bp | bwd Bp]`` with the backward direction pre-reversed by
``masked_flip``.  Numerics as ``pallas_lstm.py``: bf16 matmul operands
with float32 accumulation, the input projection rounded to bf16 before
the bias, forget-gate bias +1, gate order [i, f, g, o], float32 state.
The training kernels (``_bilstm_kernel_train``, ``_bilstm_bwd_kernel``,
``_bilstm_layer_kernel_train``) are not ported yet.
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch

PROJECTION = dispatch.Kernel(
    "bilstm_proj", "idt_bilstm_proj",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
RECURRENCE = dispatch.Kernel(
    "bilstm_recurrence", "idt_bilstm_recurrence",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)


def _bf16_exact(x):
    """Round to bf16 and return float32: the product of two such values
    is exact in float32, so a float32 matmul of them is a bf16 matmul
    with float32 accumulation on any device."""
    return x.to(torch.bfloat16).to(torch.float32)


# -- plain versions ------------------------------------------------------

def recurrence_tmajor_plain(xp_t, wh_cat):
    """Plain recurrence (the role of ``pallas_lstm._scan_tmajor``).

    xp_t: (T, 2*Bp, 4F) float32; wh_cat: (2F, 4F) = vstack(W_f, W_b).
    Returns (T, 2*Bp, F) float32 hidden states."""
    T, R, G = xp_t.shape
    F = G // 4
    Bp = R // 2
    wh = _bf16_exact(wh_cat).reshape(2, F, G)
    xp = xp_t.reshape(T, 2, Bp, G)
    h = torch.zeros(2, Bp, F, dtype=torch.float32, device=xp_t.device)
    c = torch.zeros_like(h)
    out = torch.empty(T, 2, Bp, F, dtype=torch.float32,
                      device=xp_t.device)
    for t in range(T):
        gates = xp[t] + torch.bmm(_bf16_exact(h), wh)
        i, f, g, o = gates.split(F, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return out.reshape(T, R, F)


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

    xin_t: (T, 2*Bp, D) bf16; wx: (2, D, 4F); b: (2, 4F).  Returns
    (T, 2*Bp, 4F) float32."""
    T, R, D = xin_t.shape
    Bp = R // 2
    x = _bf16_exact(xin_t).reshape(T, 2, Bp, D)
    m = torch.einsum("tdbc,dcg->tdbg", x, _bf16_exact(wx))
    xp = _bf16_exact(m) + b.to(torch.float32)[None, :, None, :]
    return xp.reshape(T, R, -1)


def scan_layer_tmajor(xin_t, wx, wh_cat, b):
    """Plain BiLSTM layer (the role of ``pallas_lstm._scan_layer_tmajor``):
    projection then recurrence.  Returns (T, 2*Bp, F) float32."""
    return recurrence_tmajor_plain(projection_tmajor_plain(xin_t, wx, b),
                                   wh_cat)


# -- dispatching wrappers -------------------------------------------------

def bilstm_projection_tmajor(xin_t, wx, b):
    """Input projection of one BiLSTM layer (the projection half of
    ``_bilstm_layer_kernel``).  Same contract as
    :func:`projection_tmajor_plain`; CUDA tensors launch the hand GEMM."""
    if not dispatch.use_kernel(xin_t, wx, b):
        return projection_tmajor_plain(xin_t, wx, b)
    T, R, D = xin_t.shape
    if R % 2:
        raise ValueError("xin_t rows must be [fwd Bp | bwd Bp], got "
                         "R={}".format(R))
    G = wx.shape[-1]
    wx = wx.to(torch.bfloat16).contiguous()
    b = b.to(torch.float32).contiguous()
    dispatch.check(xin_t, "xin_t", torch.bfloat16, (T, R, D))
    dispatch.check(wx, "wx", torch.bfloat16, (2, D, G))
    dispatch.check(b, "b", torch.float32, (2, G))
    xp = torch.empty(T, R, G, dtype=torch.float32, device=xin_t.device)
    PROJECTION(xin_t.device, xin_t.data_ptr(), wx.data_ptr(), b.data_ptr(),
               xp.data_ptr(), T, R // 2, D, G)
    return xp


def bilstm_recurrence_tmajor(xp_t, wh_cat):
    """Both directions' recurrence over precomputed projections (the role
    of ``pallas_lstm.bilstm_recurrence_tmajor``).

    xp_t: (T, 2*Bp, 4F) float32; wh_cat: (2F, 4F).  Returns
    (T, 2*Bp, F) float32.  CUDA tensors launch the persistent hand
    kernel, which needs F a multiple of 128 and at most 512."""
    if not dispatch.use_kernel(xp_t, wh_cat):
        return recurrence_tmajor_plain(xp_t, wh_cat)
    T, R, G = xp_t.shape
    F = G // 4
    if R % 2 or G != 4 * F:
        raise ValueError("xp_t must be (T, 2*Bp, 4F), got {}".format(
            tuple(xp_t.shape)))
    wh_cat = wh_cat.to(torch.bfloat16).contiguous()
    dispatch.check(xp_t, "xp_t", torch.float32, (T, R, G))
    dispatch.check(wh_cat, "wh_cat", torch.bfloat16, (2 * F, G))
    out = torch.empty(T, R, F, dtype=torch.float32, device=xp_t.device)
    hbuf = torch.empty(2, R, F, dtype=torch.bfloat16, device=xp_t.device)
    bar = torch.empty(1, dtype=torch.int32, device=xp_t.device)
    RECURRENCE(xp_t.device, xp_t.data_ptr(), wh_cat.data_ptr(),
               out.data_ptr(), hbuf.data_ptr(), bar.data_ptr(), T, R // 2,
               F)
    return out


def bilstm_layer_tmajor(xin_t, wx, wh_cat, b):
    """One BiLSTM layer (the role of ``pallas_lstm.bilstm_layer_tmajor``).

    xin_t: (T, 2*Bp, D) bf16, rows [fwd Bp | bwd Bp] with direction 1
    pre-reversed; wx: (2, D, 4F); wh_cat: (2F, 4F); b: (2, 4F).  Returns
    (T, 2*Bp, F) float32.  CUDA tensors run the projection kernel and
    then the recurrence kernel."""
    if not dispatch.use_kernel(xin_t, wx, wh_cat, b):
        return scan_layer_tmajor(xin_t, wx, wh_cat, b)
    return bilstm_recurrence_tmajor(bilstm_projection_tmajor(xin_t, wx, b),
                                    wh_cat)
