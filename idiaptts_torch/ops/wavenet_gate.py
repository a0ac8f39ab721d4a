"""WaveNet's gated activation for teacher-forced training: the CUDA
kernel ``csrc/wavenet_gate.cu`` (forward and backward) and its plain
PyTorch version.

From the bf16 products of a residual block, P1 = bf(taps . W) of the
dilated convolution and P2 = bf(cond . Wc) of the conditioning, and
their bf16 biases:

- ``h = bf(bf(P1 + b1) + bf(P2 + b2))``, split into halves a and b;
- ``z = bf(bf(tanh a) * bf(sigmoid b))``;

and backward from dz (bf16), recomputing tanh and sigmoid from the saved
h:

- ``dh_a = bf(bf(dz * bf(sigmoid b)) * (1 - tanh(a)^2))``;
- ``dh_b = bf(bf(dz * bf(tanh a)) * (1 - sigmoid b) * sigmoid b)``.

These are the roundings of the plain residual block
(``models/wavenet.py``, where each bf16 step is a float32 op on
bf16-rounded values) and of autograd through it.  The block's bf16
path (:class:`idiaptts_torch.ops.wavenet_block.Block`) saves h alone and
runs the backward from it.  The kernel replaces no TPU kernel (XLA fused
this into its convolutions); it takes any gate width whose half is a
multiple of 8.
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch

VEC = 8

GATE_FWD = dispatch.Kernel(
    "wavenet_gate_fwd", "idt_wavenet_gate_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int])
GATE_BWD = dispatch.Kernel(
    "wavenet_gate_bwd", "idt_wavenet_gate_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int])


def _bf(x):
    """Round to bf16, keep float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def gate_plain(p_conv, p_cond, b_conv, b_cond):
    """(h, z) bf16 from the (..., G) bf16 products and the (G,) biases."""
    half = p_conv.shape[-1] // 2
    h = _bf(_bf(p_conv.float() + _bf(b_conv.float()))
            + _bf(p_cond.float() + _bf(b_cond.float())))
    a, b = h[..., :half], h[..., half:]
    z = _bf(torch.tanh(a)) * _bf(torch.sigmoid(b))
    return h.to(torch.bfloat16), z.to(torch.bfloat16)


def gate_backward_plain(h, dz):
    """dh (..., G) bf16 from the saved h and dz (..., G / 2) bf16."""
    half = h.shape[-1] // 2
    a, b = h[..., :half].float(), h[..., half:].float()
    g = dz.float()
    t, s = torch.tanh(a), torch.sigmoid(b)
    da = _bf(g * _bf(s)) * (1.0 - t * t)
    db = _bf(g * _bf(t)) * (1.0 - s) * s
    return torch.cat([da, db], dim=-1).to(torch.bfloat16)


def _check_width(G):
    if G % 2 or (G // 2) % VEC:
        raise ValueError("the gate kernel needs G / 2 a multiple of {}, "
                         "got G = {}".format(VEC, G))


def gate(p_conv, p_cond, b_conv, b_cond):
    """(h, z): the kernel for CUDA tensors, the plain version for CPU
    ones."""
    if not dispatch.use_kernel(p_conv, p_cond, b_conv, b_cond):
        return gate_plain(p_conv, p_cond, b_conv, b_cond)
    G = p_conv.shape[-1]
    _check_width(G)
    rows = p_conv.numel() // G
    bf16 = torch.bfloat16
    dispatch.check(p_conv, "p_conv", bf16, p_conv.shape)
    dispatch.check(p_cond, "p_cond", bf16, p_conv.shape)
    b_conv = b_conv.to(bf16).contiguous()
    b_cond = b_cond.to(bf16).contiguous()
    dispatch.check(b_conv, "b_conv", bf16, (G,))
    dispatch.check(b_cond, "b_cond", bf16, (G,))
    h = torch.empty_like(p_conv)
    z = torch.empty(p_conv.shape[:-1] + (G // 2,), dtype=bf16,
                    device=p_conv.device)
    GATE_FWD(p_conv.device, p_conv.data_ptr(), p_cond.data_ptr(),
             b_conv.data_ptr(), b_cond.data_ptr(), h.data_ptr(),
             z.data_ptr(), rows, G)
    return h, z


def gate_backward(h, dz):
    """dh: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    if not dispatch.use_kernel(h, dz):
        return gate_backward_plain(h, dz)
    G = h.shape[-1]
    _check_width(G)
    dispatch.check(h, "h", torch.bfloat16, h.shape)
    dispatch.check(dz, "dz", torch.bfloat16, h.shape[:-1] + (G // 2,))
    dh = torch.empty_like(h)
    GATE_BWD(h.device, h.data_ptr(), dz.data_ptr(), dh.data_ptr(),
             h.numel() // G, G)
    return dh
