"""A WaveNet residual block's bf16 training path: one autograd function
over the block's cuBLAS products and the hand kernels between them
(``csrc/wavenet_block.cu`` and the gate, ``csrc/wavenet_gate.cu``), each
with its plain PyTorch version for the CPU.

Forward, from the float32 residual stream x (B, T, R), the block's bf16
conditioning (B, T, Cp) and the skip sum so far (bf16, None before the
first block):

- ``taps`` = bf(x) at the k causal taps of dilation d, (B, T, k R);
- ``P1 = bf(taps . W)``, ``P2 = bf(cond . Wc)`` (cuBLAS, float32
  accumulation, rounded once);
- the gate: ``h``, ``z`` (:mod:`idiaptts_torch.ops.wavenet_gate`);
- ``P = bf(z . [Ws | Wr])``; ``skip = bf(P[:S] + bs)``,
  ``res = bf(P[S:] + br)``; ``x' = (x + res) / sqrt(2)`` in float32;
  ``skips' = bf(skips + skip)``.

It saves taps, h and z (bf16: 4.5 KB a sample at the r9y9 widths) and
writes its backward by hand: ``dP = [dskips' | bf(dx' / sqrt(2))]``,
the products' transposes, the gate's backward,
``dx = dx' / sqrt(2) + bf(sum of the taps' gradients that read x)``,
and, where the conditioning needs one, ``dcond = bf(dh . Wc^T)``.
Each weight's gradient is its bf16-rounded float32 sum, each bias's
the bf16-rounded float32 sum over the rows: the plain path's roundings
(``models/wavenet.py``, ``ResidualBlock.forward``), where each is a
float32 op on bf16-rounded values.  The kernels replace no TPU kernel
(XLA fused these passes); CUDA tensors go to the kernels, CPU tensors to
the plain versions.
"""

import ctypes

import torch

from idiaptts_torch.ops import dispatch, wavenet_gate
from idiaptts_torch.ops.cuda_wavenet import INV_SQRT2

VEC = 8

TAPS = dispatch.Kernel(
    "wavenet_taps", "idt_wavenet_taps",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3)
TAPS_BWD = dispatch.Kernel(
    "wavenet_taps_bwd", "idt_wavenet_taps_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3)
RESIDUAL = dispatch.Kernel(
    "wavenet_residual", "idt_wavenet_residual",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 2)
RESIDUAL_BWD = dispatch.Kernel(
    "wavenet_residual_bwd", "idt_wavenet_residual_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2)


def _bf(x):
    """Round to bf16, keep float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _shifts(k, d):
    """Tap j reads x[t - shift_j]."""
    return [(k - 1 - j) * d for j in range(k)]


def taps_plain(x, k, d):
    T = x.shape[1]
    xp = torch.nn.functional.pad(x.to(torch.bfloat16),
                                 (0, 0, (k - 1) * d, 0))
    return torch.cat([xp[:, j * d:j * d + T] for j in range(k)], dim=-1)


def taps_backward_plain(dtaps, dxo, k, d):
    T, R = dxo.shape[1], dxo.shape[2]
    acc = torch.zeros_like(dxo)
    for j, shift in enumerate(_shifts(k, d)):
        acc[:, :T - shift] += dtaps[:, shift:, j * R:(j + 1) * R].float()
    return dxo * INV_SQRT2 + _bf(acc)


def residual_plain(p, bias, x, skips):
    S = p.shape[-1] - x.shape[-1]
    v = _bf(p.float() + _bf(bias.float()))
    skip = v[..., :S] if skips is None else skips.float() + v[..., :S]
    return (x + v[..., S:]) * INV_SQRT2, skip.to(torch.bfloat16)


def residual_backward_plain(dxo, dskips):
    return torch.cat([dskips, (dxo * INV_SQRT2).to(torch.bfloat16)], -1)


def _check(x, R, k, d):
    if R % VEC:
        raise ValueError("the block kernels need R a multiple of {}, got "
                         "{}".format(VEC, R))
    dispatch.check(x, "x", torch.float32, x.shape)


def taps(x, k, d):
    """(B, T, k R) bf16 taps of the float32 stream x (B, T, R)."""
    if not dispatch.use_kernel(x):
        return taps_plain(x, k, d)
    B, T, R = x.shape
    _check(x, R, k, d)
    out = torch.empty(B, T, k * R, dtype=torch.bfloat16, device=x.device)
    TAPS(x.device, x.data_ptr(), out.data_ptr(), B, T, R, k, d)
    return out


def taps_backward(dtaps, dxo, k, d):
    """The stream's gradient: dx' / sqrt(2) + bf(the taps' gradients)."""
    if not dispatch.use_kernel(dtaps, dxo):
        return taps_backward_plain(dtaps, dxo, k, d)
    B, T, R = dxo.shape
    _check(dxo, R, k, d)
    dispatch.check(dtaps, "dtaps", torch.bfloat16, (B, T, k * R))
    dx = torch.empty_like(dxo)
    TAPS_BWD(dxo.device, dtaps.data_ptr(), dxo.data_ptr(), dx.data_ptr(), B,
             T, R, k, d)
    return dx


def residual(p, bias, x, skips):
    """(x', skips') from P (.., S + R) bf16 and its bias."""
    if not dispatch.use_kernel(p, bias, x):
        return residual_plain(p, bias, x, skips)
    R = x.shape[-1]
    S = p.shape[-1] - R
    rows = x.numel() // R
    dispatch.check(p, "p", torch.bfloat16, x.shape[:-1] + (S + R,))
    dispatch.check(x, "x", torch.float32, x.shape)
    bias = bias.to(torch.bfloat16).contiguous()
    if skips is not None:
        dispatch.check(skips, "skips", torch.bfloat16, x.shape[:-1] + (S,))
    x_out = torch.empty_like(x)
    skips_out = torch.empty(x.shape[:-1] + (S,), dtype=torch.bfloat16,
                            device=x.device)
    RESIDUAL(x.device, p.data_ptr(), bias.data_ptr(), x.data_ptr(),
             None if skips is None else skips.data_ptr(), x_out.data_ptr(),
             skips_out.data_ptr(), rows, S, R)
    return x_out, skips_out


def residual_backward(dxo, dskips):
    """dP = [dskips' | bf(dx' / sqrt(2))] (bf16)."""
    if not dispatch.use_kernel(dxo, dskips):
        return residual_backward_plain(dxo, dskips)
    R, S = dxo.shape[-1], dskips.shape[-1]
    dispatch.check(dxo, "dxo", torch.float32, dxo.shape)
    dispatch.check(dskips, "dskips", torch.bfloat16, dxo.shape[:-1] + (S,))
    dp = torch.empty(dxo.shape[:-1] + (S + R,), dtype=torch.bfloat16,
                     device=dxo.device)
    RESIDUAL_BWD(dxo.device, dxo.data_ptr(), dskips.data_ptr(),
                 dp.data_ptr(), dxo.numel() // R, S, R)
    return dp


def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _bias_grad(d):
    """A bias's gradient: the bf16-rounded float32 sum over the rows."""
    return _bf(_rows(d).sum(0, dtype=torch.float32))


class Block(torch.autograd.Function):
    """(x', skips') of one residual block; see the module docstring.

    Inputs: x (B, T, R) float32, skips (B, T, S) bf16 or None, cond
    (B, T, Cp) bf16 (its columns zero-padded to Cp >= C), the float32
    parameters: W (k, R, G), b (G,), Wc (C, G), bc (G,), [Ws | Wr]
    (G / 2, S + R), [bs | br] (S + R,), and the dilation."""

    @staticmethod
    def forward(ctx, x, skips, cond, w, b, wc, bc, wsr, bsr, dilation):
        k, R, G = w.shape
        bf16 = torch.bfloat16
        tp = taps(x, k, dilation)
        w_b = w.reshape(k * R, G).to(bf16)
        wc_b = torch.nn.functional.pad(
            wc.to(bf16), (0, 0, 0, cond.shape[-1] - wc.shape[0]))
        h, z = wavenet_gate.gate(tp @ w_b, cond @ wc_b, b, bc)
        wsr_b = wsr.to(bf16)
        x_out, skips_out = residual(z @ wsr_b, bsr, x, skips)
        ctx.save_for_backward(tp, h, z, cond, w_b, wc_b, wsr_b)
        ctx.meta = (k, dilation, wc.shape[0], skips is not None)
        return x_out, skips_out

    @staticmethod
    def backward(ctx, dxo, dskips):
        tp, h, z, cond, w_b, wc_b, wsr_b = ctx.saved_tensors
        k, dilation, C, has_skips = ctx.meta
        dxo = dxo.contiguous()
        dskips = dskips.to(torch.bfloat16).contiguous()
        dp = residual_backward(dxo, dskips)
        dwsr = (_rows(z).t() @ _rows(dp)).float()
        dh = wavenet_gate.gate_backward(h, (dp @ wsr_b.t()).contiguous())
        dw = (_rows(tp).t() @ _rows(dh)).float()
        dwc = (_rows(cond).t() @ _rows(dh))[:C].float()
        dx = taps_backward((dh @ w_b.t()).contiguous(), dxo, k, dilation)
        db = _bias_grad(dh)
        # The conditioning's gradient at its padded width, for a trainable
        # model upstream; the blocks' shares add up in bf16 on the shared
        # copy, where the plain path adds them in float32.
        dcond = dh @ wc_b.t() if ctx.needs_input_grad[2] else None
        return (dx, dskips if has_skips else None, dcond,
                dw.reshape(k, -1, dw.shape[-1]), db, dwc, db, dwsr,
                _bias_grad(dp), None)
