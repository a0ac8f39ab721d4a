"""The r9y9 WaveNet vocoder as IdiapTTS trains it, plain float32 PyTorch:
teacher-forced logits, the masked cross-entropy, gradients and Adam.

It imports nothing of the program and no kernel; it sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False itself.

The network, with the configuration's widths (R residual, G gate with
halves of H = G / 2, S skip, k taps, C conditioning columns, Q classes):

- inputs: the µ-law targets shifted by one sample, the first input
  Q / 2; x = embedding[input] (Q, R);
- 24 blocks, dilation d = 2 ** (i mod layers per stack):
  h = sum_j x[t - (k - 1 - j) d] W_j + b (causal, zero before t = 0)
  + cond_t Wc + bc; z = tanh(h[:H]) * sigmoid(h[H:]);
  skip_i = z Ws + bs; x = (x + z Wr + br) / sqrt(2);
- head: logits = relu(relu(sum_i skip_i) P1 + p1) P2 + p2;
- loss: cross-entropy of the logits against the targets, summed over
  every row's real samples and divided by their number.

It follows the port's equations (``idiaptts_torch/models/wavenet.py``,
the flax modules of the JAX package), which depart from r9y9's
``wavenet_vocoder`` modules in these ways (the configuration's
``assumed`` list holds the same):

- the input is an embedding of the µ-law class, where r9y9 applies a
  1x1 convolution with a bias to the one-hot input;
- no weight normalisation on the convolutions, and no dropout before the
  dilated convolution (r9y9: p = 0.05);
- the conditioning projection carries a bias (r9y9: ``bias=False``);
- the skip sum is not scaled by sqrt(1 / layers);
- the conditioning is linearly upsampled outside the network (IdiapTTS's
  ``sample_linearly``), not by a learnt upsampling network;
- Adam without r9y9's exponential moving average of the weights.

``precision="fp8"`` is the control, the precision step below the
configuration's bf16: both operands of every matrix product are rounded
to float8 (e4m3, one scale a tensor that puts its largest magnitude at
448), and in the backward the gradient reaching each rounded operand is
rounded too (e5m2, its largest magnitude at 57344), as float8 training
does.

A batch the size of the cell's (32 x 8192 samples at 512 channels)
would hold ~76 GB of float32 activations for autograd, so a step runs in
blocks of rows: each block's part of the loss (its rows' sum over the
whole batch's count) is differentiated alone and the gradients summed.
"""

import math

import numpy as np
import torch

FP8 = ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0))


def _round(x, kind):
    dtype, top = FP8[kind]
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, 0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, 1)


def upsample(frames, factor):
    """Each column of (T, C) frames linearly interpolated at
    ``factor * T`` points spaced evenly over [0, T - 1]."""
    frames = np.asarray(frames, np.float64)
    T = frames.shape[0]
    at = np.linspace(0.0, T - 1, num=factor * T)
    grid = np.arange(T, dtype=np.float64)
    return np.stack([np.interp(at, grid, frames[:, c])
                     for c in range(frames.shape[1])], 1).astype(np.float32)


class WaveNet:
    """The network over a dict of float32 parameters named as the
    configuration's layout (``wavenet.block_<i>.dilated.kernel`` ...)."""

    def __init__(self, params, layers, stacks, classes, precision="float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = params
        self.layers = int(layers)
        self.per_stack = self.layers // int(stacks)
        self.classes = int(classes)
        self.q = _Fp8.apply if precision == "fp8" else (lambda x: x)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def block(self, i, x, cond):
        w = lambda n: self.p["wavenet.block_{}.{}".format(i, n)]  # noqa
        kernel = w("dilated.kernel")
        k, R, G = kernel.shape
        d = 2 ** (i % self.per_stack)
        T = x.shape[1]
        h = w("dilated.bias") + self.mm(cond, w("cond.kernel")) \
            + w("cond.bias")
        for j in range(k):
            shift = (k - 1 - j) * d
            past = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :T]
            h = h + self.mm(past, kernel[j])
        z = torch.tanh(h[..., :G // 2]) * torch.sigmoid(h[..., G // 2:])
        skip = self.mm(z, w("skip.kernel")) + w("skip.bias")
        res = self.mm(z, w("res.kernel")) + w("res.bias")
        return (x + res) / math.sqrt(2.0), skip

    def __call__(self, targets, cond):
        """targets (B, T) µ-law classes, cond (B, T, C) -> (B, T, Q)."""
        inputs = torch.nn.functional.pad(targets, (1, 0),
                                         value=self.classes // 2)[:, :-1]
        x = self.p["wavenet.input_embed.embedding"][inputs]
        skips = 0.0
        for i in range(self.layers):
            x, skip = self.block(i, x, cond)
            skips = skips + skip
        h = torch.relu(skips)
        h = torch.relu(self.mm(h, self.p["wavenet.post1.kernel"])
                       + self.p["wavenet.post1.bias"])
        return self.mm(h, self.p["wavenet.post2.kernel"]) \
            + self.p["wavenet.post2.bias"]


def masked_ce(logits, targets, lengths):
    """Summed cross-entropy over the samples inside each row's length."""
    T = logits.shape[1]
    mask = torch.arange(T, device=logits.device)[None] \
        < lengths.to(logits.device)[:, None]
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
        reduction="none").reshape(targets.shape)
    return (ce * mask).sum()


def row_gaps(logits, ref, lengths):
    """Each row's ||logits - ref|| / ||ref|| over its real samples."""
    out = []
    for r in range(ref.shape[0]):
        n = int(lengths[r])
        a = logits[r, :n].double()
        b = ref[r, :n].double()
        out.append(float((a - b).norm() / b.norm().clamp(min=1e-30)))
    return out


class Trainer:
    """The reference's parameters and Adam state (b1 0.9, b2 0.999, eps
    1e-8, bias-corrected), stepped on whole batches in row blocks."""

    def __init__(self, weights, layers, stacks, classes, lr, device,
                 precision="float32", rows_per_block=4, betas=(0.9, 0.999),
                 eps=1e-8):
        self.params = {k: v.detach().clone().to(device).requires_grad_(True)
                       for k, v in weights.items()}
        self.net = WaveNet(self.params, layers, stacks, classes, precision)
        self.lr, self.betas, self.eps = float(lr), betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.device = device
        self.rows_per_block = int(rows_per_block)

    def gradients(self, targets, cond, lengths, keep=None, logits=None):
        """(loss, {name: gradient}) of a batch: targets (B, T) long, cond
        (B, T, C), lengths (B,).  ``keep`` plants a fault: only the first
        ``keep`` rows, the mean over theirs.  With ``logits`` (the
        program's, (B, T, Q)), also each row's gap against the
        reference's."""
        if keep is not None:
            targets, cond, lengths = targets[:keep], cond[:keep], \
                lengths[:keep]
        count = float(lengths.sum())
        names = list(self.params)
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        loss, gaps = 0.0, []
        for r0 in range(0, targets.shape[0], self.rows_per_block):
            rows = slice(r0, r0 + self.rows_per_block)
            t = targets[rows].to(self.device)
            n = lengths[rows]
            out = self.net(t, cond[rows].to(self.device))
            if logits is not None:
                gaps += row_gaps(logits[rows].to(self.device),
                                 out.detach(), n)
            part = masked_ce(out, t, n) / count
            # The last block's residual output is unused: no gradient.
            for k, g in zip(names, torch.autograd.grad(
                    part, [self.params[k] for k in names],
                    allow_unused=True)):
                if g is not None:
                    grads[k] += g
            loss += float(part.detach())
            del out, part
        return loss, grads, gaps

    def step(self, targets, cond, lengths, keep=None, logits=None):
        """One Adam step; returns (loss, {name: gradient}, row gaps)."""
        loss, grads, gaps = self.gradients(targets, cond, lengths, keep,
                                           logits)
        self.t += 1
        b1, b2 = self.betas
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m_hat = self.m[k] / (1.0 - b1 ** self.t)
                v_hat = self.v[k] / (1.0 - b2 ** self.t)
                self.params[k].sub_(self.lr * m_hat
                                    / (v_hat.sqrt() + self.eps))
        return loss, grads, gaps
