"""Config-built acoustic model stacks: the port of
``idiaptts_tpu/models/rnn_dyn.py`` for serving and training.

The legacy model-string grammar (:func:`convert_legacy_string`,
``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67``) and every layer type of the
JAX ``RNNDyn._apply_group`` build: Linear/FC, LSTM (bidirectional through
the hand BiLSTM kernels, unidirectional as ``_FastLSTM``), GRU and simple
RNN cells (uni- and bidirectional), Conv1d, BatchNorm1d, Embedding and
the per-group EMB embeddings, SelectLast and Mean pooling, VanillaVAE,
Softmax, LogSoftmax, Exp, Mask, ApplyFunction, Dropout, AlwaysDropout and
Custom, with ``remat`` as ``torch.utils.checkpoint``.

Numerics follow the JAX model:

- Dense layers take bf16 inputs and weights and give a bf16 result
  (``flax.linen.Dense(dtype=bfloat16)``); the bias is added in bf16 and
  the nonlinearity runs in bf16.  These are plain ``torch.matmul`` calls
  on bf16 tensors: the JAX package computes them outside any Pallas
  kernel.
- Each BiLSTM layer runs through
  :func:`idiaptts_torch.ops.cuda_lstm.bilstm_layer_tmajor` (the
  projection and recurrence kernels on CUDA) for inference, and through
  :class:`idiaptts_torch.ops.cuda_lstm.BiLSTMLayerFn` (projection,
  training-mode recurrence, reverse-time backward kernel) when
  ``forward(..., training=True)`` under autograd.
- The unidirectional LSTM, GRU and simple RNN are step loops in plain
  PyTorch on every device (XLA scans in the JAX package, no Pallas
  kernel).  The x-side products of all steps are one GEMM before the
  loop, and both directions of a layer run in one loop.  The GRU and
  simple cell repeat flax 0.12.3's ``GRUCell`` / ``SimpleCell`` with
  ``dtype=bfloat16`` as XLA compiles them: every product, sum and
  activation rounds to bf16, the sigmoid as ``1 / (1 + exp(-x))`` one
  bf16 operation at a time, the carry starts as float32 zeros, and the
  GRU's ``z * h`` lifts the carry back to float32.  Where a bf16 value
  is converted to float32, XLA keeps the value it had before rounding:
  ``z`` in ``z * h`` is the unrounded 1 / (1 + e), ``(1 - z) * n`` a
  float32 product, and ``_FastLSTM``'s recurrent product h·Wh is not
  rounded (its input projection is).  The simple cell's new carry is
  bf16 in flax, which the JAX scan refuses against its float32 initial
  carry; the port keeps it as float32, which holds the same values.
- Conv1d is ``flax.linen.Conv`` in float32 (explicit, ``SAME``,
  ``VALID`` or ``CAUSAL`` padding, stride, dilation, feature groups);
  its kernel keeps flax's (K, in/groups, out) layout.
  The sequence lengths follow the convolution (the JAX model keeps them,
  which reads outside a shortened sequence).
- BatchNorm1d is ``flax.linen.BatchNorm``: statistics over every axis
  but the last, padded frames included, variance as E[x²] - E[x]²,
  epsilon 1e-5, running averages with momentum 0.99 as buffers.
- Dropout (between recurrent layers, after Dense layers, the Dropout
  and AlwaysDropout groups) and the VAE's latent draw take their random
  numbers from the ``generator`` passed to ``forward``; AlwaysDropout is
  active at inference too, so it needs one there as well.
- The model output is float32.

Tensor parallelism (``parallel/mesh.py``'s ``shard_module``) shards two
layers over the model group of a ``(data, model)`` mesh:

- a Dense layer is column-parallel: its input enters through
  ``copy_to_model`` (its gradient summed over the group), the rank's
  kernel columns make a local bf16 ``torch.matmul``, the group gathers
  the columns, and the replicated bias is added to the whole, as the JAX
  layer adds it;
- a BiLSTM layer is split by direction: model rank r runs direction
  r % 2 on row block r // 2 of the batch (the backward direction's rank
  builds its reversed input with ``masked_flip``) through the kernels'
  one-direction instances, and the group gathers ``[out_f | out_b]``.
  No collective runs inside the recurrence.

Parameter names mirror the flax tree (``g0_Linear_0.kernel``,
``g2_LSTM.bi0.Wx``, ``g1_GRU.fwd0.ir.kernel``, ``emb_0.embedding``) and
BatchNorm's running averages are the buffers ``<group>.mean`` and
``<group>.var`` (flax's ``batch_stats``), so
:mod:`idiaptts_torch.models.convert` maps a JAX checkpoint by name.
"""

import inspect
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import NamedForwardWrapper
from idiaptts_torch.ops.cuda_lstm import BiLSTMLayerFn, bilstm_layer_tmajor
from idiaptts_torch.parallel.mesh import (all_reduce_sum, copy_to_model,
                                          direction_rows, gather_from_model)

IDENTIFIER = "RNNDYN"

_NONLINS = {
    "ReLU": torch.relu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "SELU": F.selu,
    "LeakyReLU": F.leaky_relu,     # flax's slope 0.01 is torch's default
    "Softsign": F.softsign,
    "relu": torch.relu,
    "tanh": torch.tanh,
}

_RECURRENT = ("LSTM", "GRU", "RNN")
_SAME_DIM = ("BatchNorm1d", "SelectLastPooling", "MeanPooling", "Softmax",
             "LogSoftmax", "Exp", "Dropout", "Mask", "ApplyFunction",
             "AlwaysDropout")


def parse_int_set(nputstr):
    """Parse '0,2-5,7' or '-1' style index sets; -1 means "all groups"."""
    selection = set()
    for token in str(nputstr).replace("(", "").replace(")", "").split(","):
        token = token.strip()
        if not token:
            continue
        if re.fullmatch(r"-?\d+", token):
            selection.add(int(token))
        elif "-" in token:
            lo, hi = token.split("-")
            selection.update(range(int(lo), int(hi) + 1))
        else:
            raise ValueError("Cannot parse int set token: " + token)
    return selection


class LayerConfig:
    """One layer group."""

    def __init__(self, layer_type, out_dim=None, num_layers=1, nonlin=None,
                 dropout=0.0, bidirectional=False, kernel_size=None,
                 stride=1, padding=None, dilation=1, groups=1,
                 num_embeddings=None, batch_first=True, **kwargs):
        self.layer_type = layer_type
        self.out_dim = int(out_dim) if out_dim is not None else None
        self.num_layers = num_layers
        self.nonlin = nonlin
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.num_embeddings = num_embeddings
        self.batch_first = batch_first
        self.extra = kwargs


class EmbeddingConfig:
    """Embedding applied to specific layer groups; the embedding index
    arrives as a trailing input column."""

    def __init__(self, embedding_dim, name, num_embeddings,
                 affected_layer_group_indices=(-1,)):
        self.embedding_dim = int(embedding_dim)
        self.name = name
        self.num_embeddings = int(num_embeddings)
        self.affected_layer_group_indices = set(
            affected_layer_group_indices)


def _affects(emb_config, group_idx, num_groups):
    """Whether an embedding is concatenated to group ``group_idx``'s
    input: -1 means every group, other negative indices count from the
    end."""
    idx_set = emb_config.affected_layer_group_indices
    return (-1 in idx_set or group_idx in idx_set
            or (group_idx - num_groups) in idx_set)


def _gather_time(x, idx):
    """x (B, T, ...) gathered along time by idx (B, T)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def masked_flip(x, lengths):
    """Reverse each sequence of (B, T, ...) within its valid length;
    padding stays at the tail (packed-sequence reverse semantics)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    lengths = lengths.to(x.device)[:, None]
    return _gather_time(x, torch.where(t < lengths, lengths - 1 - t, t))


def flip_sequences(x, lengths):
    """``flax.linen.recurrent.flip_sequences`` for batch-major (B, T, ...):
    each sequence reversed within its length, the padding reversed after
    it (index (T - 1 - t + length) mod T).  Its own inverse."""
    if lengths is None:
        return x.flip(1)
    T = x.shape[1]
    t = torch.arange(T - 1, -1, -1, device=x.device)[None, :]
    return _gather_time(x, (t + lengths.to(x.device)[:, None]) % T)


def _dropout(x, p, training, generator):
    """Inverted dropout (``flax.linen.Dropout``) with masks drawn from
    ``generator``; the identity outside training or at ``p == 0``."""
    if not training or not p:
        return x
    if generator is None:
        raise ValueError("dropout {} needs a torch.Generator "
                         "(forward(..., generator=...))".format(p))
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _bf16_exact(x):
    """Round to bf16 and return float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _lecun_normal_(tensor, fan_in, generator):
    """flax's lecun_normal: truncated normal, variance 1/fan_in."""
    std = float(np.sqrt(1.0 / fan_in)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class _Dense(nn.Module):
    """``flax.linen.Dense``: (in, out) kernel.  In bf16 by default
    (``dtype=bfloat16``); ``dtype=None`` computes in float32, as flax
    does for a float32 kernel.  The kernel is drawn lecun_normal, or
    orthogonal for a recurrent cell's ``h`` layers.  With ``model_mesh``
    (set by ``shard_module``) the kernel is this rank's columns and the
    layer is column-parallel."""

    model_mesh = None

    def __init__(self, in_dim, out_dim, bias=True, dtype=torch.bfloat16,
                 orthogonal=False):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.orthogonal = orthogonal
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_dim))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator):
        if self.orthogonal:
            with torch.no_grad():
                nn.init.orthogonal_(self.kernel, generator=generator)
        else:
            _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        mesh = self.model_mesh
        if mesh is not None:
            x = copy_to_model(x, mesh)
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if mesh is not None:
            cols = y.shape[-1]
            start = mesh.model.rank * cols
            y = gather_from_model(
                y, mesh, y.shape[:-1] + (cols * mesh.model.size,),
                (Ellipsis, slice(start, start + cols)))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class _BiFastLSTM(nn.Module):
    """Both directions of one BiLSTM layer: per-direction ``Wx (2, D,
    4F)``, ``Wh (2, F, 4F)`` and ``b (2, 4F)``; forget-gate bias +1 and
    gate order [i, f, g, o] are in the kernel.  With ``model_mesh`` (set
    by ``shard_module``) the parameters are this rank's direction,
    ``(1, D, 4F)``, ``(1, F, 4F)`` and ``(1, 4F)``, and
    :meth:`forward_sharded` runs the layer."""

    model_mesh = None

    def __init__(self, in_dim, features):
        super().__init__()
        F_ = int(features)
        self.features = F_
        self.Wx = nn.Parameter(torch.empty(2, in_dim, 4 * F_))
        self.Wh = nn.Parameter(torch.empty(2, F_, 4 * F_))
        self.b = nn.Parameter(torch.zeros(2, 4 * F_))

    def reset_parameters(self, generator):
        _lecun_normal_(self.Wx, 2 * self.Wx.shape[1], generator)
        with torch.no_grad():
            for d in range(2):
                nn.init.orthogonal_(self.Wh[d], generator=generator)
            self.b.zero_()

    def forward(self, x, x_rev, training=False, residuals_bf16=False):
        """x, x_rev: (B, T, D).  Returns (out_f, out_b_rev), each
        (B, T, F) float32.  With ``training`` and autograd on, the layer
        saves its backward residuals (float32, or bf16 with
        ``residuals_bf16``) and differentiates through the kernels."""
        B, T, D = x.shape
        F_ = self.features
        xin_t = torch.stack([x, x_rev]).to(torch.bfloat16)   # (2, B, T, D)
        xin_t = xin_t.permute(2, 0, 1, 3).reshape(T, 2 * B, D).contiguous()
        wh_cat = torch.cat([self.Wh[0], self.Wh[1]], dim=0)
        if training and torch.is_grad_enabled():
            hs = BiLSTMLayerFn.apply(xin_t, self.Wx, wh_cat, self.b,
                                     residuals_bf16)
        else:
            hs = bilstm_layer_tmajor(xin_t, self.Wx, wh_cat, self.b)
        hs = hs.reshape(T, 2, B, F_)
        return hs[:, 0].transpose(0, 1), hs[:, 1].transpose(0, 1)

    def forward_sharded(self, x, lengths=None, training=False,
                        residuals_bf16=False):
        """The layer split by direction over the model group: this rank's
        direction on its row block (``direction_rows``) through the
        one-direction kernels, its output (the backward direction's
        flipped back) gathered into ``[out_f | out_b]`` (B, T, 2F)
        float32 on every rank of the group."""
        mesh = self.model_mesh
        B, T, _ = x.shape
        F_ = self.features
        d, lo, hi, gives = direction_rows(B, mesh)
        x = copy_to_model(x, mesh)[lo:hi]
        rows = lengths[lo:hi] if lengths is not None else None
        if d == 1:
            x = masked_flip(x, rows) if rows is not None else x.flip(1)
        xin_t = x.to(torch.bfloat16).transpose(0, 1).contiguous()
        if training and torch.is_grad_enabled():
            hs = BiLSTMLayerFn.apply(xin_t, self.Wx, self.Wh[0], self.b,
                                     residuals_bf16)
        else:
            hs = bilstm_layer_tmajor(xin_t, self.Wx, self.Wh[0], self.b)
        out = hs.transpose(0, 1)
        if d == 1:
            out = masked_flip(out, rows) if rows is not None \
                else out.flip(1)
        index = (slice(lo, hi), slice(None), slice(d * F_, (d + 1) * F_)) \
            if gives else None
        return gather_from_model(out, mesh, (B, T, 2 * F_), index)


class _FastLSTM(nn.Module):
    """Unidirectional LSTM with the input projection hoisted out of the
    step loop: xp = bf16(x)·bf16(Wx) rounded to bf16, then + b in
    float32; per step gates = xp_t + bf16(h)·bf16(Wh) (float32 product,
    not rounded), forget bias +1,
    gate order [i, f, g, o], h and c in float32."""

    def __init__(self, in_dim, features):
        super().__init__()
        F_ = int(features)
        self.features = F_
        self.Wx = nn.Parameter(torch.empty(in_dim, 4 * F_))
        self.Wh = nn.Parameter(torch.empty(F_, 4 * F_))
        self.b = nn.Parameter(torch.zeros(4 * F_))

    def reset_parameters(self, generator):
        _lecun_normal_(self.Wx, self.Wx.shape[0], generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.Wh, generator=generator)
            self.b.zero_()

    def forward(self, x, lengths=None, reverse=False):
        B, T, _ = x.shape
        F_ = self.features
        if reverse:
            x = masked_flip(x, lengths) if lengths is not None \
                else x.flip(1)
        xp = torch.matmul(x.to(torch.bfloat16),
                          self.Wx.to(torch.bfloat16)).float() + self.b
        wh = _bf16_exact(self.Wh)
        h = x.new_zeros(B, F_, dtype=torch.float32)
        c = torch.zeros_like(h)
        hs = []
        # unbind: the backward gathers the steps' gradients in one stack
        # (a slice a step would add a full-size gradient a step).
        for xp_t in xp.unbind(1):
            gates = xp_t + torch.matmul(_bf16_exact(h), wh)
            i, f, g, o = gates.split(F_, dim=-1)
            c = torch.sigmoid(f + 1.0) * c \
                + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, dim=1)
        if reverse:
            out = masked_flip(out, lengths) if lengths is not None \
                else out.flip(1)
        return out


class _GRUCell(nn.Module):
    """``flax.linen.GRUCell`` parameters: input Dense layers ``ir``,
    ``iz``, ``in`` (kernel (D, F), bias) and recurrent ones ``hr``,
    ``hz`` (no bias) and ``hn`` (with bias)."""

    GATES = ("r", "z", "n")

    def __init__(self, in_dim, features):
        super().__init__()
        for g in self.GATES:
            self.add_module("i" + g, _Dense(in_dim, features))
            self.add_module("h" + g, _Dense(features, features,
                                            bias=(g == "n"),
                                            orthogonal=True))

    def input_weights(self):
        """(D, 3F) kernel and (3F,) bias of the x-side products."""
        return (torch.cat([getattr(self, "i" + g).kernel
                           for g in self.GATES], dim=1),
                torch.cat([getattr(self, "i" + g).bias
                           for g in self.GATES]))

    def recurrent_weights(self):
        """(F, 3F) kernel of the h-side products and hn's (F,) bias."""
        return (torch.cat([getattr(self, "h" + g).kernel
                           for g in self.GATES], dim=1), self.hn.bias)


class _SimpleCell(nn.Module):
    """``flax.linen.SimpleCell`` parameters: ``i`` (kernel (D, F), bias)
    and ``h`` (kernel (F, F), no bias)."""

    def __init__(self, in_dim, features):
        super().__init__()
        self.i = _Dense(in_dim, features)
        self.h = _Dense(features, features, bias=False, orthogonal=True)

    def input_weights(self):
        return self.i.kernel, self.i.bias

    def recurrent_weights(self):
        return self.h.kernel, None


def _cell_loop(cells, xs, act):
    """Both directions of a GRU or simple RNN layer in one step loop.

    cells: one ``_GRUCell`` or ``_SimpleCell`` a direction; xs (nd, B, T,
    D), each direction's input in its own time order.  Returns (nd, B, T,
    F) float32."""
    bf16 = torch.bfloat16
    wi, bi = zip(*(c.input_weights() for c in cells))
    wh, bh = zip(*(c.recurrent_weights() for c in cells))
    # All steps' x-side products as one GEMM: bf16 product, bf16 bias.
    xi = torch.matmul(xs.to(bf16), torch.stack(wi).to(bf16)[:, None]) \
        + torch.stack(bi).to(bf16)[:, None, None]
    # The per-step product in float32 on bf16 values: a bf16 product with
    # float32 accumulation on every device (and no slow bf16 batched
    # GEMMs in the CPU backward).
    wh = _bf16_exact(torch.stack(wh))                    # (nd, F, G)
    nd, B, _, G = xi.shape
    is_gru = isinstance(cells[0], _GRUCell)
    F_ = G // 3 if is_gru else G
    bhn = torch.stack(bh).to(bf16)[:, None] if is_gru else None
    h = xi.new_zeros(nd, B, F_, dtype=torch.float32)
    hs = []
    for x_t in xi.unbind(2):     # one stacked gradient in the backward
        hh = torch.bmm(_bf16_exact(h), wh).to(bf16)      # (nd, B, G)
        if is_gru:
            # sigmoid = 1 / (1 + exp(-x)), each step rounded to bf16.
            e = 1.0 + torch.exp(-(x_t[..., :2 * F_] + hh[..., :2 * F_]))
            r, z = torch.reciprocal(e).split(F_, dim=-1)
            n = torch.tanh(x_t[..., 2 * F_:] + r * (hh[..., 2 * F_:] + bhn))
            # Where a bf16 value meets the float32 carry, XLA keeps its
            # float32 precision: z·h takes the unrounded 1 / (1 + e), and
            # (1 - z)·n is a float32 product of the rounded operands.
            h = (1.0 - z).float() * n.float() \
                + torch.reciprocal(e[..., F_:].float()) * h
        else:
            h = act(x_t + hh).float()
        hs.append(h)
    return torch.stack(hs, dim=2)


class _MaskedFlipRNN(nn.Module):
    """Uni/bi-directional recurrent stack with length-aware reverse:
    bidirectional LSTM layers ``bi{l}`` (the hand kernels),
    unidirectional ones ``fwd{l}`` (:class:`_FastLSTM`), GRU and simple
    RNN cells ``fwd{l}`` / ``bwd{l}``; dropout between layers."""

    def __init__(self, cell_type, in_dim, out_dim, num_layers,
                 bidirectional, dropout=0.0, nonlin=None):
        super().__init__()
        if cell_type not in _RECURRENT:
            raise NotImplementedError(cell_type)
        self.cell_type = cell_type
        self.bidirectional = bool(bidirectional)
        self.num_layers = int(num_layers)
        self.dropout = float(dropout or 0.0)
        self.act = _NONLINS.get(nonlin or "tanh", torch.tanh)
        cell = {"GRU": _GRUCell, "RNN": _SimpleCell}.get(cell_type)
        for layer in range(self.num_layers):
            if cell_type == "LSTM" and self.bidirectional:
                self.add_module("bi{}".format(layer),
                                _BiFastLSTM(in_dim, out_dim))
            elif cell_type == "LSTM":
                self.add_module("fwd{}".format(layer),
                                _FastLSTM(in_dim, out_dim))
            else:
                self.add_module("fwd{}".format(layer), cell(in_dim, out_dim))
                if self.bidirectional:
                    self.add_module("bwd{}".format(layer),
                                    cell(in_dim, out_dim))
            in_dim = out_dim * (2 if self.bidirectional else 1)
        self.out_dim = in_dim

    def forward(self, x, lengths=None, training=False, generator=None,
                residuals_bf16=False):
        for layer in range(self.num_layers):
            bi = getattr(self, "bi{}".format(layer), None)
            if bi is not None and bi.model_mesh is not None:
                x = bi.forward_sharded(x, lengths, training, residuals_bf16)
            elif bi is not None:
                x_rev = masked_flip(x, lengths) if lengths is not None \
                    else x.flip(1)
                out_f, out_b_rev = bi(x, x_rev, training, residuals_bf16)
                out_b = masked_flip(out_b_rev, lengths) \
                    if lengths is not None else out_b_rev.flip(1)
                x = torch.cat([out_f, out_b], dim=-1)
            elif self.cell_type == "LSTM":
                x = getattr(self, "fwd{}".format(layer))(x, lengths)
            else:
                cells = [getattr(self, "fwd{}".format(layer))]
                xs = [x]
                if self.bidirectional:
                    # nn.RNN(reverse=True, keep_order=True, seq_lengths=...)
                    cells.append(getattr(self, "bwd{}".format(layer)))
                    xs.append(flip_sequences(x, lengths))
                out = _cell_loop(cells, torch.stack(xs), self.act)
                x = out[0] if not self.bidirectional else torch.cat(
                    [out[0], flip_sequences(out[1], lengths)], dim=-1)
            if layer < self.num_layers - 1:
                x = _dropout(x, self.dropout, training, generator)
        return x


def _conv_tuple(value, trailing, what):
    """A Conv1d kernel/stride/dilation (``trailing`` 1) or padding
    (``trailing`` 0) as a 1-tuple.  The legacy grammar writes a kernel
    as ``3x1``: the entries after the first must be ``trailing``."""
    if np.isscalar(value):
        return (int(value),)
    value = tuple(int(v) for v in value)
    if any(v != trailing for v in value[1:]):
        raise ValueError("Conv1d takes a 1-D {}, got {}".format(what, value))
    return value[:1]


class _Conv1d(nn.Module):
    """``flax.linen.Conv`` over (B, T, C) in float32: ``kernel`` (K,
    in/groups, out) as flax lays it out, ``bias`` (out,)."""

    def __init__(self, in_dim, out_dim, kernel_size, stride=1, padding=None,
                 dilation=1, groups=1):
        super().__init__()
        self.k = _conv_tuple(kernel_size, 1, "kernel")[0]
        self.stride = _conv_tuple(stride, 1, "stride")[0]
        self.dilation = _conv_tuple(dilation, 1, "dilation")[0]
        self.groups = int(groups)
        if padding is None:
            padding = "SAME"
        if isinstance(padding, str):
            if padding not in ("SAME", "VALID", "CAUSAL"):
                raise ValueError("Conv1d padding " + padding)
            self.padding = padding
        else:
            self.padding = _conv_tuple(padding, 0, "padding")[0]
        if in_dim % self.groups or out_dim % self.groups:
            raise ValueError("Conv1d groups {} must divide {} and {}".format(
                self.groups, in_dim, out_dim))
        self.kernel = nn.Parameter(torch.empty(self.k, in_dim // self.groups,
                                               out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        _lecun_normal_(self.kernel,
                       self.kernel.shape[0] * self.kernel.shape[1],
                       generator)
        with torch.no_grad():
            self.bias.zero_()

    def pads(self, T):
        """(low, high) zero padding of the time axis for T frames."""
        span = (self.k - 1) * self.dilation + 1
        if self.padding == "SAME":
            out = -(-T // self.stride)
            total = max((out - 1) * self.stride + span - T, 0)
            return total // 2, total - total // 2
        if self.padding == "VALID":
            return 0, 0
        if self.padding == "CAUSAL":
            return span - 1, 0
        return self.padding, self.padding

    def out_lengths(self, lengths, T):
        """The frames of each sequence that the convolution leaves: as
        many outputs as fit in its padded frames, at most the padded
        output's length."""
        lo, hi = self.pads(T)
        span = (self.k - 1) * self.dilation + 1
        t_out = (T + lo + hi - span) // self.stride + 1
        n = torch.div(lengths + lo + hi - span, self.stride,
                      rounding_mode="floor") + 1
        return n.clamp(0, t_out)

    def forward(self, x):
        x = x.to(torch.float32).transpose(1, 2)              # (B, C, T)
        lo, hi = self.pads(x.shape[-1])
        x = F.pad(x, (lo, hi))
        y = F.conv1d(x, self.kernel.permute(2, 1, 0), self.bias,
                     stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        return y.transpose(1, 2)


class _BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(axis=-1)``: parameters ``scale`` and
    ``bias``, running averages ``mean`` and ``var`` as buffers.  With
    ``data_mesh`` set (a tensor-parallel step whose batch shards over the
    data group) the batch statistics are those of the data group's rows,
    as the JAX tensor-parallel step (GSPMD) computes them."""

    data_mesh = None

    def __init__(self, dim, momentum=0.99, epsilon=1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, training=False, update_stats=True):
        if training:
            xf = x.to(torch.float32)
            axes = tuple(range(x.dim() - 1))
            mean, msq = xf.mean(axes), (xf * xf).mean(axes)
            if self.data_mesh is not None:
                mean, msq = (all_reduce_sum(torch.stack([mean, msq]),
                                            self.data_mesh)
                             / self.data_mesh.size).unbind()
            var = torch.clamp(msq - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean
        return y * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class _Embed(nn.Module):
    """``flax.linen.Embed``: an ``embedding`` table (num, features)."""

    def __init__(self, num_embeddings, features):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator):
        # variance_scaling(1, fan_in, normal, out_axis=0): std 1/sqrt(F).
        std = float(np.sqrt(1.0 / self.embedding.shape[1]))
        with torch.no_grad():
            self.embedding.normal_(0.0, std, generator=generator)

    def forward(self, idx):
        return self.embedding[idx.to(torch.int64)]


class VanillaVAE(nn.Module):
    """Reparameterised VAE bottleneck: float32 Dense layers ``mu`` and
    ``logvar``; in training the latent is mu + exp(logvar / 2)·ε with ε
    from the generator, else mu.  mu and logvar go into the caller's
    ``intermediates`` dict as ``vae_mu`` / ``vae_logvar``."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.mu = _Dense(in_dim, out_dim, dtype=None)
        self.logvar = _Dense(in_dim, out_dim, dtype=None)

    def forward(self, x, training=False, generator=None, intermediates=None,
                prefix=""):
        mu, logvar = self.mu(x), self.logvar(x)
        if training:
            if generator is None:
                raise ValueError("VanillaVAE in training needs a "
                                 "torch.Generator for its latent draw")
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
        else:
            z = mu
        if intermediates is not None:
            intermediates[prefix + "vae_mu"] = mu
            intermediates[prefix + "vae_logvar"] = logvar
        return z


def _time_mask(x, lengths):
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    return (t < lengths.to(x.device)[:, None]).to(x.dtype)[..., None]


def _takes_lengths(module):
    """Whether a Custom module's forward takes ``lengths`` and
    ``training`` (else it is called with x alone)."""
    params = inspect.signature(module.forward).parameters
    return "lengths" in params or any(
        p.kind == p.VAR_KEYWORD for p in params.values())


class RNNDyn(nn.Module):
    """Sequential layer-group stack built from a :class:`Config`, with
    the per-group embedding concatenation of the JAX model."""

    def __init__(self, config):
        super().__init__()
        if config.in_dim is None:
            raise ValueError("RNNDyn needs config.in_dim")
        self.emb_configs = list(config.emb_configs)
        self.layer_configs = list(config.layer_configs)
        for emb in self.emb_configs:
            self.add_module("emb_" + str(emb.name),
                            _Embed(emb.num_embeddings, emb.embedding_dim))
        num_groups = len(self.layer_configs)
        self._names = []
        dim = int(np.prod(config.in_dim))
        for g_idx, layer in enumerate(self.layer_configs):
            dim += sum(e.embedding_dim for e in self.emb_configs
                       if _affects(e, g_idx, num_groups))
            name = "g{}_{}".format(g_idx, layer.layer_type)
            self._names.append(name)
            dim = self._build_group(name, layer, dim)
        self.out_dim = dim

    def _build_group(self, name, layer, dim):
        """Register the group's modules; returns its output width."""
        t = layer.layer_type
        if t in ("Linear", "FC", "LIN"):
            for i in range(layer.num_layers):
                self.add_module("{}_{}".format(name, i),
                                _Dense(dim, layer.out_dim))
                dim = layer.out_dim
            return dim
        if t in _RECURRENT:
            rnn = _MaskedFlipRNN(t, dim, layer.out_dim, layer.num_layers,
                                 layer.bidirectional, layer.dropout,
                                 layer.nonlin)
            self.add_module(name, rnn)
            return rnn.out_dim
        if t.startswith("Conv1d"):
            for i in range(layer.num_layers):
                self.add_module("{}_{}".format(name, i), _Conv1d(
                    dim, layer.out_dim, layer.kernel_size, layer.stride,
                    layer.padding, layer.dilation, layer.groups))
                dim = layer.out_dim
            return dim
        if t == "BatchNorm1d":
            self.add_module(name, _BatchNorm(dim))
            return dim
        if t == "Embedding":
            self.add_module(name, _Embed(layer.num_embeddings,
                                         layer.out_dim))
            return layer.out_dim
        if t == "VanillaVAE":
            self.add_module(name, VanillaVAE(dim, layer.out_dim))
            return layer.out_dim
        if t == "Custom":
            factory = layer.extra.get("module")
            if factory is None:
                raise ValueError("Custom layer needs extra={'module': "
                                 "<torch module or factory>}")
            module = factory if isinstance(factory, nn.Module) \
                else factory()
            self.add_module(name, module)
            return layer.out_dim or dim
        if t == "ApplyFunction" and layer.extra.get("function") is None:
            raise ValueError("ApplyFunction needs a function")
        if t in _SAME_DIM:
            return dim
        raise NotImplementedError("Unknown layer type " + t)

    def reset_parameters(self, generator):
        """Draw every parameter of this module's layers from
        ``generator``, in module order (a Custom module keeps its own)."""
        for module in self.modules():
            if module is not self and type(module).__module__ == __name__ \
                    and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, inputs, lengths=None, training=False, generator=None,
                residuals_bf16=False, intermediates=None):
        """inputs (B, T, D + number of EMB groups) -> (B, T, out_dim)
        float32 (time pooled away by a pooling group).

        ``training`` turns on dropout and the VAE's latent draw (random
        numbers from ``generator``), BatchNorm's batch statistics and
        running-average update and, under autograd, the BiLSTM layers'
        training kernels with float32 residuals, or bf16 ones with
        ``residuals_bf16``.  ``intermediates``, a dict, receives the
        VAE's ``<group>/vae_mu`` and ``<group>/vae_logvar``."""
        num_embs = len(self.emb_configs)
        x = inputs[..., :-num_embs] if num_embs else inputs
        embeddings = [getattr(self, "emb_" + str(e.name))(
            inputs[..., x.shape[-1] + k]) for k, e in
            enumerate(self.emb_configs)]
        state = {"lengths": lengths, "recompute": False}
        num_groups = len(self.layer_configs)
        for g_idx, layer in enumerate(self.layer_configs):
            for e_idx, emb_cfg in enumerate(self.emb_configs):
                if _affects(emb_cfg, g_idx, num_groups):
                    x = _concat_embedding(x, embeddings[e_idx])
            args = (g_idx, layer, training, generator, residuals_bf16,
                    intermediates, state)
            if layer.extra.get("remat") and training \
                    and torch.is_grad_enabled():
                x = self._remat_group(x, args)
            else:
                x = self._apply_group(x, *args)
        return x.to(torch.float32)

    def _remat_group(self, x, args):
        """The group under ``torch.utils.checkpoint``: its activations
        are recomputed in the backward pass, from the lengths it saw,
        replaying the generator's draws from its state before the group;
        the recompute updates no running statistics and records no
        intermediates."""
        generator = args[3]
        before = generator.get_state() if generator is not None else None
        recompute = {"lengths": args[6]["lengths"], "recompute": True}
        calls = []

        def run(x_):
            if not calls:
                calls.append(True)
                return self._apply_group(x_, *args)
            now = generator.get_state() if generator is not None else None
            if generator is not None:
                generator.set_state(before)
            try:
                return self._apply_group(x_, *args[:6], dict(recompute))
            finally:
                if generator is not None:
                    generator.set_state(now)

        return checkpoint(run, x, use_reentrant=False)

    def _apply_group(self, x, g_idx, layer, training, generator,
                     residuals_bf16, intermediates, state):
        t = layer.layer_type
        name = self._names[g_idx]
        lengths = state["lengths"]
        if t in ("Linear", "FC", "LIN"):
            for i in range(layer.num_layers):
                x = getattr(self, "{}_{}".format(name, i))(x)
                if layer.nonlin:
                    x = _NONLINS[layer.nonlin](x)
                x = _dropout(x, layer.dropout, training, generator)
            return x
        if t in _RECURRENT:
            return getattr(self, name)(x, lengths, training, generator,
                                       residuals_bf16)
        if t.startswith("Conv1d"):
            # Longest suffix wins ("Conv1dLEAKYRELU" is LeakyReLU, not
            # the shorter "relu" suffix).
            nonlin, best = None, -1
            for key, fn in _NONLINS.items():
                if (t.endswith(key.upper()) or t.endswith(key)) \
                        and len(key) > best:
                    nonlin, best = fn, len(key)
            for i in range(layer.num_layers):
                conv = getattr(self, "{}_{}".format(name, i))
                if state["lengths"] is not None and not state["recompute"]:
                    state["lengths"] = conv.out_lengths(state["lengths"],
                                                        x.shape[1])
                x = conv(x)
                if nonlin is not None:
                    x = nonlin(x)
            return x
        if t == "BatchNorm1d":
            return getattr(self, name)(x, training,
                                       update_stats=not state["recompute"])
        if t == "Embedding":
            return getattr(self, name)(x[..., 0])
        if t == "VanillaVAE":
            record = None if state["recompute"] else intermediates
            return getattr(self, name)(x, training, generator, record,
                                       name + "/")
        if t == "SelectLastPooling":
            if lengths is None:
                return x[:, -1]
            idx = torch.clamp(lengths.to(x.device).long() - 1, min=0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        if t == "MeanPooling":
            if lengths is None:
                return x.mean(dim=1)
            n = torch.clamp(lengths.to(x.device), min=1)[:, None]
            return (x * _time_mask(x, lengths)).sum(dim=1) / n
        if t == "Softmax":      # jax.nn.softmax, rounded as it rounds
            e = torch.exp(x - x.amax(dim=-1, keepdim=True))
            return e / e.sum(dim=-1, keepdim=True)
        if t == "LogSoftmax":   # jax.nn.log_softmax as XLA rounds it
            shifted = x - x.amax(dim=-1, keepdim=True)
            total = torch.exp(shifted.float()).sum(dim=-1, keepdim=True)
            return shifted - torch.log(total.to(x.dtype))
        if t == "Exp":
            return torch.exp(x)
        if t == "Dropout":
            return _dropout(x, layer.dropout, training, generator)
        if t == "Mask":
            return x if lengths is None else x * _time_mask(x, lengths)
        if t == "ApplyFunction":
            fn = layer.extra.get("function")
            if isinstance(fn, str):
                fn = _NONLINS.get(fn, getattr(torch, fn, None))
            return fn(x)
        if t == "AlwaysDropout":
            return _dropout(x, layer.dropout, True, generator)
        if t == "Custom":
            module = getattr(self, name)
            if _takes_lengths(module):
                return module(x, lengths=lengths, training=training)
            return module(x)
        raise NotImplementedError("Unknown layer type " + t)

    class Config(ModelConfig):
        def __init__(self, in_dim=None, layer_configs=None,
                     emb_configs=None, hparams=None, **kwargs):
            super().__init__(**kwargs)
            self.in_dim = in_dim
            self.layer_configs = list(layer_configs or [])
            self.emb_configs = list(emb_configs or [])

        def create_model(self, generator=None):
            """Build the model on the CPU with weights drawn from
            ``generator`` (default: a generator seeded with 0); move it
            with ``.to(device)``."""
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            core = RNNDyn(self)
            core.reset_parameters(generator)
            if self.input_names:
                return NamedForwardWrapper(
                    core, self.input_names,
                    self.output_names or ("pred",),
                    self.input_merge_type,
                    self.teacher_forcing_input_names)
            return core

    LayerConfig = LayerConfig
    EmbeddingConfig = EmbeddingConfig


def _concat_embedding(x, emb):
    """Concatenate an embedding (B, T, E) to x's last axis: frame 0 of
    it after a pooling group, broadcast over time where x has more
    axes; both promoted to their common type, as jnp.concatenate does."""
    if emb.dim() > x.dim():
        # Pooled (utterance-level) activations after a frame-level
        # embedding: the embedding is constant over time.
        emb = emb[:, 0]
    if emb.dim() != x.dim():
        emb = emb[:, None].expand(x.shape[:-1] + emb.shape[-1:])
    dtype = torch.promote_types(x.dtype, emb.dtype)
    return torch.cat([x.to(dtype), emb.to(dtype)], dim=-1)


Config = RNNDyn.Config


def convert_legacy_string(model_string, in_dim, hparams=None,
                          f_get_emb_index=None, dropout=0.0,
                          batch_first=True):
    """Legacy model-string -> :class:`Config`, e.g.
    ``RNNDYN-129x128_EMB_(-1)-2_RELU_1024-3_BiLSTM_512-1_FC_67``
    (``<num_embeddings>x<embedding_dim>_EMB_(<group indices>)``)."""
    if hparams is not None:
        dropout = hparams.get("dropout", dropout)
        f_get_emb_index = hparams.get("f_get_emb_index", f_get_emb_index)
        batch_first = hparams.get("batch_first", True)
    groups = re.split(r"-\s*(?![^()]*\))", model_string)
    if groups and groups[0].upper().startswith(IDENTIFIER):
        groups = groups[1:]
    if not groups:
        raise ValueError("Empty RNNDYN configuration: " + model_string)

    in_dim_total = int(np.prod(in_dim)) if not np.isscalar(in_dim) \
        else int(in_dim)
    in_dim_without_embs = in_dim_total
    emb_configs = []
    layer_configs = []
    embeddings_done = False

    for group in groups:
        attrs = group.split("_")
        layer_type = attrs[1]
        bidirectional = False
        if layer_type.startswith("Bi"):
            bidirectional = True
            layer_type = layer_type[2:]

        if layer_type == "EMB":
            if embeddings_done:
                raise NotImplementedError(
                    "Embedding layers must come first.")
            num_embeddings, embedding_dim = attrs[0].replace(
                "(", "").replace(")", "").split("x")
            affected = parse_int_set(attrs[2])
            if int(num_embeddings) <= 0:
                raise ValueError(
                    "EMB layer needs an explicit positive "
                    "num_embeddings (got {!r}); the reference's -1 "
                    "placeholder is not resolvable here.".format(
                        num_embeddings))
            emb_configs.append(EmbeddingConfig(
                int(embedding_dim), str(len(emb_configs)),
                int(num_embeddings), affected))
            in_dim_without_embs -= 1
            continue
        embeddings_done = True

        n_layers = int(attrs[0])
        out_dim = int(attrs[2])
        norm_type = None
        if layer_type.startswith("BatchNorm1d"):
            norm_type = "BatchNorm1d"
            layer_type = layer_type[len("BatchNorm1d"):]

        nonlin = {"RELU": "ReLU", "TANH": "Tanh",
                  "SIGMOID": "Sigmoid"}.get(layer_type.upper())

        if layer_type in ("LSTM", "GRU", "RNNTANH", "RNNRELU"):
            if layer_type.startswith("RNN"):
                nonlin = {"RNNTANH": "tanh", "RNNRELU": "relu"}[layer_type]
                layer_type = "RNN"
            layer_configs.append(LayerConfig(
                layer_type=layer_type, out_dim=out_dim,
                num_layers=n_layers, nonlin=nonlin,
                dropout=dropout if n_layers > 1 else 0.0,
                bidirectional=bidirectional))
        elif layer_type.startswith("Conv1d"):
            kernel = tuple(map(int, attrs[3].split("x")))
            stride, padding = 1, int((kernel[0] - 1) / 2)
            dilation, conv_groups = 1, 1
            for param in attrs[4:]:
                if param[0] == "s":
                    stride = tuple(map(int, param[1:].split("x")))
                elif param[0] == "p":
                    padding = tuple(map(int, param[1:].split("x")))
                elif param[0] == "d":
                    dilation = tuple(map(int, param[1:].split("x")))
                elif param[0] == "g":
                    conv_groups = int(param[1:])
            layer_configs.append(LayerConfig(
                layer_type=layer_type, out_dim=out_dim,
                num_layers=n_layers, kernel_size=kernel, stride=stride,
                padding=padding, dilation=dilation, groups=conv_groups))
        elif layer_type.startswith("Emb"):
            layer_configs.append(LayerConfig(
                layer_type="Embedding", out_dim=int(attrs[2]),
                num_embeddings=int(attrs[3])))
        elif layer_type.startswith("Pool"):
            if layer_type == "PoolLast":
                layer_configs.append(LayerConfig(
                    layer_type="SelectLastPooling"))
            else:
                raise NotImplementedError(layer_type)
        elif "VAE" in layer_type:
            layer_configs.append(LayerConfig(layer_type="VanillaVAE",
                                             out_dim=out_dim))
        else:
            layer_configs.append(LayerConfig(
                layer_type="Linear", out_dim=out_dim,
                num_layers=n_layers, nonlin=nonlin, dropout=dropout))
        if norm_type is not None:
            layer_configs.append(LayerConfig(layer_type=norm_type,
                                             out_dim=out_dim))
    return Config(in_dim=in_dim_without_embs, batch_first=batch_first,
                  layer_configs=layer_configs, emb_configs=emb_configs)


# -- named presets ---------------------------------------------------------

def merlin_acoustic_config(in_dim, out_dim, hparams=None, dropout=0.05):
    return convert_legacy_string(
        "RNNDYN-6_TANH_1024-1_FC_{}".format(out_dim), in_dim,
        hparams=hparams, dropout=dropout)


def interspeech18_baseline_config(in_dim, out_dim, hparams=None,
                                  dropout=0.0):
    return convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_{}".format(out_dim),
        in_dim, hparams=hparams, dropout=dropout)


def icassp19_baseline_config(in_dim, out_dim, hparams=None, dropout=0.0):
    return convert_legacy_string(
        "RNNDYN-2_RELU_1024-3_BiGRU_427-1_FC_{}".format(out_dim),
        in_dim, hparams=hparams, dropout=dropout)


def baseline_rnn_config(in_dim, out_dim, hparams=None):
    return convert_legacy_string(
        "RNNDYN-1_RELU_32-1_FC_{}".format(out_dim), in_dim,
        hparams=hparams)
