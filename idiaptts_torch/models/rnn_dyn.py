"""Config-built acoustic model stacks: the port of
``idiaptts_tpu/models/rnn_dyn.py`` for serving and training.

The whole legacy model-string grammar is ported (:func:`convert_legacy_string`,
``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67``), but only ``Linear``/``FC``
groups and bidirectional ``LSTM`` groups build; every other layer type
raises ``NotImplementedError``.

Numerics follow the JAX model:

- Dense layers take bf16 inputs and weights and give a bf16 result
  (``flax.linen.Dense(dtype=bfloat16)``); the bias is added in bf16 and
  ReLU runs in bf16.  These are plain ``torch.matmul`` calls on bf16
  tensors: the JAX package computes them outside any Pallas kernel.
- Each BiLSTM layer runs through
  :func:`idiaptts_torch.ops.cuda_lstm.bilstm_layer_tmajor` (the
  projection and recurrence kernels on CUDA) for inference, and through
  :class:`idiaptts_torch.ops.cuda_lstm.BiLSTMLayerFn` (projection,
  training-mode recurrence, reverse-time backward kernel) when
  ``forward(..., training=True)`` under autograd.
- Dropout, where the config sets it (the Interspeech'18 default is 0.0),
  draws its masks from the ``generator`` passed to ``forward``.
- The model output is float32.

Parameter names mirror the flax tree (``g0_Linear_0.kernel``,
``g2_LSTM.bi0.Wx``), so :mod:`idiaptts_torch.models.convert` maps a JAX
checkpoint onto this module by name.
"""

import re

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import NamedForwardWrapper
from idiaptts_torch.ops.cuda_lstm import BiLSTMLayerFn, bilstm_layer_tmajor

IDENTIFIER = "RNNDYN"

_LATER = ("is not ported yet; ROADMAP.md queue 1 item 4 (the rest of the "
          "serving surface) ports it")

_NONLINS = {
    "ReLU": torch.relu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


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


def masked_flip(x, lengths):
    """Reverse each sequence of (B, T, ...) within its valid length;
    padding stays at the tail (packed-sequence reverse semantics)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    lengths = lengths.to(x.device)[:, None]
    idx = torch.where(t < lengths, lengths - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def _dropout(x, p, training, generator):
    """Inverted dropout (``flax.linen.Dropout``) with masks drawn from
    ``generator``; the identity outside training or at ``p == 0``."""
    if not training or not p:
        return x
    if generator is None:
        raise ValueError("dropout {} in training needs a torch.Generator "
                         "(forward(..., generator=...))".format(p))
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _lecun_normal_(tensor, fan_in, generator):
    """flax's lecun_normal: truncated normal, variance 1/fan_in."""
    std = float(np.sqrt(1.0 / fan_in)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class _Dense(nn.Module):
    """``flax.linen.Dense(dtype=bfloat16)``: (in, out) kernel."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        y = torch.matmul(x.to(torch.bfloat16),
                         self.kernel.to(torch.bfloat16))
        return y + self.bias.to(torch.bfloat16)


class _BiFastLSTM(nn.Module):
    """Both directions of one BiLSTM layer: per-direction ``Wx (2, D,
    4F)``, ``Wh (2, F, 4F)`` and ``b (2, 4F)``; forget-gate bias +1 and
    gate order [i, f, g, o] are in the kernel."""

    def __init__(self, in_dim, features):
        super().__init__()
        F = int(features)
        self.features = F
        self.Wx = nn.Parameter(torch.empty(2, in_dim, 4 * F))
        self.Wh = nn.Parameter(torch.empty(2, F, 4 * F))
        self.b = nn.Parameter(torch.zeros(2, 4 * F))

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
        F = self.features
        xin_t = torch.stack([x, x_rev]).to(torch.bfloat16)   # (2, B, T, D)
        xin_t = xin_t.permute(2, 0, 1, 3).reshape(T, 2 * B, D).contiguous()
        wh_cat = torch.cat([self.Wh[0], self.Wh[1]], dim=0)
        if training and torch.is_grad_enabled():
            hs = BiLSTMLayerFn.apply(xin_t, self.Wx, wh_cat, self.b,
                                     residuals_bf16)
        else:
            hs = bilstm_layer_tmajor(xin_t, self.Wx, wh_cat, self.b)
        hs = hs.reshape(T, 2, B, F)
        return hs[:, 0].transpose(0, 1), hs[:, 1].transpose(0, 1)


class _MaskedFlipRNN(nn.Module):
    """Bidirectional LSTM stack with length-aware reverse (the
    bidirectional-LSTM branch of the JAX ``_MaskedFlipRNN``)."""

    def __init__(self, cell_type, in_dim, out_dim, num_layers,
                 bidirectional, dropout=0.0):
        super().__init__()
        if cell_type != "LSTM" or not bidirectional:
            raise NotImplementedError(
                "{}{} layers {}".format("Bi" if bidirectional else "",
                                        cell_type, _LATER))
        self.num_layers = int(num_layers)
        self.dropout = float(dropout or 0.0)
        for layer in range(self.num_layers):
            self.add_module("bi{}".format(layer),
                            _BiFastLSTM(in_dim, out_dim))
            in_dim = 2 * out_dim

    def forward(self, x, lengths=None, training=False, generator=None,
                residuals_bf16=False):
        for layer in range(self.num_layers):
            bi = getattr(self, "bi{}".format(layer))
            x_rev = masked_flip(x, lengths) if lengths is not None \
                else x.flip(1)
            out_f, out_b_rev = bi(x, x_rev, training, residuals_bf16)
            out_b = masked_flip(out_b_rev, lengths) \
                if lengths is not None else out_b_rev.flip(1)
            x = torch.cat([out_f, out_b], dim=-1)
            if layer < self.num_layers - 1:
                x = _dropout(x, self.dropout, training, generator)
        return x


class RNNDyn(nn.Module):
    """Sequential layer-group stack built from a :class:`Config`."""

    def __init__(self, config):
        super().__init__()
        if config.emb_configs:
            raise NotImplementedError("Embedding inputs " + _LATER)
        if config.in_dim is None:
            raise ValueError("RNNDyn needs config.in_dim")
        self._plan = []
        dim = int(np.prod(config.in_dim))
        for g_idx, layer in enumerate(config.layer_configs):
            t = layer.layer_type
            name = "g{}_{}".format(g_idx, t)
            if t in ("Linear", "FC", "LIN"):
                names = []
                for i in range(layer.num_layers):
                    sub = "{}_{}".format(name, i)
                    self.add_module(sub, _Dense(dim, layer.out_dim))
                    names.append(sub)
                    dim = layer.out_dim
                self._plan.append(("dense", names,
                                   (layer.nonlin, layer.dropout)))
            elif t == "LSTM":
                self.add_module(name, _MaskedFlipRNN(
                    t, dim, layer.out_dim, layer.num_layers,
                    layer.bidirectional, layer.dropout))
                self._plan.append(("rnn", name, None))
                dim = 2 * layer.out_dim
            else:
                raise NotImplementedError(
                    "Layer type {} {}".format(t, _LATER))
        self.out_dim = dim

    def reset_parameters(self, generator):
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, inputs, lengths=None, training=False, generator=None,
                residuals_bf16=False):
        """inputs (B, T, D) -> (B, T, out_dim) float32.  ``training``
        turns on dropout (masks from ``generator``) and, under autograd,
        the BiLSTM layers' training kernels with float32 residuals, or
        bf16 ones with ``residuals_bf16``."""
        x = inputs
        for kind, names, extra in self._plan:
            if kind == "dense":
                nonlin, p = extra
                for sub in names:
                    x = getattr(self, sub)(x)
                    if nonlin:
                        x = _NONLINS[nonlin](x)
                    x = _dropout(x, p, training, generator)
            else:
                x = getattr(self, names)(x, lengths, training, generator,
                                         residuals_bf16)
        return x.to(torch.float32)

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
