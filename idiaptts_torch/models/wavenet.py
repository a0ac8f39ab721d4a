"""WaveNet vocoder: the port of ``idiaptts_tpu/models/wavenet.py``.

- :class:`WaveNet` and :class:`WaveNetWrapper` are the teacher-forced
  parallel network (dilated causal convolutions, gated residual blocks,
  mu-law categorical output).  Numerics follow the flax modules: the
  ``dilated``, ``cond``, ``skip``, ``res`` and ``post1`` layers take
  bf16 inputs and weights and give bf16 results, their biases added in
  bf16; the activations and the skip sum run in bf16; the residual
  stream ``(x + res) / sqrt(2)`` is float32; ``post2`` is float32.  XLA
  computed this network without a Pallas kernel; it is the oracle of
  the sampler's forced mode.  Two paths, chosen by the device alone:

  - on the CPU, the plain path: each bf16 step emulated as a float32 op
    on bf16-rounded values, rounded to bf16 after (the oracle of the
    card's path);
  - on a CUDA device, the bf16 path: a block is one autograd function
    (:class:`idiaptts_torch.ops.wavenet_block.Block`) of cuBLAS bf16
    products with float32 accumulation, each rounded once to bf16 as the
    plain path rounds it, and hand kernels for the passes between them:
    the taps, the gate (bias adds, tanh, sigmoid, their product), the
    skip and residual update, and their backward.  It saves bf16
    tensors only: the taps, the gate's h and z, about 4.5 KB a sample
    and a block at the r9y9 widths where the plain path saves ~12.

  In training (a CUDA device, grad enabled, the module in training
  mode) the bf16 path's blocks, from the input embedding's lookup to
  the skip sum, run as two CUDA graphs, their forward and their
  backward, captured at a shape's first call and replayed after
  (:mod:`idiaptts_torch.ops.cuda_graph`): the same kernels in the same
  order, one replay where the host launched ~240 kernels a direction.
  :meth:`WaveNet.graph_counts` counts captures, replays and eager calls.

  With tracing on, the blocks are a ``wavenet.stack`` span (its attr
  ``graphed``: whether a graph ran them) and the output layers a
  ``wavenet.head`` span, on the device.
- :func:`generate` and :class:`WaveNetVocoder` are autoregressive
  generation (the reference's ``incremental_forward``) through
  :mod:`idiaptts_torch.ops.cuda_wavenet`: the hand CUDA sampler on the
  card, its plain PyTorch version on the CPU.  The model owns its packed
  sampler weights and repacks them when its parameters change.

Parameter names mirror the flax tree (``wavenet.block_0.dilated.kernel``
(2, R, G), Dense kernels (in, out)), so
:func:`idiaptts_torch.models.convert.flax_to_state_dict` carries a JAX
checkpoint over unchanged.
"""

import glob
import os

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.rnn_dyn import _lecun_normal_
from idiaptts_torch.ops import cuda_graph, cuda_wavenet, wavenet_block
from idiaptts_torch.ops.dispatch import resolve_device
from idiaptts_torch.ops.mulaw import inv_mulaw_quantize
from idiaptts_torch.utils import tracing

INV_SQRT2 = cuda_wavenet.INV_SQRT2


def _bf(x):
    """Round to bf16, keep float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dense_bf16(x, kernel, bias):
    """``flax.linen.Dense(dtype=bfloat16)``: bf16(bf16(x . W) + bf16(b))."""
    return _bf(_bf(_bf(x) @ _bf(kernel)) + _bf(bias))


def _dense(x, kernel, bias):
    """:func:`_dense_bf16` on the path of ``x``: a bf16 product (float32
    accumulation, rounded once) and bias add for a bf16 ``x``, the plain
    path's float32 emulation for a float32 one."""
    if x.dtype == torch.bfloat16:
        return x @ kernel.to(torch.bfloat16) + bias.to(torch.bfloat16)
    return _dense_bf16(x, kernel, bias)


def _bf16_path(x):
    """Whether the network runs its bf16 path on tensors where ``x``
    lies: on a CUDA device alone."""
    return x.device.type == "cuda"


class _Dense(nn.Module):
    """A flax Dense's parameters: ``kernel`` (in, out), ``bias`` (out,)."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()


class _Conv(nn.Module):
    """A flax Conv's parameters: ``kernel`` (k, in, out), ``bias``."""

    def __init__(self, kernel_size, in_dim, out_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator):
        k, in_dim, _ = self.kernel.shape
        _lecun_normal_(self.kernel, k * in_dim, generator)
        with torch.no_grad():
            self.bias.zero_()


class _Embed(nn.Module):
    """A flax Embed's parameter: ``embedding`` (num, features)."""

    def __init__(self, num, features):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.embedding.normal_(0.0, float(1.0 / np.sqrt(
                self.embedding.shape[1])), generator=generator)


class ResidualBlock(nn.Module):
    """Gated residual block with a causal dilated convolution."""

    def __init__(self, residual_channels, gate_channels, skip_channels,
                 kernel_size, dilation, cond_channels):
        super().__init__()
        self.dilation = int(dilation)
        self.dilated = _Conv(kernel_size, residual_channels, gate_channels)
        self.cond = _Dense(cond_channels, gate_channels)
        self.skip = _Dense(gate_channels // 2, skip_channels)
        self.res = _Dense(gate_channels // 2, residual_channels)

    def forward(self, x, cond):
        """x (B, T, R) float32, cond (B, T, C) -> (x', skip bf16)."""
        k, R, G = self.dilated.kernel.shape
        T = x.shape[1]
        # Causal: tap i reads x[t - (k - 1 - i) d]; one product over the
        # concatenated taps rounds once, as the convolution does.
        pad = (k - 1) * self.dilation
        xp = nn.functional.pad(_bf(x), (0, 0, pad, 0))
        taps = torch.cat([xp[:, i * self.dilation:i * self.dilation + T]
                          for i in range(k)], dim=-1)
        h = _dense_bf16(taps, self.dilated.kernel.reshape(k * R, G),
                        self.dilated.bias)
        h = _bf(h + _dense_bf16(cond, self.cond.kernel, self.cond.bias))
        a, b = torch.split(h, G // 2, dim=-1)
        z = _bf(_bf(torch.tanh(a)) * _bf(torch.sigmoid(b)))
        skip = _dense_bf16(z, self.skip.kernel, self.skip.bias)
        res = _dense_bf16(z, self.res.kernel, self.res.bias)
        return (x + res) * INV_SQRT2, skip

    def forward_bf16(self, x, cond, skips):
        """The card's path: x (B, T, R) float32, cond (B, T, Cp) bf16 (its
        columns zero-padded to Cp >= C), skips the bf16 skip sum so far
        (None before the first block) -> (x', skips')."""
        return wavenet_block.Block.apply(
            x, skips, cond, self.dilated.kernel, self.dilated.bias,
            self.cond.kernel, self.cond.bias,
            torch.cat([self.skip.kernel, self.res.kernel], 1),
            torch.cat([self.skip.bias, self.res.bias]), self.dilation)


class WaveNet(nn.Module):
    """Teacher-forced parallel WaveNet."""

    def __init__(self, out_channels=256, residual_channels=64,
                 gate_channels=128, skip_channels=64, num_layers=20,
                 num_stacks=2, kernel_size=2, cond_channels=63):
        super().__init__()
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.num_stacks = num_stacks
        self.input_embed = _Embed(out_channels, residual_channels)
        for i, d in enumerate(self.dilations()):
            self.add_module("block_{}".format(i), ResidualBlock(
                residual_channels, gate_channels, skip_channels,
                kernel_size, d, cond_channels))
        self.post1 = _Dense(skip_channels, skip_channels)
        self.post2 = _Dense(skip_channels, out_channels)
        self._graphs = cuda_graph.GraphCache()
        # (module, name) of each parameter that the block stack reads.
        self._stack_params = [(self.input_embed, "embedding")] + [
            (module, name) for block in self._blocks()
            for module in block.children()
            for name, _ in module.named_parameters(recurse=False)]

    def dilations(self):
        per_stack = self.num_layers // self.num_stacks
        return [2 ** (i % per_stack) for i in range(self.num_layers)]

    def reset_parameters(self, generator):
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, x_quantised, cond):
        """x_quantised (B, T) int mu-law inputs (shifted); cond (B, T, C)
        upsampled conditioning.  Returns (B, T, out) float32 logits: the
        bf16 path on a CUDA device (graphed in training), the plain path
        on the CPU."""
        B, T = x_quantised.shape
        embedding = self.input_embed.embedding
        bf16 = _bf16_path(embedding)
        with tracing.span("wavenet.stack", device=embedding.device,
                          B=int(B), T=int(T), layers=self.num_layers,
                          path="bf16" if bf16 else "plain") as stack:
            if bf16:
                (skips,), graphed = self._graphs(
                    self._stack_bf16, (x_quantised.long(), cond),
                    self._stack_params, self.training)
            else:
                skips, graphed = self._stack_plain(x_quantised, cond), False
                self._graphs.counts["eager"] += 1
            stack.set(graphed=graphed)
        with tracing.span("wavenet.head", device=embedding.device):
            h = torch.relu(_dense(torch.relu(skips), self.post1.kernel,
                                  self.post1.bias))
            return h.to(torch.float32) @ self.post2.kernel + self.post2.bias

    def graph_counts(self):
        """{"captures", "replays", "eager"}: the block stack's calls that
        captured its CUDA graphs, that replayed them, and that ran eager
        (the plain path, evaluation, a shape past the graphs' budget)."""
        return dict(self._graphs.counts)

    def _blocks(self):
        return [getattr(self, "block_{}".format(i))
                for i in range(self.num_layers)]

    def _stack_plain(self, x_quantised, cond):
        x = self.input_embed.embedding[x_quantised.long()]
        cond = cond.to(torch.float32)
        skips = None
        for block in self._blocks():
            x, skip = block(x, cond)
            skips = skip if skips is None else _bf(skips + skip)
        return skips

    def _stack_bf16(self, x_quantised, cond):
        """(skips,): the embedding's lookup and the blocks, the part
        that the graphs capture."""
        x = self.input_embed.embedding[x_quantised]
        # One bf16 copy of the conditioning for every block, its columns
        # zero-padded to a multiple of 8 (16-byte rows for cuBLAS).
        cond = cond.to(torch.bfloat16)
        C = cond.shape[-1]
        cond = nn.functional.pad(cond, (0, -C % 8))
        skips = None
        for block in self._blocks():
            x, skips = block.forward_bf16(x, cond, skips)
        return (skips,)


class WaveNetWrapper(nn.Module):
    """Dict-protocol wrapper: reads the quantised waveform target and the
    conditioning, writes logits (teacher forcing: the inputs are the
    target shifted by one sample, starting at ``out_channels // 2``)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.wavenet = WaveNet(
            out_channels=config.out_channels,
            residual_channels=config.residual_channels,
            gate_channels=config.gate_channels,
            skip_channels=config.skip_channels,
            num_layers=config.num_layers, num_stacks=config.num_stacks,
            kernel_size=config.kernel_size,
            cond_channels=getattr(config, "cond_channels", 63))
        self._sampler = None
        self._sampler_key = None

    def reset_parameters(self, generator):
        self.wavenet.reset_parameters(generator)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        cfg = self.config
        if not cfg.input_names:
            raise ValueError("WaveNetWrapper needs conditioning inputs "
                             "(config.input_names)")
        cond = torch.as_tensor(data_dict[cfg.input_names[0]])
        out = dict(data_dict)
        if cfg.target_name not in data_dict:
            # Inference without a teacher target: generation is
            # autoregressive (generate()); placeholder logits keep the
            # dict protocol.
            out[cfg.output_names[0]] = torch.zeros(
                cond.shape[:2] + (cfg.out_channels,), device=cond.device)
            return out
        target = torch.as_tensor(data_dict[cfg.target_name])
        if target.dim() == 3:
            target = target[..., 0]
        quantised = target.to(torch.long)
        inputs = nn.functional.pad(quantised, (1, 0),
                                   value=cfg.out_channels // 2)[:, :-1]
        out[cfg.output_names[0]] = self.wavenet(inputs, cond)
        return out

    def sampler(self):
        """The packed sampler for the current parameters, made again when
        a parameter changed (in place or by ``load_state_dict``) or moved."""
        key = tuple((p.data_ptr(), p._version, str(p.device))
                    for p in self.parameters())
        if key != self._sampler_key:
            net = self.wavenet
            self._sampler = cuda_wavenet.PackedSampler(
                cuda_wavenet.pack_weights(net.state_dict(), net.dilations(),
                                          self.config.out_channels))
            self._sampler_key = key
        return self._sampler

    class Config(ModelConfig):
        def __init__(self, target_name="target_quantised",
                     out_channels=256, residual_channels=64,
                     gate_channels=128, skip_channels=64, num_layers=20,
                     num_stacks=2, kernel_size=2, cond_channels=63,
                     **kwargs):
            super().__init__(**kwargs)
            self.target_name = target_name
            self.out_channels = out_channels
            self.residual_channels = residual_channels
            self.gate_channels = gate_channels
            self.skip_channels = skip_channels
            self.num_layers = num_layers
            self.num_stacks = num_stacks
            self.kernel_size = kernel_size
            # The JAX package infers the conditioning width from the data;
            # the port needs it to build the model (WaveNetVocoder.load
            # takes it from the checkpoint).
            self.cond_channels = cond_channels

        def create_model(self, generator=None):
            """Build the model on the CPU with weights drawn from
            ``generator`` (default: seeded with 0)."""
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            model = WaveNetWrapper(self)
            model.reset_parameters(generator)
            return model


def generate(model, config, cond, generator=None, temperature=1.0,
             device_output=False):
    """Autoregressive generation on the model's device.

    model: a :class:`WaveNetWrapper`; cond: (T, C) for one utterance or
    (B, T, C) for a batch, at the sample rate.  The uniforms of the draw
    come from ``generator`` (on the model's device; a generator seeded 0
    when None).  Returns the (T,) or (B, T) waveform in [-1, 1], as numpy,
    or as a tensor on the model's device with ``device_output``."""
    sampler = model.sampler()
    cond = torch.as_tensor(cond, dtype=torch.float32).to(
        sampler.weights.device)
    single = cond.dim() == 2
    if single:
        cond = cond[None]
    samples, _ = sampler(cond, generator=generator, temperature=temperature)
    wav = inv_mulaw_quantize(samples, config.out_channels - 1)
    if not device_output:
        wav = wav.cpu().numpy()
    return wav[0] if single else wav


class WaveNetVocoder:
    """A checkpointed WaveNet as a Synthesiser backend, on ``cuda`` unless
    the caller asks for ``device="cpu"``."""

    def __init__(self, config, model, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device).eval()

    @classmethod
    def load(cls, checkpoint_dir, hparams=None, device=None):
        """Read ``config.json`` (the port's or the JAX package's) and the
        newest ``params_*`` in the port's format (``torch.save`` of
        ``{"params": state_dict}``).  The device is ``device``, else
        ``hparams.device``, else ``cuda``."""
        with open(os.path.join(checkpoint_dir, "config.json")) as f:
            config = ModelConfig.from_json(f.read())
        candidates = [p for p in glob.glob(os.path.join(checkpoint_dir,
                                                        "params_*"))
                      if not p.endswith(".tmp")]
        if not candidates:
            raise FileNotFoundError("No params_* in " + checkpoint_dir)
        newest = max(candidates, key=os.path.getctime)
        state = torch.load(newest, map_location="cpu",
                           weights_only=True)["params"]
        config.cond_channels = int(
            state["wavenet.block_0.cond.kernel"].shape[0])
        model = WaveNetWrapper(config)
        model.load_state_dict(state, strict=True)
        if device is None:
            device = (hparams.get("device") if hparams is not None
                      else None) or "cuda"
        return cls(config, model, device)

    def generate(self, cond, seed=0):
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            return generate(self.model, self.config, cond,
                            generator=generator)
