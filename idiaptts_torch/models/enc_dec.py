"""Encoder-decoder models with attention: the port of
``idiaptts_tpu/models/enc_dec.py``.

- :class:`FixedAttention` (context = A @ encoder output, A from the
  durations) and :class:`DotProductAttention` (scaled dot product with
  learned query and key projections, padded keys masked with -1e9).
- :class:`AttentionDecoder`: a dict-protocol decoder with fixed or
  dot-product attention, a prenet, a stack of LSTM cells and named
  projections; :class:`EncDecGraph`: modules in process-group order on
  one data dict.
- :class:`EncDecDyn`: a Dense encoder, fixed attention, an
  autoregressive LSTM decoder over chunks of ``n_frames_per_step``
  frames and an end-of-utterance gate.

The JAX package scans each decoder over the frame chunks (flax
``nn.scan``); the port runs a Python loop over the chunks, one step a
chunk, in plain PyTorch on every device (host-bound on the card: a few
dozen launches a chunk).  Teacher-forced and free-running decoding run
the same step; a per-chunk selector picks the next input.  The EncDecDyn
step keeps the JAX model's input order: the frames fed to chunk i+1 are
the target chunk i-1 under teacher forcing (its shifted targets pass
through the carry once more), the chunk's own prediction when free
running.

:class:`OptimizedLSTMCell` is ``flax.linen.OptimizedLSTMCell`` written
out as matmuls in its parameter layout: input kernels ``ii``, ``if``,
``ig``, ``io`` (no bias), recurrent kernels ``hi``, ``hf``, ``hg``,
``ho`` with biases; gates = (h·[Whi|Whf|Whg|Who] + b) + x·[Wii|...],
i, f, o sigmoid and g tanh, c' = f·c + i·g, h' = o·tanh(c'), no
forget-gate offset.  Everything is float32 (flax's default Dense);
keep TF32 off on the card.  Parameter names follow the flax tree
(``encoder_0.kernel``, ``decoder.cell.ii.kernel``, ``step.lstm_0.hf.bias``,
``step.proj_<name>_<j>``), so ``models/convert.py`` maps a JAX
checkpoint by name.
"""

import copy

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import (Sequential, default_generator,
                                         merge_inputs, select_lengths)
from idiaptts_torch.models.rnn_dyn import _Dense

_GATES = ("i", "f", "g", "o")


def _dense(in_dim, out_dim, bias=True, orthogonal=False):
    return _Dense(in_dim, out_dim, bias=bias, dtype=None,
                  orthogonal=orthogonal)


def _reset(module, generator):
    """Draw every Dense in ``module`` from ``generator``, in module
    order."""
    for child in module.modules():
        if isinstance(child, _Dense):
            child.reset_parameters(generator)


def _softmax(x):
    """``jax.nn.softmax`` over the last axis."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class OptimizedLSTMCell(nn.Module):
    """``flax.linen.OptimizedLSTMCell(features)`` in float32; the carry
    is (c, h)."""

    def __init__(self, in_dim, features):
        super().__init__()
        self.features = int(features)
        for g in _GATES:
            self.add_module("i" + g, _dense(in_dim, features, bias=False))
        for g in _GATES:
            self.add_module("h" + g, _dense(features, features,
                                            orthogonal=True))

    def forward(self, carry, x):
        c, h = carry
        wh = torch.cat([getattr(self, "h" + g).kernel for g in _GATES], 1)
        bh = torch.cat([getattr(self, "h" + g).bias for g in _GATES])
        wi = torch.cat([getattr(self, "i" + g).kernel for g in _GATES], 1)
        gates = (h @ wh + bh) + x @ wi
        i, f, g, o = gates.split(self.features, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class FixedAttention(nn.Module):
    """Duration-derived hard attention: context = A @ encoder_out."""

    def forward(self, attention_matrix, encoder_out):
        return torch.einsum("btp,bpe->bte", attention_matrix, encoder_out)


class DotProductAttention(nn.Module):
    """Scaled dot-product attention with learned projections."""

    def __init__(self, query_dim, key_dim, attention_dim=128):
        super().__init__()
        self.attention_dim = attention_dim
        self.query = _dense(query_dim, attention_dim)
        self.key = _dense(key_dim, attention_dim)

    def forward(self, queries, keys, values, key_lengths=None):
        q = self.query(queries)
        k = self.key(keys)
        scores = torch.einsum("btd,bpd->btp", q, k) \
            / np.sqrt(self.attention_dim)
        if key_lengths is not None:
            mask = (torch.arange(keys.shape[1], device=keys.device)
                    [None, None, :] < key_lengths[:, None, None])
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, -1e9))
        weights = _softmax(scores)
        return torch.einsum("btp,bpe->bte", weights, values), weights


def _fit_phone_axis(attn, P):
    """Zero-pad or cut the attention matrix's phone axis to P."""
    if attn.shape[-1] < P:
        return nn.functional.pad(attn, (0, P - attn.shape[-1]))
    return attn[..., :P]


class _AttentionDecoderStep(nn.Module):
    """One chunk of :class:`AttentionDecoder`: prenet(previous input) +
    context (a fixed slice, or dot-product over the memory) -> LSTM
    stack -> decoder output and projections."""

    def __init__(self, cfg, memory_dim, ar_dim):
        super().__init__()
        self.cfg = cfg
        self.n_step = cfg.n_frames_per_step
        self.use_dot = cfg.attention_type != "fixed"
        dim = ar_dim
        for i, d in enumerate(cfg.prenet_dims):
            self.add_module("prenet_{}".format(i), _dense(dim, d))
            dim = d
        pre_dim = dim
        if self.use_dot:
            self.query = _dense(pre_dim, cfg.attention_dim)
        ctx_dim = memory_dim if self.use_dot else self.n_step * memory_dim
        dim = ctx_dim + pre_dim
        for i, d in enumerate(cfg.lstm_dims):
            self.add_module("lstm_{}".format(i), OptimizedLSTMCell(dim, d))
            dim = d
        for name, out_dim, hidden_dims, _ in cfg.projections:
            y_dim = dim
            for j, hd in enumerate(hidden_dims):
                self.add_module("proj_{}_{}".format(name, j),
                                _dense(y_dim, hd))
                y_dim = hd
            self.add_module("proj_{}".format(name),
                            _dense(y_dim, out_dim * self.n_step))

    def forward(self, carries, prev_ar, ctx_flat, tgt_flat, use_tf, keys,
                values, mem_mask):
        cfg = self.cfg
        prev = torch.where(use_tf > 0.5, tgt_flat, prev_ar)
        pre = prev
        for i in range(len(cfg.prenet_dims)):
            pre = torch.relu(getattr(self, "prenet_{}".format(i))(pre))
        if self.use_dot:
            q = self.query(pre)
            scores = torch.einsum("bd,bpd->bp", q, keys) \
                / np.sqrt(cfg.attention_dim)
            scores = torch.where(mem_mask, scores,
                                 torch.full_like(scores, -1e9))
            attn_w = _softmax(scores)
            context = torch.einsum("bp,bpe->be", attn_w, values)
        else:
            context = ctx_flat
            attn_w = prev.new_zeros(prev.shape[0], keys.shape[1])
        h = torch.cat([context, pre], dim=-1)
        new_carries = []
        for i in range(len(cfg.lstm_dims)):
            c, h = getattr(self, "lstm_{}".format(i))(carries[i], h)
            new_carries.append(c)
        proj_outs, ar_parts = [], []
        for name, out_dim, hidden_dims, is_ar in cfg.projections:
            y = h
            for j in range(len(hidden_dims)):
                y = torch.relu(getattr(self, "proj_{}_{}".format(name, j))(y))
            y = getattr(self, "proj_{}".format(name))(y)
            proj_outs.append(y)
            if is_ar:
                # The AR input is the chunk's last frame.
                ar_parts.append(y[..., (self.n_step - 1) * out_dim:])
        next_ar = torch.cat(ar_parts, dim=-1) if ar_parts else prev_ar
        return new_carries, next_ar, h, proj_outs, attn_w


class AttentionDecoder(nn.Module):
    """Dict-protocol decoder with fixed or dot-product attention, prenet,
    LSTM core and named projections ``(output_name, out_dim,
    hidden_dims, is_autoregressive_input)``."""

    def __init__(self, config, memory_dim):
        super().__init__()
        self.config = config
        ar_dim = sum(p[1] for p in config.projections if p[3])
        self.ar_dim = ar_dim
        if config.attention_type != "fixed":
            self.key = _dense(memory_dim, config.attention_dim)
        self.step = _AttentionDecoderStep(config, memory_dim, ar_dim)

    def forward(self, data_dict, lengths=None, training=False,
                generator=None, **kwargs):
        cfg = self.config
        memory = merge_inputs(data_dict, cfg.input_names,
                              cfg.input_merge_type)
        B, P, E = memory.shape
        n_step = cfg.n_frames_per_step
        tf_names = tuple(cfg.teacher_forcing_input_names or ())
        if cfg.attention_type == "fixed":
            attn = _fit_phone_axis(torch.as_tensor(
                data_dict[cfg.attention_name]), P)
            context = FixedAttention()(attn, memory)
            T = context.shape[1]
        elif tf_names and tf_names[0] in data_dict:
            T = torch.as_tensor(data_dict[tf_names[0]]).shape[1]
        else:
            T = cfg.max_decoder_steps
        num_chunks = max(1, T // n_step)
        T_used = num_chunks * n_step
        ar_dim = self.ar_dim
        have_target = bool(tf_names) and all(n in data_dict
                                             for n in tf_names)
        if have_target:
            tgt = merge_inputs(data_dict, tf_names)[:, :T_used, :ar_dim]
            last = tgt[:, n_step - 1::n_step]
            shifted = torch.cat([last.new_zeros(B, 1, ar_dim),
                                 last[:, :-1]], dim=1)
        else:
            shifted = memory.new_zeros(B, num_chunks, ar_dim)

        p_tf = cfg.p_teacher_forcing if (training and have_target) else 0.0
        if p_tf >= 1.0:
            use_tf = memory.new_ones(num_chunks)
        elif p_tf <= 0.0:
            use_tf = memory.new_zeros(num_chunks)
        else:
            # One draw a chunk, shared by the batch, from the model's
            # generator (the JAX package draws from its "teacher" key).
            draw = torch.rand(num_chunks, generator=default_generator(
                generator), device=memory.device)
            use_tf = (draw <= p_tf).to(memory.dtype)

        if cfg.attention_type == "fixed":
            ctx_c = context[:, :T_used].reshape(B, num_chunks, n_step * E)
            keys = memory.new_zeros(B, P, 1)
            mem_mask = torch.ones(B, P, dtype=torch.bool,
                                  device=memory.device)
        else:
            ctx_c = memory.new_zeros(B, num_chunks, 0)
            keys = self.key(memory)
            mem_len = select_lengths(lengths, *cfg.input_names)
            if mem_len is not None:
                mem_mask = (torch.arange(P, device=memory.device)[None, :]
                            < torch.as_tensor(mem_len,
                                              device=memory.device)[:, None])
            else:
                mem_mask = torch.ones(B, P, dtype=torch.bool,
                                      device=memory.device)

        carries = [(memory.new_zeros(B, d), memory.new_zeros(B, d))
                   for d in cfg.lstm_dims]
        prev_ar = memory.new_zeros(B, ar_dim)
        dec_outs, proj_outs, attn_ws = [], [], []
        for i in range(num_chunks):
            carries, prev_ar, dec, projs, attn_w = self.step(
                carries, prev_ar, ctx_c[:, i], shifted[:, i], use_tf[i],
                keys, memory, mem_mask)
            dec_outs.append(dec)
            proj_outs.append(projs)
            attn_ws.append(attn_w)

        out = dict(data_dict)
        if cfg.decoder_output_name:
            out[cfg.decoder_output_name] = torch.stack(dec_outs, dim=1)
        for k, (name, out_dim, _, _) in enumerate(cfg.projections):
            y = torch.stack([p[k] for p in proj_outs], dim=1)
            out[name] = y.reshape(B, num_chunks * n_step, out_dim)
        if cfg.attention_type != "fixed":
            out[cfg.attention_output_name] = torch.stack(attn_ws, dim=1)
        return out

    class Config(ModelConfig):
        """``projections``: ``(output_name, out_dim, hidden_dims,
        is_autoregressive_input)`` tuples.  The memory width
        (``memory_dim``) is the port's: the JAX package infers it from
        the data."""

        def __init__(self, attention_type="fixed",
                     attention_name="attention_matrix", attention_dim=128,
                     attention_output_name="attention",
                     teacher_forcing_input_names=(), prenet_dims=(64,),
                     lstm_dims=(128,), projections=(),
                     decoder_output_name=None, n_frames_per_step=1,
                     p_teacher_forcing=1.0, max_decoder_steps=1000,
                     process_group=0, memory_dim=None, **kwargs):
            super().__init__(**kwargs)
            self.attention_type = attention_type
            self.attention_name = attention_name
            self.attention_dim = attention_dim
            self.attention_output_name = attention_output_name
            self.teacher_forcing_input_names = tuple(
                teacher_forcing_input_names or ())
            self.prenet_dims = tuple(prenet_dims)
            self.lstm_dims = tuple(lstm_dims)
            self.projections = tuple(tuple(p) for p in projections)
            self.decoder_output_name = decoder_output_name
            self.n_frames_per_step = n_frames_per_step
            self.p_teacher_forcing = p_teacher_forcing
            self.max_decoder_steps = max_decoder_steps
            self.process_group = process_group
            self.memory_dim = memory_dim

        def create_model(self, generator=None):
            memory_dim = getattr(self, "memory_dim", None)
            if memory_dim is None:
                raise ValueError("AttentionDecoder.Config needs memory_dim "
                                 "(the width of its merged inputs)")
            model = AttentionDecoder(self, int(memory_dim))
            _reset(model, default_generator(generator))
            return model


class EncDecGraph(Sequential):
    """Modules in process-group order on one data dict (a
    :class:`~idiaptts_torch.models.named.Sequential` built from process
    groups)."""

    class ModuleConfig(ModelConfig):
        """A named submodule: any inner config lifted into the graph at
        a process group."""

        def __init__(self, config=None, process_group=0, **kwargs):
            super().__init__(**kwargs)
            self.config = config
            self.process_group = process_group

        def create_model(self, generator=None):
            # A copy: the inner config may be shared; its own merge type
            # wins when it set one.
            inner = copy.copy(self.config)
            if inner.input_names is None:
                inner.input_names = self.input_names
            if inner.output_names is None:
                inner.output_names = self.output_names
            if getattr(inner, "input_merge_type", None) in (
                    None, ModelConfig.MERGE_CAT) \
                    and self.input_merge_type != ModelConfig.MERGE_CAT:
                inner.input_merge_type = self.input_merge_type
            return inner.create_model(generator)

    class Config(ModelConfig):
        def __init__(self, modules=None, **kwargs):
            super().__init__(**kwargs)
            modules = list(modules or [])
            max_group = max((getattr(m, "process_group", 0)
                             for m in modules), default=0)
            self.process_groups = [[] for _ in range(max_group + 1)]
            for m in modules:
                self.process_groups[getattr(m, "process_group", 0)] \
                    .append(m)

        def module_config(self, name):
            """The module config called ``name``."""
            for group in self.process_groups:
                for module in group:
                    if getattr(module, "name", None) == name:
                        return module
            raise AttributeError("No module named {!r}".format(name))

        def create_model(self, generator=None):
            generator = default_generator(generator)
            return EncDecGraph([m.create_model(generator)
                                for group in self.process_groups
                                for m in group])


class _DecoderStep(nn.Module):
    """One autoregressive EncDecDyn step: prenet(prev) + context ->
    LSTM -> frames + gate."""

    def __init__(self, prenet_in, prenet_dim, ctx_dim, decoder_dim,
                 frame_out):
        super().__init__()
        self.prenet = _dense(prenet_in, prenet_dim)
        self.cell = OptimizedLSTMCell(prenet_dim + ctx_dim, decoder_dim)
        self.proj = _dense(decoder_dim, frame_out)
        self.gate = _dense(decoder_dim, 1)

    def forward(self, carry, prev_frames, ctx_flat, tgt_flat, use_tf):
        pre = torch.relu(self.prenet(prev_frames))
        carry, h = self.cell(carry, torch.cat([pre, ctx_flat], dim=-1))
        frames = self.proj(h)
        gate = self.gate(h)
        next_prev = tgt_flat if use_tf else frames
        return carry, next_prev, frames, gate


class EncDecDyn(nn.Module):
    """Dense encoder + fixed attention + autoregressive decoder + gate."""

    def __init__(self, config, in_dim):
        super().__init__()
        self.config = config
        dim = in_dim
        for i, units in enumerate(config.encoder_units):
            self.add_module("encoder_{}".format(i), _dense(dim, units))
            dim = units
        n_step = config.n_frames_per_step
        self.decoder = _DecoderStep(n_step * config.out_dim,
                                    config.prenet_dim, n_step * dim,
                                    config.decoder_dim,
                                    n_step * config.out_dim)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        cfg = self.config
        x = torch.as_tensor(data_dict[cfg.input_names[0]])
        for i in range(len(cfg.encoder_units)):
            x = torch.relu(getattr(self, "encoder_{}".format(i))(x))
        if cfg.attention_type != "fixed":
            raise NotImplementedError(cfg.attention_type)
        attn = _fit_phone_axis(torch.as_tensor(
            data_dict[cfg.attention_name]).to(x.dtype), x.shape[1])
        context = FixedAttention()(attn, x)

        B, T, E = context.shape
        out_dim = cfg.out_dim
        n_step = cfg.n_frames_per_step
        num_chunks = max(1, T // n_step)
        context_c = context[:, :num_chunks * n_step].reshape(
            B, num_chunks, n_step * E)
        teacher = training and cfg.target_name in data_dict
        if cfg.target_name in data_dict:
            tgt = torch.as_tensor(data_dict[cfg.target_name])
            tgt_c = tgt[:, :num_chunks * n_step, :out_dim].reshape(
                B, num_chunks, n_step * out_dim)
            shifted = torch.cat([tgt_c.new_zeros(B, 1, n_step * out_dim),
                                 tgt_c[:, :-1]], dim=1)
        else:
            shifted = context.new_zeros(B, num_chunks, n_step * out_dim)

        zeros = context.new_zeros(B, cfg.decoder_dim)
        carry = (zeros, zeros)
        prev = context.new_zeros(B, n_step * out_dim)
        frames, gates = [], []
        for i in range(num_chunks):
            carry, prev, f, g = self.decoder(carry, prev, context_c[:, i],
                                             shifted[:, i], teacher)
            frames.append(f)
            gates.append(g)
        frames = torch.stack(frames, dim=1).reshape(
            B, num_chunks * n_step, out_dim)
        gates = torch.stack(gates, dim=1).repeat_interleave(n_step, dim=1)
        out = dict(data_dict)
        out[cfg.output_names[0]] = frames
        gate_name = cfg.output_names[1] if len(cfg.output_names) > 1 \
            else "pred_gate"
        out[gate_name] = torch.sigmoid(gates)
        return out

    class Config(ModelConfig):
        """The input width (``in_dim``) is the port's: the JAX package
        infers it from the data."""

        def __init__(self, encoder_units=(256,), out_dim=None,
                     prenet_dim=128, decoder_dim=512, n_frames_per_step=2,
                     attention_type="fixed",
                     attention_name="attention_matrix",
                     target_name="acoustic_features", in_dim=None,
                     **kwargs):
            super().__init__(**kwargs)
            self.encoder_units = tuple(encoder_units)
            self.out_dim = out_dim
            self.prenet_dim = prenet_dim
            self.decoder_dim = decoder_dim
            self.n_frames_per_step = n_frames_per_step
            self.attention_type = attention_type
            self.attention_name = attention_name
            self.target_name = target_name
            self.in_dim = in_dim

        def create_model(self, generator=None):
            in_dim = getattr(self, "in_dim", None)
            if in_dim is None or self.out_dim is None:
                raise ValueError("EncDecDyn.Config needs in_dim and out_dim")
            model = EncDecDyn(self, int(in_dim))
            _reset(model, default_generator(generator))
            return model
