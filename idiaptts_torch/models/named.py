"""Named-tensor-dict protocol: gather named inputs, merge them, run the
wrapped module, write named outputs.

Port of ``idiaptts_tpu/models/named.py`` (``select_lengths``,
``merge_inputs``, ``write_outputs``, ``NamedForwardWrapper``,
``NamedForwardSplitter``, ``NamedForwardCombiner`` and ``Sequential``,
with their configs) for batch-first (B, T, D) tensors with a (B,)
``lengths`` vector.

A composite config's ``create_model(generator)`` draws its modules'
weights from the one generator in module order.  ``Sequential`` names
its modules ``modules_list_<i>``, as flax names the members of a tuple
attribute, so a JAX checkpoint's parameter paths carry over.
"""

import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig


def select_lengths(lengths, *names):
    """``lengths`` is one (B,) vector, or a dict ``{feature_name: (B,)}``
    for multi-rate batches; the vector of the first matching name wins."""
    if isinstance(lengths, dict):
        for name in names:
            if name is not None and name in lengths:
                return lengths[name]
        return next(iter(lengths.values())) if lengths else None
    return lengths


def broadcast_time(value, max_time):
    """(B, D) -> (B, 1, D) -> expanded (B, T, D); (B, T, D) passes."""
    if value.dim() == 2:
        value = value[:, None, :]
    if value.shape[1] == 1 and max_time > 1:
        value = value.expand(value.shape[0], max_time, *value.shape[2:])
    return value


def merge_inputs(data_dict, input_names, merge_type=ModelConfig.MERGE_CAT,
                 training=True, teacher_forcing_names=()):
    """Gather named inputs from the dict and merge them."""
    names = [n for n in input_names
             if training or n not in teacher_forcing_names]
    values = [torch.as_tensor(data_dict[name]) for name in names]
    max_time = max((v.shape[1] if v.dim() > 2 else 1) for v in values)
    values = [broadcast_time(v, max_time) for v in values]
    if merge_type == ModelConfig.MERGE_LIST:
        return values
    if merge_type == ModelConfig.MERGE_CAT:
        return torch.cat(values, dim=-1)
    stacked = values[0]
    for v in values[1:]:
        if merge_type in (ModelConfig.MERGE_ADD, ModelConfig.MERGE_MEAN):
            stacked = stacked + v
        elif merge_type in (ModelConfig.MERGE_MUL,
                            ModelConfig.MERGE_ATTENTION):
            stacked = stacked * v
        else:
            raise NotImplementedError(merge_type)
    if merge_type == ModelConfig.MERGE_MEAN:
        stacked = stacked / len(values)
    elif merge_type == ModelConfig.MERGE_ATTENTION:
        stacked = torch.sum(stacked, dim=1, keepdim=True)
    return stacked


def write_outputs(data_dict, output_names, output):
    """Write module output(s) back into a copy of the dict."""
    updated = dict(data_dict)
    if len(output_names) == 1:
        updated[output_names[0]] = output
    else:
        if not isinstance(output, (tuple, list)):
            raise ValueError("Multiple output names need multiple outputs")
        for name, value in zip(output_names, output):
            updated[name] = value
    return updated


class NamedForwardWrapper(nn.Module):
    """Wraps an inner module into the dict protocol.  The inner module
    is called as ``wrapped(inputs, lengths=..., training=..., **kwargs)``
    (``kwargs``: the model's own options, such as rnn_dyn's dropout
    ``generator`` and ``residuals_bf16``)."""

    def __init__(self, wrapped, input_names, output_names,
                 input_merge_type=ModelConfig.MERGE_CAT,
                 teacher_forcing_input_names=()):
        super().__init__()
        self.wrapped = wrapped
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)
        self.input_merge_type = input_merge_type
        self.teacher_forcing_input_names = tuple(
            teacher_forcing_input_names or ())

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        inputs = merge_inputs(data_dict, self.input_names,
                              self.input_merge_type, training,
                              self.teacher_forcing_input_names)
        lengths = select_lengths(lengths, *self.input_names)
        output = self.wrapped(inputs, lengths=lengths, training=training,
                              **kwargs)
        return write_outputs(data_dict, self.output_names, output)

    class Config(ModelConfig):
        def __init__(self, wrapped_model_config=None, **kwargs):
            super().__init__(**kwargs)
            self.wrapped_model_config = wrapped_model_config

        def create_model(self, generator=None):
            return NamedForwardWrapper(
                self.wrapped_model_config.create_model(generator),
                self.input_names, self.output_names, self.input_merge_type,
                self.teacher_forcing_input_names)


def default_generator(generator):
    """The weight generator of a new model: ``generator``, or one seeded
    with 0 (the port's default draw)."""
    return torch.Generator().manual_seed(0) if generator is None \
        else generator


class NamedForwardSplitter(nn.Module):
    """Splits one named tensor into several named parts along the
    feature axis."""

    def __init__(self, input_names, output_names, split_sizes):
        super().__init__()
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)
        self.split_sizes = tuple(split_sizes)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        value = merge_inputs(data_dict, self.input_names)
        updated = dict(data_dict)
        start = 0
        for name, size in zip(self.output_names, self.split_sizes):
            updated[name] = value[..., start:start + size]
            start += size
        return updated

    class Config(ModelConfig):
        def __init__(self, split_sizes=None, **kwargs):
            super().__init__(**kwargs)
            self.split_sizes = tuple(split_sizes)

        def create_model(self, generator=None):
            return NamedForwardSplitter(self.input_names, self.output_names,
                                        self.split_sizes)


class NamedForwardCombiner(nn.Module):
    """Concatenates named tensors into one named output."""

    def __init__(self, input_names, output_names):
        super().__init__()
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        merged = merge_inputs(data_dict, self.input_names)
        return write_outputs(data_dict, self.output_names, merged)

    class Config(ModelConfig):
        def create_model(self, generator=None):
            return NamedForwardCombiner(self.input_names, self.output_names)


class Sequential(nn.Module):
    """Runs dict-protocol modules in order; each gets the model options
    (``generator``, ``residuals_bf16``, ...) the caller passes."""

    def __init__(self, modules_list):
        super().__init__()
        self.num_modules = len(modules_list)
        for i, module in enumerate(modules_list):
            self.add_module("modules_list_{}".format(i), module)

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        for i in range(self.num_modules):
            data_dict = getattr(self, "modules_list_{}".format(i))(
                data_dict, lengths=lengths, training=training, **kwargs)
        return data_dict

    class Config(ModelConfig):
        def __init__(self, module_configs=None, **kwargs):
            super().__init__(**kwargs)
            self.module_configs = list(module_configs or [])

        def create_model(self, generator=None):
            generator = default_generator(generator)
            return Sequential([c.create_model(generator)
                               for c in self.module_configs])
