"""Model wrappers for long sequences: the port of
``idiaptts_tpu/models/wrappers.py``.

:class:`WindowingWrapper` runs the wrapped dict-protocol module on
overlapping windows of a long sequence and merges the outputs:

- ``"window"`` (default): triangular cross-fade overlap-add back to the
  original length (per-frame outputs);
- ``"cat"``: the chunk outputs concatenated along time;
- ``"add"`` / ``"mean"`` / ``"mul"``: a reduce over each sample's valid
  chunks to one window-length output, invalid chunks masked with the
  merge's identity element.

A sequence no longer than the window runs unwindowed.  A 2-D (static)
input is broadcast over time before it is windowed.  The outputs are
renamed positionally to the wrapper's ``output_names``; extra outputs
keep their inner names.  The wrapped module's parameters sit under
``wrapped``, as in the flax tree.
"""

import numpy as np
import torch
from torch import nn

from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models.named import broadcast_time, select_lengths


class WindowingWrapper(nn.Module):

    def __init__(self, wrapped, input_names, output_names, window_size,
                 window_step, output_merge_type="window"):
        super().__init__()
        self.wrapped = wrapped
        self.input_names = tuple(input_names)
        self.output_names = tuple(output_names or ())
        self.window_size = int(window_size)
        self.window_step = int(window_step)
        self.output_merge_type = output_merge_type

    def forward(self, data_dict, lengths=None, training=False, **kwargs):
        lengths = select_lengths(lengths, *self.input_names)
        values = {n: torch.as_tensor(data_dict[n]) for n in self.input_names}
        B = values[self.input_names[0]].shape[0]
        T = max([v.shape[1] for v in values.values() if v.dim() > 2] or [1])
        W, S = self.window_size, self.window_step

        if T <= W:
            out = self.wrapped(values, lengths=lengths, training=training,
                               **kwargs)
            return self._write_back(data_dict, out, set(self.input_names))

        num_windows = int(np.ceil(max(T - W, 0) / S)) + 1
        total = (num_windows - 1) * S + W
        device = values[self.input_names[0]].device
        idx = (torch.arange(num_windows, device=device)[:, None] * S
               + torch.arange(W, device=device)[None, :])     # (NW, W)
        windowed = {}
        for name, v in values.items():
            v = broadcast_time(v, T)
            pad = [0, 0] * (v.dim() - 2) + [0, total - T]
            v = nn.functional.pad(v, pad)
            windowed[name] = v[:, idx].reshape((B * num_windows, W)
                                               + v.shape[2:])
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=device)
        lengths = torch.as_tensor(lengths, device=device)
        starts = torch.arange(num_windows, device=device) * S
        win_lengths = torch.clamp(lengths[:, None] - starts[None, :], 0, W)
        num_valid = (win_lengths > 0).sum(dim=1)

        out = self.wrapped(windowed, lengths=win_lengths.reshape(-1),
                           training=training, **kwargs)
        merge = self.output_merge_type
        merged = {}
        for key, y in out.items():
            if key in windowed:
                continue
            Wp, C = y.shape[1], y.shape[-1]
            y = y.reshape(B, num_windows, Wp, C)
            if merge == "window":
                if Wp != W:
                    raise ValueError(
                        "window merge needs frame-aligned outputs (got %d "
                        "frames per %d-frame window); use cat/add/mean/mul "
                        "for length-changing models" % (Wp, W))
                merged[key] = self._crossfade(y, idx, B, total, T, C)
            elif merge == "cat":
                merged[key] = y.reshape(B, num_windows * Wp, C)
            elif merge in ("add", "mean", "mul"):
                valid = (win_lengths > 0)[:, :, None, None]
                if merge == "mul":
                    merged[key] = torch.where(valid, y, torch.ones_like(y)
                                              ).prod(dim=1)
                else:
                    summed = torch.where(valid, y, torch.zeros_like(y)
                                         ).sum(dim=1)
                    if merge == "mean":
                        summed = summed / torch.clamp(
                            num_valid, min=1)[:, None, None]
                    merged[key] = summed
            else:
                raise NotImplementedError("output_merge_type " + merge)
        return self._write_back(data_dict, merged, set())

    @staticmethod
    def _crossfade(y, idx, B, total, T, out_dim):
        """Triangular cross-fade overlap-add of (B, NW, W, C) chunks."""
        W = y.shape[2]
        weight = torch.minimum(torch.arange(1, W + 1, device=y.device),
                               torch.arange(W, 0, -1, device=y.device)
                               ).to(torch.float32)
        flat_idx = idx.reshape(-1)
        acc = torch.zeros(B, total, out_dim, device=y.device).index_add(
            1, flat_idx, (y * weight[None, None, :, None]).reshape(
                B, -1, out_dim))
        norm = torch.zeros(B, total, 1, device=y.device).index_add(
            1, flat_idx, weight[None, None, :, None].expand(
                y.shape[:3] + (1,)).reshape(B, -1, 1))
        return (acc / torch.clamp(norm, min=1e-6))[:, :T]

    def _write_back(self, data_dict, out, skip):
        updated = dict(data_dict)
        new_keys = [k for k in out if k not in skip]
        for i, key in enumerate(new_keys):
            name = self.output_names[i] if i < len(self.output_names) \
                else key
            updated[name] = out[key]
        return updated

    class Config(ModelConfig):
        def __init__(self, wrapped_model_config=None, window_size=500,
                     window_step=250, output_merge_type="window", **kwargs):
            super().__init__(**kwargs)
            self.wrapped_model_config = wrapped_model_config
            self.window_size = window_size
            self.window_step = window_step
            self.output_merge_type = output_merge_type

        def create_model(self, generator=None):
            return WindowingWrapper(
                self.wrapped_model_config.create_model(generator),
                self.input_names, self.output_names, self.window_size,
                self.window_step, self.output_merge_type)
