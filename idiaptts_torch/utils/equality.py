"""Equality helpers for parameters and checkpoints: the port of
``idiaptts_tpu/utils/equality.py``.

``equal_iterable`` compares nested dicts, lists and arrays or tensors;
``equal_model`` two ``state_dict``s or ``nn.Module``s; ``equal_checkpoint``
two of the port's checkpoints (``<dir>/params_<suffix>``, written by
``ModularModelHandler.save_checkpoint``); ``tensor_pad`` pads a tensor
along one axis.
"""

import os

import numpy as np
import torch


def _host(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x)


def equal_iterable(a, b, atol=0.0):
    """Deep equality over nested dicts, lists and arrays or tensors;
    numbers within ``atol``."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return False
        return all(equal_iterable(a[k], b[k], atol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(equal_iterable(x, y, atol) for x, y in zip(a, b))
    try:
        a_arr, b_arr = _host(a), _host(b)
    except (TypeError, ValueError):
        return a == b
    if a_arr.shape != b_arr.shape:
        return False
    if a_arr.dtype.kind in "OU" or b_arr.dtype.kind in "OU":
        return bool(np.all(a_arr == b_arr))
    return bool(np.allclose(a_arr, b_arr, atol=atol))


def equal_model(model_a, model_b, atol=0.0):
    """Two ``state_dict``s (or ``nn.Module``s, through theirs) hold the
    same names, shapes and values within ``atol``."""
    state_a = model_a.state_dict() if isinstance(model_a, torch.nn.Module) \
        else model_a
    state_b = model_b.state_dict() if isinstance(model_b, torch.nn.Module) \
        else model_b
    if list(state_a) != list(state_b):
        return False
    return all(state_a[k].shape == state_b[k].shape
               and equal_iterable(state_a[k], state_b[k], atol)
               for k in state_a)


def equal_checkpoint(dir_a, suffix_a, dir_b, suffix_b, atol=0.0):
    """Compare two checkpoints ``<dir>/params_<suffix>`` (parameters,
    buffers and, with an EMA, the raw parameters)."""
    def load(directory, suffix):
        return torch.load(os.path.join(directory, "params_" + suffix),
                          map_location="cpu", weights_only=True)

    return equal_iterable(load(dir_a, suffix_a), load(dir_b, suffix_b),
                          atol)


def tensor_pad(tensor, target_length, axis=0, value=0.0):
    """Pad ``tensor`` with ``value`` at the end of ``axis`` to
    ``target_length``; a longer tensor is returned as it is."""
    tensor = torch.as_tensor(tensor)
    pad = target_length - tensor.shape[axis]
    if pad <= 0:
        return tensor
    shape = list(tensor.shape)
    shape[axis] = pad
    return torch.cat([tensor, tensor.new_full(shape, value)], dim=axis)
