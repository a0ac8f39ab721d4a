"""Weight conversion between the JAX package's models (the rnn_dyn
acoustic model and the WaveNet vocoder) and the port's, both ways.

The JAX model's flax parameter tree, given as nested dicts of numpy
arrays, becomes the port's state dict (:func:`flax_to_state_dict`), and
back (:func:`state_dict_to_flax`).  The port names its parameters
after the flax tree, so the conversion is a flattening with two
adjustments:

- the ``params`` collection root is dropped;
- the JAX ``NamedForwardWrapper`` wraps its core in a ``_CallAdapter``
  (``wrapped/inner/...``), which the port does not need
  (``wrapped....``).

Covered leaves: the Dense ``g{i}_Linear_{j}`` ``kernel (in, out)`` and
``bias (out,)`` (``rnn_dyn.py:396-401``) and ``_BiFastLSTM``'s
``Wx (2, D, 4F)``, ``Wh (2, F, 4F)`` and ``b (2, 4F)`` under
``g{i}_LSTM/bi{layer}`` (``rnn_dyn.py:172-176``); WaveNet's
``wavenet/input_embed/embedding (out, R)``, ``block_{i}/dilated/kernel
(2, R, G)`` and the ``cond``, ``skip``, ``res``, ``post1`` and ``post2``
Dense ``kernel (in, out)`` and ``bias`` (``wavenet.py:26-88``).
Layouts are the same in both packages, so no leaf is transposed.
"""

from collections.abc import Mapping

import numpy as np
import torch


def flatten_flax(tree, prefix=()):
    """Nested mapping -> {path tuple: leaf}."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(flatten_flax(value, path))
        else:
            flat[path] = value
    return flat


def flax_to_state_dict(variables):
    """flax variables (``{"params": {...}}`` or the params tree itself)
    -> ``{dotted name: float32 tensor}`` for ``load_state_dict``."""
    tree = variables.get("params", variables) \
        if isinstance(variables, Mapping) else variables
    state = {}
    for path, leaf in flatten_flax(tree).items():
        if len(path) >= 2 and path[0] == "wrapped" and path[1] == "inner":
            path = path[:1] + path[2:]
        state[".".join(path)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    return state


def load_flax_params(model, variables):
    """Load flax variables into a port model; every parameter must be
    matched (``strict=True``).  Returns the model."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def state_dict_to_flax(state_dict):
    """The port's state dict -> the flax ``{"params": {...}}`` tree of
    float32 numpy arrays (the inverse of :func:`flax_to_state_dict`),
    for comparing the two packages' parameters after training."""
    params = {}
    for name, value in state_dict.items():
        path = name.split(".")
        if path[0] == "wrapped":
            path = ["wrapped", "inner"] + path[1:]
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().to(torch.float32).cpu().numpy()
    return {"params": params}
