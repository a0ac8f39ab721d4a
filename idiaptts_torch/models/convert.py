"""Weight conversion between the JAX package's models and the port's,
both ways.

The JAX model's flax variables, given as nested dicts of numpy arrays,
become the port's state dict (:func:`flax_to_state_dict`), and back
(:func:`state_dict_to_flax`).  The port names its parameters after the
flax tree, so the conversion is a flattening with three adjustments:

- the ``params`` collection root is dropped;
- the ``batch_stats`` collection (flax BatchNorm's running ``mean`` and
  ``var``) becomes the port's buffers of the same names, merged into the
  state dict beside the parameters;
- the JAX ``NamedForwardWrapper`` of an rnn_dyn model wraps its core in
  a ``_CallAdapter`` (``.../wrapped/inner/...``), which the port does not
  need (``....wrapped....``), wherever the wrapper sits in the tree.

Covered leaves, all in flax's layouts, so no leaf is transposed: the
Dense ``kernel (in, out)`` and ``bias (out,)`` of ``g{i}_Linear_{j}``,
of the GRU cells' ``ir``/``iz``/``in``/``hr``/``hz``/``hn`` and the
simple cells' ``i``/``h`` (``g{i}_GRU/fwd{l}``, ``bwd{l}``) and of the
VAE's ``mu``/``logvar``; ``_BiFastLSTM``'s ``Wx (2, D, 4F)``, ``Wh (2, F,
4F)`` and ``b (2, 4F)`` (``g{i}_LSTM/bi{l}``) and ``_FastLSTM``'s ``Wx
(D, 4F)``, ``Wh (F, 4F)``, ``b (4F,)`` (``g{i}_LSTM/fwd{l}``); Conv1d's
``kernel (K, in/groups, out)`` and ``bias``; BatchNorm's ``scale``,
``bias`` and batch stats ``mean``, ``var``; the ``embedding (num, F)``
tables of ``emb_{k}`` and ``g{i}_Embedding``; WaveNet's
``wavenet/input_embed/embedding (out, R)``, ``block_{i}/dilated/kernel
(2, R, G)`` and the ``cond``, ``skip``, ``res``, ``post1`` and ``post2``
Dense ``kernel (in, out)`` and ``bias`` (``wavenet.py:26-88``).

The other model types name their parameters after the flax tree as
well: the intonation filters' ``pole_logit`` and ``phase`` and the
phrase model's ``phrase_bias`` (``intonation.py``), the atom model
under ``atom_model`` and ``neural_filters``; the VTLN layer's
``all_pass_warp/alpha_layer_<i>`` Dense; ``Sequential``'s and
``EncDecGraph``'s ``modules_list_<i>`` scopes; the encoder-decoder's
``encoder_<i>`` Dense, and its decoder step (``decoder`` or ``step``):
``prenet``, the ``OptimizedLSTMCell`` kernels ``ii``/``if``/``ig``/``io``
(no bias) and ``hi``/``hf``/``hg``/``ho`` (with bias), ``proj``,
``gate``, ``query``, ``key`` and the named projections
(``enc_dec.py``); ``WindowingWrapper``'s ``wrapped``.
"""

from collections.abc import Mapping

import numpy as np
import torch

# flax's BatchNorm running averages: the leaves of ``batch_stats``.
BATCH_STATS = ("mean", "var")


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


def _drop_adapter(path):
    """The flax path without the ``inner`` scope of each ``wrapped``
    adapter."""
    out = []
    for name in path:
        if name == "inner" and out and out[-1] == "wrapped":
            continue
        out.append(name)
    return tuple(out)


def _state_names(tree):
    state = {}
    for path, leaf in flatten_flax(tree).items():
        path = _drop_adapter(path)
        state[".".join(path)] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    return state


def flax_to_state_dict(variables):
    """flax variables (``{"params": {...}, "batch_stats": {...}}`` or the
    params tree itself) -> ``{dotted name: float32 tensor}`` for
    ``load_state_dict``."""
    if not isinstance(variables, Mapping) or "params" not in variables:
        return _state_names(variables)
    state = _state_names(variables["params"])
    state.update(_state_names(variables.get("batch_stats") or {}))
    return state


def load_flax_params(model, variables):
    """Load flax variables into a port model; every parameter and buffer
    must be matched (``strict=True``).  Returns the model."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def state_dict_to_flax(state_dict):
    """The port's state dict -> the flax ``{"params": {...}}`` tree of
    float32 numpy arrays, with ``"batch_stats"`` beside it when the model
    has BatchNorm buffers (the inverse of :func:`flax_to_state_dict`), for
    comparing the two packages' parameters after training."""
    variables = {"params": {}}
    for name, value in state_dict.items():
        path = name.split(".")
        if "wrapped" in path:
            # The adapter scope follows the innermost wrapper.
            cut = len(path) - path[::-1].index("wrapped")
            path = path[:cut] + ["inner"] + path[cut:]
        node = variables.setdefault(
            "batch_stats" if path[-1] in BATCH_STATS else "params", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().to(torch.float32).cpu().numpy()
    return variables
