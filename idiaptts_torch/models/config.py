"""Model config base: the port's copy of ``idiaptts_tpu/models/config.py``.

Named inputs and outputs, input merge types and ``create_model``.
Configs are plain picklable objects serialised as JSON into checkpoints,
with a ``module:QualName`` class marker per object.

A config JSON written by the JAX package names ``idiaptts_tpu.models``
classes.  :func:`_decode` maps each of its model config classes onto the
port's class of the same module and name (:data:`_PORTED`), and raises
``NotImplementedError`` for any other class path of that package.
"""

import importlib
import json


def _tuple(value):
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        return tuple(value)
    return (value,)


class ModelConfig:
    """Base class for model configs."""

    MERGE_CAT = "cat"
    MERGE_ADD = "add"
    MERGE_MEAN = "mean"
    MERGE_MUL = "mul"
    MERGE_ATTENTION = "attention"
    MERGE_LIST = "list"

    def __init__(self, input_names=None, output_names=None,
                 input_merge_type=MERGE_CAT, batch_first=True, name=None,
                 teacher_forcing_input_names=None):
        self.input_names = _tuple(input_names)
        self.output_names = _tuple(output_names)
        self.input_merge_type = input_merge_type
        self.batch_first = batch_first
        self.name = name
        # Inputs only available during training (filtered at inference).
        self.teacher_forcing_input_names = _tuple(
            teacher_forcing_input_names) or ()

    def create_model(self):
        raise NotImplementedError

    def all_input_names(self):
        """Every name this module reads from the data dict."""
        return tuple(self.input_names or ())

    # -- (de)serialisation ------------------------------------------------
    def to_json(self):
        return json.dumps(_encode(self), indent=2)

    @staticmethod
    def from_json(json_str):
        obj = _decode(json.loads(json_str))
        # JSON turns tuples into lists; restore tuples for name fields.
        for key in ("input_names", "output_names",
                    "teacher_forcing_input_names"):
            if getattr(obj, key, None) is not None:
                setattr(obj, key, tuple(getattr(obj, key)))
        return obj


# JAX-package class paths the port can build: (module, qualname) ->
# (port module, port qualname).  Every model config class of the JAX
# package has its counterpart under the same module and class name.
_PORTED_CLASSES = {
    "config": ("ModelConfig",),
    "rnn_dyn": ("RNNDyn.Config", "LayerConfig", "EmbeddingConfig"),
    "wavenet": ("WaveNetWrapper.Config",),
    "named": ("NamedForwardWrapper.Config", "NamedForwardSplitter.Config",
              "NamedForwardCombiner.Config", "Sequential.Config"),
    "intonation": ("NeuralFilters.Config", "PhraseNeuralFilters.Config"),
    "vtln": ("AllPassWarpLayer.Config",),
    "wrappers": ("WindowingWrapper.Config",),
    "enc_dec": ("AttentionDecoder.Config", "EncDecGraph.ModuleConfig",
                "EncDecGraph.Config", "EncDecDyn.Config"),
}
_PORTED = {("idiaptts_tpu.models." + module, qualname):
           ("idiaptts_torch.models." + module, qualname)
           for module, names in _PORTED_CLASSES.items() for qualname in names}
# rnn_dyn's module-level alias of RNNDyn.Config.
_PORTED[("idiaptts_tpu.models.rnn_dyn", "Config")] = \
    ("idiaptts_torch.models.rnn_dyn", "RNNDyn.Config")


def _port_class_path(module_name, qualname):
    """A JAX-package class path -> the port's, or NotImplementedError
    for a class that is no model config of the JAX package."""
    if module_name.split(".")[0] != "idiaptts_tpu":
        return module_name, qualname
    key = (module_name, qualname)
    if key not in _PORTED:
        raise NotImplementedError(
            "Unknown model config class {}:{}: no model config of "
            "idiaptts_tpu by that name has a counterpart in "
            "idiaptts_torch".format(module_name, qualname))
    return _PORTED[key]


def _encode(value):
    """Recursively encode config objects as JSON with class markers."""
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, set):
        return {"__set__": [_encode(v) for v in sorted(value)]}
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    if callable(value) and not hasattr(value, "__dict__"):
        return {"__repr__": repr(value)}
    if hasattr(value, "__dict__"):
        state = {"__class__": type(value).__module__ + ":"
                 + type(value).__qualname__}
        for key, attr in value.__dict__.items():
            if callable(attr) and not hasattr(attr, "__dict__"):
                continue
            state[key] = _encode(attr)
        return state
    return {"__repr__": repr(value)}


def _decode(value):
    if isinstance(value, list):
        return [_decode(v) for v in value]
    if isinstance(value, dict):
        if "__set__" in value:
            return set(_decode(value["__set__"]))
        if "__repr__" in value:
            return None
        if "__class__" in value:
            state = dict(value)
            cls_path = state.pop("__class__")
            if ":" in cls_path:                # module:Qual.Name form
                module_name, qualname = cls_path.split(":", 1)
            else:                              # legacy module.Name form
                module_name, qualname = cls_path.rsplit(".", 1)
            module_name, qualname = _port_class_path(module_name, qualname)
            cls = importlib.import_module(module_name)
            for part in qualname.split("."):
                cls = getattr(cls, part)
            obj = cls.__new__(cls)
            for key, attr in state.items():
                setattr(obj, key, _decode(attr))
            return obj
        return {k: _decode(v) for k, v in value.items()}
    return value
