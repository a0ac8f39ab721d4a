"""Model identifier registry: the port of
``idiaptts_tpu/models/registry.py``.

Maps a model-type identifier (``RNNDYN-...`` legacy strings, ``WaveNet``,
``EncDecDyn``) to a config builder, so hparams-driven recipes create
models by name.  ``EncDecDyn`` has no port yet and raises.
"""

from idiaptts_torch.models.rnn_dyn import IDENTIFIER as RNNDYN_IDENTIFIER
from idiaptts_torch.models.rnn_dyn import convert_legacy_string

_REGISTRY = {}


def register(identifier):
    """Decorator: register ``builder(in_dim, out_dim, hparams)`` under
    ``identifier``."""
    def deco(builder):
        _REGISTRY[identifier] = builder
        return builder
    return deco


def create_model_config(model_type, in_dim, out_dim=None, hparams=None):
    """Model-type string -> ModelConfig."""
    if model_type.upper().startswith(RNNDYN_IDENTIFIER):
        return convert_legacy_string(model_type, in_dim, hparams=hparams)
    if model_type in _REGISTRY:
        return _REGISTRY[model_type](in_dim, out_dim, hparams)
    raise NotImplementedError("Unknown model type: {}".format(model_type))


@register("WaveNet")
def _wavenet(in_dim, out_dim, hparams):
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    return WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        out_channels=out_dim or 256)


@register("EncDecDyn")
def _enc_dec(in_dim, out_dim, hparams):
    raise NotImplementedError(
        "EncDecDyn (idiaptts_tpu/models/enc_dec.py) is not ported yet; "
        "ROADMAP.md queue 1 item 7 (the remaining models and trainers) "
        "ports it")
