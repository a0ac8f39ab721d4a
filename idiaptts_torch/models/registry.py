"""Model identifier registry: the port of
``idiaptts_tpu/models/registry.py``.

Maps a model-type identifier (``RNNDYN-...`` legacy strings, ``WaveNet``,
``EncDecDyn``) to a config builder, so hparams-driven recipes create
models by name.
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
    from idiaptts_torch.models.enc_dec import EncDecDyn
    return EncDecDyn.Config(input_names=("phonemes",),
                            output_names=("pred_acoustic_features",
                                          "pred_gate"),
                            out_dim=out_dim, in_dim=in_dim)
