"""Parity of the port's rnn_dyn acoustic model (idiaptts_torch.models)
with the flax model of idiaptts_tpu, weights moved by
``idiaptts_torch.models.convert``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_torch.models import convert
from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.models import rnn_dyn as torch_rnn

_STRINGS = [
    "RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67",          # Interspeech'18
    "RNNDYN-6_TANH_1024-1_FC_67",                        # Merlin preset
    "RNNDYN-2_RELU_1024-3_BiGRU_427-1_FC_67",           # ICASSP'19 preset
    "RNNDYN-1_RELU_32-1_FC_67",                          # baseline preset
    "RNNDYN-129x128_EMB_(-1)-2_RELU_1024-3_BiLSTM_512-1_FC_67",
    "RNNDYN-2_Conv1dRELU_64_3x1_s1_d2-1_BatchNorm1dLSTM_32-1_PoolLast_1",
]


def _describe(cfg):
    layers = [dict(vars(layer)) for layer in cfg.layer_configs]
    embs = [dict(vars(e)) for e in cfg.emb_configs]
    return cfg.in_dim, layers, embs


@pytest.mark.parametrize("model_string", _STRINGS)
def test_convert_legacy_string_matches_jax(model_string):
    in_dim = 142
    assert _describe(torch_rnn.convert_legacy_string(model_string, in_dim)) \
        == _describe(jax_rnn.convert_legacy_string(model_string, in_dim))


@pytest.mark.parametrize("preset", [
    "merlin_acoustic_config", "interspeech18_baseline_config",
    "icassp19_baseline_config"])
def test_presets_match_jax(preset):
    assert _describe(getattr(torch_rnn, preset)(141, 67)) \
        == _describe(getattr(jax_rnn, preset)(141, 67))


@pytest.mark.parametrize("model_string", [
    "RNNDYN-2_RELU_64-3_BiGRU_32-1_FC_67",
    "RNNDYN-2_LSTM_32-1_FC_67",
    "RNNDYN-1_Conv1dRELU_16_3x1-1_FC_8",
    "RNNDYN-4x8_EMB_(-1)-1_RELU_16-1_FC_8",
])
def test_unported_layer_types_raise(model_string):
    """The four layer types that once raised here (BiGRU, unidirectional
    LSTM, Conv1d, EMB groups) build and match the flax model on
    converted weights, with unequal lengths.  The JAX legacy grammar
    gives the Conv1d kernel "3x1" as (3, 1), which flax refuses; the
    port reads it as the 1-D kernel 3, and the JAX side gets that
    kernel.  Bound: one bf16 ulp of the output's magnitude (the FC
    output is bf16 on both sides); measured 0."""
    in_dim, B, T = 12, 3, 11
    cfg_j = jax_rnn.convert_legacy_string(model_string, in_dim)
    cfg_t = torch_rnn.convert_legacy_string(model_string, in_dim)
    for layer in cfg_j.layer_configs:
        if layer.layer_type.startswith("Conv1d"):
            layer.kernel_size = layer.kernel_size[:1]
    rs = np.random.RandomState(1)
    x = rs.randn(B, T, in_dim).astype(np.float32)
    if cfg_t.emb_configs:
        x[..., -1] = rs.randint(0, 4, (B, 1))
    lengths = np.array([11, 7, 2], np.int32)
    model_j, model_t = cfg_j.create_model(), cfg_t.create_model()
    params = jax.jit(model_j.init)({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(x), jnp.asarray(lengths))
    ref = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(x),
                                            jnp.asarray(lengths)))
    convert.load_flax_params(model_t,
                             jax.tree_util.tree_map(np.asarray, params))
    with torch.inference_mode():
        out = model_t(torch.from_numpy(x),
                      lengths=torch.from_numpy(lengths)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 ** -8 * np.abs(ref).max())


def test_registry_creates_configs_by_name():
    """``create_model_config``: legacy strings and WaveNet as the JAX
    registry gives them, a registered builder, and the EncDecDyn
    refusal naming the queue item that ports it."""
    from idiaptts_tpu.models import registry as jax_registry
    from idiaptts_torch.models import registry
    for name in ("RNNDYN-2_RELU_64-3_BiGRU_32-1_FC_67", "WaveNet"):
        got = registry.create_model_config(name, 12, 256)
        ref = jax_registry.create_model_config(name, 12, 256)
        assert type(got).__qualname__ == type(ref).__qualname__
        for key in ("input_names", "output_names", "out_channels"):
            assert getattr(got, key, None) == getattr(ref, key, None)
        again = ModelConfig.from_json(got.to_json())
        assert type(again) is type(got)
        assert again.to_json() == got.to_json()
    string = "RNNDYN-1_RELU_8-1_FC_2"
    assert _describe(registry.create_model_config(string, 5)) == \
        _describe(jax_registry.create_model_config(string, 5))

    @registry.register("Tiny")
    def _tiny(in_dim, out_dim, hparams):
        return torch_rnn.convert_legacy_string(
            "RNNDYN-1_FC_{}".format(out_dim), in_dim)

    assert registry.create_model_config("Tiny", 3, 2).layer_configs[
        0].out_dim == 2
    # EncDecDyn builds the port's config, as the JAX registry builds its.
    from idiaptts_torch.models.enc_dec import EncDecDyn
    built = registry.create_model_config("EncDecDyn", 12, 67)
    assert type(built) is EncDecDyn.Config
    ref = jax_registry.create_model_config("EncDecDyn", 12, 67)
    assert (built.input_names, built.output_names, built.out_dim) == \
        (ref.input_names, ref.output_names, ref.out_dim)
    assert built.create_model().encoder_0.kernel.shape == (12, 256)
    with pytest.raises(NotImplementedError, match="Unknown model type"):
        registry.create_model_config("NoSuchModel", 12)


def test_unported_jax_config_class_raises():
    """A JAX config JSON of the enc-dec model builds the port's class
    (every model config class of the JAX package has its counterpart);
    a class path that is no model config of the JAX package is still
    refused."""
    from idiaptts_torch.models.enc_dec import EncDecDyn
    blob = json.dumps({"__class__":
                       "idiaptts_tpu.models.enc_dec:EncDecDyn.Config",
                       "input_names": ["phonemes"], "out_dim": 5})
    assert type(ModelConfig.from_json(blob)) is EncDecDyn.Config
    with pytest.raises(NotImplementedError, match="Unknown model config"):
        ModelConfig.from_json(json.dumps(
            {"__class__": "idiaptts_tpu.models.enc_dec:NoSuchModel.Config"}))


def test_masked_flip_matches_jax():
    x = np.random.RandomState(0).randn(3, 7, 2).astype(np.float32)
    lengths = np.array([7, 4, 1])
    ref = np.asarray(jax_rnn.masked_flip(jnp.asarray(x),
                                         jnp.asarray(lengths)))
    out = torch_rnn.masked_flip(torch.from_numpy(x),
                                torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(out, ref)


def _models(model_string, in_dim, named=True):
    cfg_j = jax_rnn.convert_legacy_string(model_string, in_dim)
    cfg_t = torch_rnn.convert_legacy_string(model_string, in_dim)
    if named:
        for cfg in (cfg_j, cfg_t):
            cfg.input_names = ("questions",)
            cfg.output_names = ("pred",)
    return cfg_j.create_model(), cfg_t.create_model()


@pytest.mark.parametrize("named", [True, False])
def test_small_model_matches_flax(named):
    """A few layers at narrow widths, unequal lengths: the flax model and
    the port with converted weights."""
    in_dim, B, T = 41, 3, 29
    model_j, model_t = _models("RNNDYN-2_RELU_64-2_BiLSTM_128-1_FC_67",
                               in_dim, named)
    rs = np.random.RandomState(0)
    x = rs.randn(B, T, in_dim).astype(np.float32)
    lengths = np.array([29, 17, 5], np.int32)
    inputs_j = {"questions": jnp.asarray(x)} if named else jnp.asarray(x)
    params = model_j.init({"params": jax.random.PRNGKey(0)}, inputs_j,
                          lengths=jnp.asarray(lengths), training=False)
    ref = model_j.apply(params, inputs_j, lengths=jnp.asarray(lengths),
                        training=False)
    ref = np.asarray(ref["pred"] if named else ref)
    convert.load_flax_params(model_t,
                             jax.tree_util.tree_map(np.asarray, params))
    inputs_t = {"questions": torch.from_numpy(x)} if named \
        else torch.from_numpy(x)
    with torch.inference_mode():
        out = model_t(inputs_t, lengths=torch.from_numpy(lengths))
    out = (out["pred"] if named else out).numpy()
    assert out.shape == ref.shape == (B, T, 67)
    assert out.dtype == np.float32
    # The FC output is bf16 on both sides, and on the CPU the JAX bf16
    # matmuls round differently (ROADMAP fault 3.2): 4 bf16 ulps at the
    # output's magnitude.  Measured 1 ulp.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 ** -6 * np.abs(ref).max())


def test_converter_names_every_parameter():
    model_j, model_t = _models("RNNDYN-1_RELU_16-1_BiLSTM_16-1_FC_4", 6)
    params = model_j.init({"params": jax.random.PRNGKey(1)},
                          {"questions": jnp.zeros((1, 3, 6))},
                          lengths=jnp.array([3]), training=False)
    state = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))
    assert set(state) == set(model_t.state_dict())
    assert state["wrapped.g1_LSTM.bi0.Wx"].shape == (2, 16, 64)


def test_init_is_seeded():
    cfg = torch_rnn.convert_legacy_string(
        "RNNDYN-1_RELU_16-1_BiLSTM_16-1_FC_4", 6)
    a = cfg.create_model(torch.Generator().manual_seed(3)).state_dict()
    b = cfg.create_model(torch.Generator().manual_seed(3)).state_dict()
    c = cfg.create_model(torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["g0_Linear_0.kernel"], c["g0_Linear_0.kernel"])
