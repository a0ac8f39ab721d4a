"""Parity of every rnn_dyn layer type and recurrent cell of the port
(idiaptts_torch.models.rnn_dyn) with the flax model of idiaptts_tpu, on
the same seeded inputs and the JAX weights converted by
``idiaptts_torch.models.convert``, and of ``models/flax_init.py``'s
numpy draw with the JAX handler's initial weights for each type.

Tolerances, measured at these sizes:

- GRU and simple-RNN cells, Embedding, EMB groups, pooling: the port
  repeats XLA's bf16 roundings, so
  the outputs agree to float32 rounding (measured 0 to 1.2e-7); bound
  1e-6 of the output's magnitude.
- Unidirectional LSTM: float32 accumulation order (measured 1.2e-7);
  bound 1e-6.
- Conv1d, BatchNorm, the VAE's Dense layers, Mask, Softmax,
  LogSoftmax and Exp in float32: bound 1e-5 of the magnitude (measured
  up to 1e-6); SELU, LeakyReLU and Softsign after a convolution: as
  Conv1d.

The JAX side runs jitted, as the JAX handler runs it: XLA then keeps
float32 where a bf16 value meets a float32 operation, which the port's
recurrent cells repeat; the float32 layers are fed float32 inputs.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models import rnn_dyn as torch_rnn

REL = 1e-6          # bf16-emulating paths: float32 rounding
REL_F32 = 1e-5      # float32 convolution and normalisation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def bf16_simple_carry(monkeypatch):
    """flax's SimpleCell with ``dtype=bfloat16`` returns a bf16 carry,
    which the JAX scan refuses against the float32 zeros that
    ``initialize_carry`` gives (ROADMAP fault 3.10).  Starting the carry
    in the cell's dtype lets the JAX module run; its values are those of
    the port's float32 carry, which holds bf16 values."""
    original = flax_nn.SimpleCell.initialize_carry

    def initialize_carry(self, rng, input_shape):
        return original(self, rng, input_shape).astype(
            self.dtype or jnp.float32)

    monkeypatch.setattr(flax_nn.SimpleCell, "initialize_carry",
                        initialize_carry)


def _configs(layers, in_dim, embs=()):
    """The same layer list as a JAX and a port config; ``layers`` and
    ``embs`` are (args, kwargs) of LayerConfig / EmbeddingConfig."""
    out = []
    for mod in (jax_rnn, torch_rnn):
        out.append(mod.RNNDyn.Config(
            in_dim=in_dim,
            layer_configs=[mod.LayerConfig(*a, **k) for a, k in layers],
            emb_configs=[mod.EmbeddingConfig(*a, **k) for a, k in embs]))
    return out


def _inputs(B, T, in_dim, embs=(), seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, in_dim).astype(np.float32)
    for a, _ in embs:          # index columns: (dim, name, num, groups)
        x = np.concatenate([x, rs.randint(0, a[2], (B, 1, 1)).repeat(
            T, axis=1).astype(np.float32)], axis=-1)
    return x


def _run(cfg_j, cfg_t, x, lengths, training=False, seed=0):
    """The JAX model initialised from ``seed``, its variables converted
    into the port, both applied to ``x``.  Returns (jax output, port
    output, JAX mutated collections, port intermediates, port model)."""
    model_j = cfg_j.create_model()
    model_t = cfg_t.create_model()
    xj = jnp.asarray(x)
    lj = None if lengths is None else jnp.asarray(lengths)
    # flax_init's draw (held to JAX's init below) spares a JAX init.
    variables = {k: v["wrapped"]["inner"] for k, v in
                 flax_init.rnn_dyn_params(cfg_t, seed).items()}
    ref, mutated = jax.jit(
        lambda v, x_, l_: model_j.apply(
            v, x_, lengths=l_, training=training,
            rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats", "intermediates"]))(variables, xj, lj)
    convert.load_flax_params(model_t, variables)
    inter = {}
    model_t.train(training)
    with torch.no_grad():
        out = model_t(torch.from_numpy(x),
                      lengths=None if lengths is None
                      else torch.from_numpy(lengths),
                      training=training, intermediates=inter)
    return np.asarray(ref), out.numpy(), mutated, inter, model_t


def _close(out, ref, rel):
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-3))


LENGTHS = np.array([13, 9, 4], np.int32)


@pytest.mark.parametrize("cell, nonlin", [
    ("GRU", None), ("RNN", "tanh"), ("RNN", "relu")])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_recurrent_cells_match_flax(cell, nonlin, bidirectional,
                                    bf16_simple_carry):
    """GRU and simple RNN, uni- and bidirectional, two layers over a bf16
    Dense input, unequal lengths (the reverse direction is flax's
    ``nn.RNN(reverse=True, keep_order=True, seq_lengths=...)``)."""
    layers = [(("Linear",), dict(out_dim=24, nonlin="ReLU")),
              ((cell,), dict(out_dim=16, num_layers=2, nonlin=nonlin,
                             bidirectional=bidirectional)),
              (("Linear",), dict(out_dim=5))]
    cfg_j, cfg_t = _configs(layers, 11)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 11), LENGTHS)
    _close(out, ref, REL)


@pytest.mark.parametrize("reverse", [False, True])
def test_fast_lstm_matches_flax(reverse):
    """The unidirectional ``_FastLSTM`` (and its masked reverse, which
    ``_MaskedFlipRNN`` does not use) on the same weights."""
    x = _inputs(3, 13, 10)
    mod_j = jax_rnn._FastLSTM(12)
    variables = mod_j.init(jax.random.PRNGKey(3), jnp.asarray(x),
                           jnp.asarray(LENGTHS), reverse)
    ref = np.asarray(mod_j.apply(variables, jnp.asarray(x),
                                 jnp.asarray(LENGTHS), reverse))
    mod_t = torch_rnn._FastLSTM(10, 12)
    mod_t.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    with torch.no_grad():
        out = mod_t(torch.from_numpy(x), torch.from_numpy(LENGTHS),
                    reverse).numpy()
    _close(out, ref, REL)


def test_unidirectional_lstm_group_matches_flax():
    cfg_j, cfg_t = _configs([(("LSTM",), dict(out_dim=12, num_layers=2)),
                             (("Linear",), dict(out_dim=4))], 9)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 9), LENGTHS)
    _close(out, ref, REL)


@pytest.mark.parametrize("layer_type, conv", [
    ("Conv1dRELU", dict(kernel_size=3, stride=2)),
    ("Conv1dSELU", dict(kernel_size=(5,), dilation=(2,), padding=4)),
    ("Conv1dLEAKYRELU", dict(kernel_size=3, groups=2, padding="VALID")),
    ("Conv1dSOFTSIGN", dict(kernel_size=4, stride=(3,), padding="CAUSAL")),
    ("Conv1d", dict(kernel_size=3, groups=4, dilation=3)),
])
def test_conv1d_matches_flax(layer_type, conv):
    """flax ``nn.Conv`` in float32 with stride, dilation, groups and
    SAME / explicit / VALID / CAUSAL padding, and the nonlinearity from
    the type's longest suffix."""
    cfg_j, cfg_t = _configs([((layer_type,), dict(out_dim=8, **conv))], 12)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 12), None)
    _close(out, ref, REL_F32)


def test_conv1d_lengths_follow_the_stride():
    """A stride-2 SAME convolution leaves ceil(L / 2) frames of each
    sequence; the SelectLastPooling after it reads the last of them."""
    layers = [(("Conv1d",), dict(out_dim=4, kernel_size=3, stride=2)),
              (("SelectLastPooling",), {})]
    _, cfg_t = _configs(layers, 5)
    model = cfg_t.create_model()
    x = torch.from_numpy(_inputs(3, 13, 5))
    conv = model.g0_Conv1d_0
    lengths = torch.from_numpy(LENGTHS)
    assert conv.out_lengths(lengths, 13).tolist() == [7, 5, 2]
    with torch.no_grad():
        full = conv(x)
        pooled = model(x, lengths=lengths)
    torch.testing.assert_close(pooled, full[torch.arange(3),
                                            torch.tensor([6, 4, 1])])


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_matches_flax(training):
    """BatchNorm1d after a float32 convolution: batch statistics over
    batch and time, padded frames included, in training (and the updated
    running averages, momentum 0.99); the running averages at
    inference."""
    layers = [(("Conv1dTANH",), dict(out_dim=10, kernel_size=3)),
              (("BatchNorm1d",), dict(out_dim=10))]
    cfg_j, cfg_t = _configs(layers, 7)
    x = _inputs(3, 13, 7) * 3.0 + 1.0
    ref, out, mutated, _, model = _run(cfg_j, cfg_t, x, LENGTHS,
                                       training=training)
    _close(out, ref, REL_F32)
    if training:
        stats = mutated["batch_stats"]["g1_BatchNorm1d"]
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(model.g1_BatchNorm1d, leaf).numpy(),
                np.asarray(stats[leaf]), rtol=REL_F32, atol=1e-7)
        assert not np.allclose(np.asarray(stats["var"]), 1.0)


def test_batchnorm_eval_uses_updated_running_averages():
    """Train-mode forwards move the buffers; an eval forward then
    normalises by them, as flax does with the mutated batch_stats."""
    layers = [(("BatchNorm1d",), dict(out_dim=4))]
    cfg_j, cfg_t = _configs(layers, 4)
    x = _inputs(2, 6, 4) * 2.0 + 3.0
    model_j = cfg_j.create_model()
    variables = model_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model_t = cfg_t.create_model()
    for _ in range(3):
        _, mutated = model_j.apply(variables, jnp.asarray(x), training=True,
                                   mutable=["batch_stats"])
        variables = {**variables, **mutated}
        model_t(torch.from_numpy(x), training=True)
    ref = np.asarray(model_j.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = model_t(torch.from_numpy(x)).numpy()
    _close(out, ref, REL_F32)


def test_embedding_layer_matches_flax():
    layers = [(("Embedding",), dict(out_dim=6, num_embeddings=9)),
              (("Linear",), dict(out_dim=4))]
    cfg_j, cfg_t = _configs(layers, 1)
    x = np.random.RandomState(0).randint(0, 9, (3, 13, 1)).astype(
        np.float32)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, x, LENGTHS)
    _close(out, ref, REL)


@pytest.mark.parametrize("groups", [(-1,), (1,), (-2,), (0, 2)])
def test_emb_groups_match_flax(groups):
    """An EMB table concatenated to every group ``(-1)``, to one group,
    counted from the end ``(-2)``, or to a set; its index in the trailing
    input column."""
    layers = [(("Linear",), dict(out_dim=16, nonlin="ReLU")),
              (("GRU",), dict(out_dim=8, bidirectional=True)),
              (("Linear",), dict(out_dim=5))]
    embs = [((4, "0", 7, groups), {})]
    cfg_j, cfg_t = _configs(layers, 9, embs)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 9, embs), LENGTHS)
    _close(out, ref, REL)


@pytest.mark.parametrize("pooling", ["SelectLastPooling", "MeanPooling"])
def test_pooling_matches_flax(pooling):
    """Pooling over each sequence's own length after a GRU, then a Dense
    group that the EMB table joins at frame 0 (the pooled branch of the
    JAX model's concatenation)."""
    layers = [(("GRU",), dict(out_dim=8)), ((pooling,), {}),
              (("Linear",), dict(out_dim=3))]
    embs = [((2, "0", 5, (2,)), {})]
    cfg_j, cfg_t = _configs(layers, 6, embs)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 6, embs), LENGTHS)
    assert ref.shape == (3, 3)
    _close(out, ref, REL)


def test_vae_mu_and_logvar_match_flax():
    """VanillaVAE's float32 Dense layers: at inference the latent is mu;
    mu and logvar reach the intermediates (JAX ``sow``)."""
    layers = [(("Linear",), dict(out_dim=12, nonlin="ReLU")),
              (("VanillaVAE",), dict(out_dim=6)),
              (("Linear",), dict(out_dim=4))]
    cfg_j, cfg_t = _configs(layers, 7)
    ref, out, mutated, inter, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 7),
                                       LENGTHS)
    _close(out, ref, REL_F32 + 2.0 ** -8)
    sown = mutated["intermediates"]["g1_VanillaVAE"]
    for leaf in ("vae_mu", "vae_logvar"):
        _close(inter["g1_VanillaVAE/" + leaf].numpy(),
               np.asarray(sown[leaf][0]), REL_F32)


@pytest.mark.parametrize("layer_type", ["Mask", "Softmax", "LogSoftmax",
                                        "Exp"])
def test_small_layers_match_flax(layer_type):
    """Each on a float32 convolution's output (a bf16 producer would
    test XLA's fusion of it, not the layer)."""
    layers = [(("Conv1d",), dict(out_dim=6, kernel_size=3)),
              ((layer_type,), {})]
    cfg_j, cfg_t = _configs(layers, 5)
    ref, out, _, _, _ = _run(cfg_j, cfg_t, _inputs(3, 13, 5), LENGTHS)
    _close(out, ref, REL_F32)
    if layer_type == "Mask":
        assert not out[2, 4:].any()


def test_apply_function_and_custom_layers():
    """ApplyFunction by name; a Custom torch module (its parameters in
    the state dict under the group's name) called with lengths."""

    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.full((4,), 2.0))

        def forward(self, x, lengths=None, training=False):
            return x * self.w

    cfg = torch_rnn.RNNDyn.Config(in_dim=4, layer_configs=[
        torch_rnn.LayerConfig("ApplyFunction", function="tanh"),
        torch_rnn.LayerConfig("Custom", module=Scale)])
    model = cfg.create_model()
    assert set(model.state_dict()) == {"g1_Custom.w"}
    x = torch.randn(2, 5, 4)
    torch.testing.assert_close(model(x), torch.tanh(x) * 2.0)


def test_always_dropout_needs_a_generator_at_inference():
    """AlwaysDropout is active at inference: a seeded generator gives
    the same mask twice, no generator raises."""
    cfg = torch_rnn.RNNDyn.Config(in_dim=8, layer_configs=[
        torch_rnn.LayerConfig("AlwaysDropout", dropout=0.5)])
    model = cfg.create_model()
    x = torch.ones(4, 16, 8)
    a = model(x, generator=torch.Generator().manual_seed(5))
    b = model(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.3 < (a == 0).float().mean().item() < 0.7
    with pytest.raises(ValueError, match="Generator"):
        model(x)


def test_remat_keeps_names_outputs_and_gradients():
    """``remat`` on a group (torch.utils.checkpoint) changes neither the
    parameter names nor the training forward and gradients, dropout and
    BatchNorm included: the recompute replays the generator and updates
    no running averages."""
    def build(remat):
        cfg = torch_rnn.RNNDyn.Config(in_dim=6, layer_configs=[
            torch_rnn.LayerConfig("Linear", out_dim=8, nonlin="ReLU",
                                  dropout=0.3, remat=remat),
            torch_rnn.LayerConfig("BatchNorm1d", out_dim=8, remat=remat),
            torch_rnn.LayerConfig("GRU", out_dim=4, remat=remat)])
        return cfg.create_model(torch.Generator().manual_seed(0))

    x = torch.randn(2, 7, 6)
    results = []
    for remat in (False, True):
        model = build(remat)
        out = model(x, lengths=torch.tensor([7, 5]), training=True,
                    generator=torch.Generator().manual_seed(9))
        out.square().sum().backward()
        results.append((out.detach(), {n: p.grad for n, p in
                                       model.named_parameters()},
                        model.g1_BatchNorm1d.mean.clone()))
    (out_a, grads_a, mean_a), (out_b, grads_b, mean_b) = results
    assert set(grads_a) == set(grads_b)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    torch.testing.assert_close(mean_a, mean_b, rtol=0, atol=0)
    for name in grads_a:
        torch.testing.assert_close(grads_a[name], grads_b[name])


@pytest.mark.parametrize("model_string", [
    "RNNDYN-2_RELU_32-3_BiGRU_24-1_FC_67",
    "RNNDYN-2_LSTM_32-1_BiRNNTANH_8-1_FC_67",
    "RNNDYN-129x16_EMB_(-1)-2_RELU_32-1_BiLSTM_16-1_FC_67",
    "RNNDYN-2_Conv1dRELU_64_3x1_s1_d2-1_BatchNorm1dLSTM_32-1_PoolLast_1",
    "RNNDYN-1_RELU_16-1_VAE_8-1_Conv1dTANH_8_3_g2-1_FC_4",
])
def test_flax_init_repeats_the_jax_draw_for_every_type(model_string,
                                                      bf16_simple_carry):
    """``flax_init.rnn_dyn_params`` against the JAX handler's initial
    variables: the same tree (and batch_stats), every leaf within 4e-6
    (measured 1.9e-6: the QR of the orthogonal recurrent kernels and the
    embedding's normal draw, erfinv in float64 rather than float32)."""
    from idiaptts_tpu.train.handler import ModularModelHandler
    nq = 14
    cfg_j = jax_rnn.convert_legacy_string(model_string, nq)
    cfg_j.input_names, cfg_j.output_names = ("questions",), ("pred",)
    for layer in cfg_j.layer_configs:   # JAX refuses the "3x1" kernel
        if layer.layer_type.startswith("Conv1d"):
            layer.kernel_size = layer.kernel_size[:1]
    # ModularModelHandler.init_params's call, jitted.
    handler = ModularModelHandler()
    handler.model_config, handler.model = cfg_j, cfg_j.create_model()
    data, lengths = handler._batch_to_model_input({
        "questions": np.zeros((1, 16, nq), np.float32),
        "_lengths": {"questions": np.array([16])}})
    rng = jax.random.PRNGKey(1234)
    ref = jax.jit(lambda d, n: handler.model.init(
        {"params": rng, "dropout": rng, "latent": rng}, d, lengths=n,
        training=True))(data, lengths)
    ref = convert.flatten_flax(jax.tree_util.tree_map(np.asarray,
                                                      dict(ref)))
    got = convert.flatten_flax(flax_init.rnn_dyn_params(
        torch_rnn.convert_legacy_string(model_string, nq)))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert got[path].dtype == np.float32 and got[path].shape == leaf.shape
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=4e-6,
                                   err_msg=str(path))


def test_converter_round_trips_every_new_leaf():
    """``state_dict_to_flax`` puts BatchNorm's buffers into
    ``batch_stats`` and every parameter into ``params`` under the flax
    names; ``flax_to_state_dict`` maps both back."""
    cfg = torch_rnn.convert_legacy_string(
        "RNNDYN-4x8_EMB_(-1)-1_Conv1dRELU_16_3-1_BatchNorm1dGRU_8"
        "-1_VAE_4-1_FC_3", 10)
    cfg.input_names, cfg.output_names = ("q", "s"), ("pred",)
    model = cfg.create_model(torch.Generator().manual_seed(3))
    tree = convert.state_dict_to_flax(model.state_dict())
    assert set(tree) == {"params", "batch_stats"}
    inner = tree["params"]["wrapped"]["inner"]
    assert inner["g1_GRU"]["fwd0"]["hn"]["bias"].shape == (8,)
    assert "bias" not in inner["g1_GRU"]["fwd0"]["hr"]
    assert inner["g0_Conv1dRELU_0"]["kernel"].shape == (3, 17, 16)
    assert set(tree["batch_stats"]["wrapped"]["inner"]["g2_BatchNorm1d"]) \
        == {"mean", "var"}
    again = convert.flax_to_state_dict(tree)
    assert set(again) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v)
