"""The encoder-decoder models and trainer of the port against the JAX
package: the LSTM cell against ``flax.linen.OptimizedLSTMCell``,
``EncDecDyn`` teacher-forced and free-running, ``AttentionDecoder``
with fixed and dot-product attention, ``EncDecGraph``'s process groups,
config JSON round trips, and an epoch of
``EncDecMonophoneModelTrainer`` on the fixtures against the JAX
trainer's from the same weights.

Everything is float32.  Tolerances, measured: the cell within 1e-6 of
its magnitude (measured 1.2e-7); the decoders within 1e-5 (measured up
to 2e-6: per-chunk float32 matmuls summed in another order, carried
through the recurrence); the trainer epoch's loss within 1e-4 relative
and parameters within 2 lr a step.
"""

import json
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.models import enc_dec as jax_ed
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.train import enc_dec_trainer as jax_tr
from idiaptts_torch.models import convert, registry
from idiaptts_torch.models import enc_dec as torch_ed
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models.config import ModelConfig
from idiaptts_torch.train import enc_dec_trainer as torch_tr

REL = 1e-5
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, rel=REL, name=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-6), \
        (name, np.abs(got - ref).max())


def test_lstm_cell_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 11).astype(np.float32)
    c = rng.randn(3, 6).astype(np.float32)
    h = rng.randn(3, 6).astype(np.float32)
    cell = flax_nn.OptimizedLSTMCell(6)
    variables = cell.init(jax.random.PRNGKey(0), (c, h), x)
    # Non-zero biases, so their layout is checked too.
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.randn(*v.shape).astype(np.float32),
        _to_np(variables))
    (rc, rh), _ = jax.jit(cell.apply)(params, (c, h), x)
    port = torch_ed.OptimizedLSTMCell(11, 6)
    convert.load_flax_params(port, params)
    (pc, ph), out = port((torch.from_numpy(c), torch.from_numpy(h)),
                         torch.from_numpy(x))
    assert out is ph
    _close(pc, rc, 1e-6)
    _close(ph, rh, 1e-6)


def _enc_dec_configs(in_dim=7, out_dim=5):
    kwargs = dict(input_names=("phonemes",),
                  output_names=("pred_acoustic_features", "pred_gate"),
                  encoder_units=(16, 12), out_dim=out_dim, prenet_dim=8,
                  decoder_dim=10, n_frames_per_step=2)
    return (jax_ed.EncDecDyn.Config(**kwargs),
            torch_ed.EncDecDyn.Config(in_dim=in_dim, **kwargs))


def _enc_dec_data(B=2, P=6, T=17, in_dim=7, out_dim=5):
    rng = np.random.RandomState(1)
    durations = rng.randint(1, 5, size=(B, P))
    attn = np.zeros((B, T, P - 1), np.float32)     # one phone short: padded
    for b in range(B):
        frames = np.repeat(np.arange(P - 1), durations[b, :P - 1])[:T]
        attn[b, np.arange(len(frames)), frames] = 1.0
    return {"phonemes": rng.rand(B, P, in_dim).astype(np.float32),
            "attention_matrix": attn,
            "acoustic_features": rng.randn(B, T, out_dim).astype(np.float32)}


@pytest.mark.parametrize("training", [True, False])
def test_enc_dec_dyn_matches_jax(training):
    """Teacher-forced (training with the target) and free-running
    (inference) decoding from the same weights."""
    cfg_j, cfg_t = _enc_dec_configs()
    data = _enc_dec_data()
    jm = cfg_j.create_model()
    variables = jm.init(jax.random.PRNGKey(0), data, training=True)
    model = cfg_t.create_model()
    state = convert.flax_to_state_dict(_to_np(variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    ref = jax.jit(lambda v, d: jm.apply(v, d, training=training))(
        variables, data)
    got = model({k: torch.from_numpy(v) for k, v in data.items()},
                training=training)
    for key in ("pred_acoustic_features", "pred_gate"):
        _close(got[key], ref[key], name=key)
    # The two modes differ (the selector is live).
    other = model({k: torch.from_numpy(v) for k, v in data.items()},
                  training=not training)
    assert not torch.allclose(other["pred_acoustic_features"],
                              got["pred_acoustic_features"])


def _decoder_configs(attention_type, p_tf=1.0):
    kwargs = dict(attention_type=attention_type, input_names=("memory",),
                  teacher_forcing_input_names=("target",),
                  prenet_dims=(8, 6), lstm_dims=(10, 9),
                  projections=(("pred_frames", 4, (7,), True),
                               ("pred_stop", 1, (), False)),
                  decoder_output_name="decoder_out", n_frames_per_step=2,
                  attention_dim=5, p_teacher_forcing=p_tf,
                  max_decoder_steps=8)
    return (jax_ed.AttentionDecoder.Config(**kwargs),
            torch_ed.AttentionDecoder.Config(memory_dim=7, **kwargs))


@pytest.mark.parametrize("attention_type,training", [
    ("fixed", True), ("fixed", False), ("dot", True), ("dot", False)])
def test_attention_decoder_matches_jax(attention_type, training):
    """Fixed and dot-product attention, teacher-forced and free-running;
    padded memory frames are masked (dot) or receive no attention
    (fixed)."""
    cfg_j, cfg_t = _decoder_configs(attention_type)
    rng = np.random.RandomState(2)
    data = {"memory": rng.randn(2, 6, 7).astype(np.float32),
            "target": rng.randn(2, 12, 4).astype(np.float32),
            "attention_matrix": _enc_dec_data(P=5, T=12)["attention_matrix"]}
    lengths = np.array([6, 4])
    jm = cfg_j.create_model()
    variables = jm.init(jax.random.PRNGKey(3), data,
                        lengths=jnp.asarray(lengths), training=True)
    model = cfg_t.create_model()
    convert.load_flax_params(model, _to_np(variables))
    ref = jax.jit(lambda v, d, n: jm.apply(v, d, lengths=n,
                                           training=training))(
        variables, data, jnp.asarray(lengths))
    got = model({k: torch.from_numpy(v) for k, v in data.items()},
                lengths=torch.from_numpy(lengths), training=training)
    keys = ["decoder_out", "pred_frames", "pred_stop"]
    if attention_type == "dot":
        keys.append("attention")
        assert float(got["attention"][1, :, 4:].detach().abs().max()) < 1e-30
    for key in keys:
        _close(got[key], ref[key], name=key)


def test_enc_dec_graph_groups_match_jax(num_questions):
    """EncDecGraph: an rnn_dyn encoder in group 0 and the decoder in
    group 1, listed in the other order; modules_list_<i> scopes."""
    configs = []
    for ed, rnn, port in ((jax_ed, jax_rnn, False),
                          (torch_ed, torch_rnn, True)):
        enc = rnn.convert_legacy_string("RNNDYN-1_RELU_7-1_FC_7", 9)
        dec = _decoder_configs("dot")[1 if port else 0]
        modules = [ed.EncDecGraph.ModuleConfig(
                       config=dec, process_group=1, name="decoder",
                       input_names=("memory",)),
                   ed.EncDecGraph.ModuleConfig(
                       config=enc, process_group=0, name="encoder",
                       input_names=("inputs",), output_names=("memory",))]
        configs.append(ed.EncDecGraph.Config(modules=modules))
    assert configs[1].module_config("encoder").process_group == 0
    rng = np.random.RandomState(4)
    data = {"inputs": rng.rand(2, 6, 9).astype(np.float32),
            "target": rng.randn(2, 12, 4).astype(np.float32)}
    jm = configs[0].create_model()
    variables = jm.init(jax.random.PRNGKey(5), data, training=True)
    model = configs[1].create_model()
    state = convert.flax_to_state_dict(_to_np(variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    ref = jax.jit(lambda v, d: jm.apply(v, d, training=True))(variables, data)
    got = model({k: torch.from_numpy(v) for k, v in data.items()},
                training=True)
    for key in ("memory", "pred_frames", "attention"):
        _close(got[key], ref[key], 1e-4, name=key)


def test_config_json_round_trips():
    """JAX config JSONs of every enc-dec class build the port's classes,
    and the port's own JSON builds the same model again; the registry
    builds EncDecDyn."""
    cfg_j, _ = _enc_dec_configs()
    cfg = ModelConfig.from_json(cfg_j.to_json())
    assert type(cfg) is torch_ed.EncDecDyn.Config
    cfg.in_dim = 7
    again = ModelConfig.from_json(cfg.to_json())
    assert type(again) is torch_ed.EncDecDyn.Config
    m1, m2 = cfg.create_model(), again.create_model()
    for (k1, v1), (k2, v2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2)
    dec = ModelConfig.from_json(_decoder_configs("dot")[0].to_json())
    assert type(dec) is torch_ed.AttentionDecoder.Config
    assert dec.projections[0] == ["pred_frames", 4, [7], True]
    built = registry.create_model_config("EncDecDyn", 12, 67)
    assert type(built) is torch_ed.EncDecDyn.Config
    assert (built.in_dim, built.out_dim) == (12, 67)
    with pytest.raises(NotImplementedError, match="Unknown model config"):
        ModelConfig.from_json(json.dumps(
            {"__class__": "idiaptts_tpu.models.enc_dec:NoSuch.Config"}))


def _trainer(mod, fixtures_dir, id_list, tmp_path, port):
    cls = mod.EncDecMonophoneModelTrainer
    hp = cls.create_hparams()
    hp.num_coded_sps = 20
    hp.out_dir = str(tmp_path)
    hp.model_name = "encdec"
    hp.epochs = 1
    hp.batch_size_train = 3
    hp.learning_rate = LR
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = False
    hp.label_type = "full_state_align"
    if port:
        hp.device = "cpu"
    labels = os.path.join(fixtures_dir, "labels")
    trainer = cls(hp, list(id_list),
                  dir_phoneme_labels=os.path.join(labels, "label_state_align"),
                  dir_durations=os.path.join(fixtures_dir, "dur"),
                  dir_world_features=os.path.join(fixtures_dir, "WORLD"),
                  file_symbol_dict=os.path.join(labels, "mono_phone.list"))
    trainer.init(hp)
    return trainer


def test_enc_dec_trainer_epoch_matches_jax(fixtures_dir, id_list, tmp_path):
    """One epoch (teacher-forced training, then free-running validation)
    of the port's trainer against the JAX trainer's, from the JAX draw,
    with the gate target and its BCE loss."""
    jt = _trainer(jax_tr, fixtures_dir, id_list, tmp_path / "jax", False)
    tt = _trainer(torch_tr, fixtures_dir, id_list, tmp_path / "port", True)
    assert tt.id_list_train == jt.id_list_train
    sample, _ = tt.dataset_train.get_id_name(tt.id_list_train[0])
    assert sample["gate_target"][-1, 0] == 1.0 \
        and sample["gate_target"][:-1].sum() == 0
    convert.load_flax_params(tt.model_handler.model,
                             _to_np(jt.model_handler.params))
    val_j, train_j = jt.train(jt.hparams)
    val_t, train_t = tt.train(tt.hparams)
    assert train_t[0] == pytest.approx(train_j[0], rel=1e-4)
    assert val_t[0] == pytest.approx(val_j[0], rel=1e-4)
    assert set(tt.train_losses[0][0]) == {"mse", "gate"}
    steps = tt.model_handler.total_steps
    assert steps == jt.model_handler.total_steps > 0
    ref = convert.flax_to_state_dict(_to_np(jt.model_handler.params))
    got = tt.model_handler.model.state_dict()
    for key, value in ref.items():
        assert (got[key] - value).abs().max().item() <= \
            2 * LR * steps + 1e-6, key
