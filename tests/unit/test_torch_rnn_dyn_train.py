"""The rest of rnn_dyn in training and serving, on the CPU: the ICASSP'19
BiGRU preset and the speaker-embedding BiLSTM preset at small widths
(forward and one handler step against the JAX handler), a model with a
second input served through ``build_serving`` against the JAX trainer,
a VAE trained with ``VAEKLDLoss`` from the forward's intermediates, the
BiLSTM residual precision's loss trajectory, figures, TensorBoard and
the profiler hook."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.category import \
    CategoryDataReader as JaxCategoryDataReader
from idiaptts_tpu.hparams import ExtendedHParams as JaxHParams
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models.losses import NamedLoss as JaxLoss
from idiaptts_tpu.train.acoustic import \
    AcousticModelTrainer as JaxAcousticModelTrainer
from idiaptts_tpu.train.handler import ModularModelHandler as JaxHandler
from idiaptts_tpu.train.trainer import ModularTrainer as JaxModularTrainer
from idiaptts_torch.data.category import CategoryDataReader
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.handler import ModularModelHandler
from idiaptts_torch.train.trainer import ModularTrainer

LR = 1e-3
ICASSP19 = "RNNDYN-2_RELU_32-3_BiGRU_16-1_FC_67"
EMB = "RNNDYN-5x8_EMB_(-1)-2_RELU_32-1_BiLSTM_16-1_FC_67"
SPEAKER = {"gen-0001": 0.0, "gen-0002": 2.0, "gen-0003": 1.0}
IDS = tuple(SPEAKER)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(B=3, T=40, D=20, seed=0, speaker=False):
    """A seeded collated batch: questions, targets, lengths, mask."""
    rs = np.random.RandomState(seed)
    lengths = np.array([T, T - 9, T - 23][:B], np.int64)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    batch = {"questions": rs.randn(B, T, D).astype(np.float32),
             "acoustic_features": rs.randn(B, T, 67).astype(np.float32)
             * mask[..., None],
             "_seq_mask": mask[..., None],
             "_lengths": {"questions": lengths}}
    if speaker:
        batch["speaker"] = rs.randint(0, 5, (B, 1, 1)).astype(np.float32)
    return batch


def _cfg(mod, model_string, in_dim, speaker):
    cfg = mod.convert_legacy_string(model_string, in_dim + speaker)
    cfg.input_names = ("questions", "speaker") if speaker \
        else ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    return cfg


def _hp(cls):
    hp = cls.create_hparams()
    hp.learning_rate = LR
    if cls is ExtendedHParams:
        hp.device = "cpu"
    return hp


def _mse(cls):
    return [cls.Config("mse", "MSELoss",
                       ("pred_acoustic_features", "acoustic_features"),
                       seq_mask="_seq_mask", reduction="mean_per_frame")]


@pytest.mark.parametrize("model_string, speaker", [(ICASSP19, False),
                                                   (EMB, True)])
def test_preset_forward_and_handler_step_match_jax(model_string, speaker):
    """The ICASSP'19 BiGRU preset and the EMB preset (a speaker index as
    the second input) at small widths: the forward, then one Adam step of
    each handler from the JAX handler's initial weights.  The forward
    repeats XLA's roundings (GRU; measured 0 relative) or agrees at bf16
    scale (BiLSTM on the CPU, ROADMAP fault 3.2), so the loss agrees to
    1e-3 relative (measured up to 3e-5) and the gradient norm to 1e-2.
    Adam's first update is +-lr wherever the gradients' signs agree:
    every entry within 2 lr, and at most 3% further apart than 0.1 lr
    (near-zero gradients whose sign differs; measured 1.2%, a GRU's
    recurrent kernel)."""
    batch = _batch(speaker=speaker)
    jh = JaxHandler()
    jh.create_model(_cfg(jax_rnn, model_string, 20, speaker))
    # The JAX handler's initial draw, as flax_init repeats it (held to
    # JAX's in test_torch_rnn_dyn_layers), spares an eager flax init.
    jh.params = jax.tree_util.tree_map(jnp.asarray, flax_init.rnn_dyn_params(
        _cfg(torch_rnn, model_string, 20, speaker))["params"])
    hp_j = _hp(JaxHParams)
    jh.set_optimiser(hp_j)
    jh.set_scheduler(hp_j)
    jh.set_losses(_mse(JaxLoss))
    th = ModularModelHandler(device="cpu")
    th.create_model(_cfg(torch_rnn, model_string, 20, speaker))
    convert.load_flax_params(th.model,
                             jax.tree_util.tree_map(np.asarray, jh.params))
    hp_t = _hp(ExtendedHParams)
    th.set_optimiser(hp_t)
    th.set_scheduler(hp_t)
    th.set_losses(_mse(NamedLoss))

    data, lengths = jh._batch_to_model_input(batch)
    ref = jax.jit(jh.model.apply)({"params": jh.params}, data, lengths)
    got = th.inference(batch)
    top = np.abs(ref["pred_acoustic_features"]).max()
    np.testing.assert_allclose(got["pred_acoustic_features"],
                               np.asarray(ref["pred_acoustic_features"]),
                               rtol=0, atol=2.0 ** -7 * top)

    params_j, _, total_j, _, norm_j, _ = jh._make_train_step()(
        jh.params, None, jh.opt_state, data, lengths,
        jax.random.PRNGKey(0), jnp.asarray(0), jnp.asarray(LR, jnp.float32))
    total_t, _ = th.process_batches([batch])
    np.testing.assert_allclose(total_t, float(total_j), rtol=1e-3)
    np.testing.assert_allclose(th.last_grad_norm, float(norm_j), rtol=1e-2)
    ref = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params_j))
    state = th.model.state_dict()
    for name, value in ref.items():
        diff = (state[name] - value).abs()
        assert diff.max().item() <= 2 * LR + 1e-6, name
        assert (diff > 0.1 * LR).float().mean().item() <= 0.03, name


def test_vae_trains_with_the_kld_loss_from_intermediates():
    """A VAE group's mu and logvar reach the loss dict (``vae_mu`` /
    ``vae_logvar``, as the JAX handler's bare-leaf alias gives them):
    ``VAEKLDLoss`` is non-zero, differentiates into the VAE's Dense
    layers, and the summed loss falls over a few steps.  BatchNorm's
    running averages move in training and are saved with the
    checkpoint."""
    cfg = torch_rnn.convert_legacy_string(
        "RNNDYN-1_RELU_32-1_VAE_8-1_BatchNorm1dRELU_16-1_FC_67", 20)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    th = ModularModelHandler(device="cpu")
    th.create_model(cfg)
    th.set_optimiser(_hp(ExtendedHParams))
    th.set_scheduler(_hp(ExtendedHParams))
    th.set_losses(_mse(NamedLoss) + [NamedLoss.Config(
        "kld", "VAEKLDLoss", ("vae_mu",), reduction="mean")])
    batch = _batch()
    data, lengths = th._batch_to_model_input(batch)
    out = th._apply_model(data, lengths, training=True)
    assert out["vae_mu"].shape == (3, 40, 8)
    assert "g1_VanillaVAE/vae_logvar" in out
    bn = th.model.wrapped.g3_BatchNorm1d
    mean_before = bn.mean.clone()
    losses = [th.process_batches([batch])[1] for _ in range(12)]
    assert losses[0]["kld"] > 0.0
    assert losses[-1]["mse"] + losses[-1]["kld"] \
        < losses[0]["mse"] + losses[0]["kld"]
    assert not torch.equal(bn.mean, mean_before)
    assert "wrapped.g3_BatchNorm1d.var" in th.model.state_dict()
    assert "vae_mu" not in th.inference(batch)


@pytest.fixture(scope="module")
def speaker_pair(fixtures_dir, num_questions, tmp_path_factory):
    """The JAX trainer and the port's with the EMB model and a speaker
    index from a CategoryDataReader as the second input, the same
    weights; the port's trainer trains one epoch with TensorBoard and
    the profiler on (``out_dir``, ``model_name`` and ``profiler_dir``
    set)."""
    tmp = tmp_path_factory.mktemp("speaker_pair")
    trainers = {}
    for name, cls, rnn, reader in (
            ("jax", JaxAcousticModelTrainer, jax_rnn, JaxCategoryDataReader),
            ("port", AcousticModelTrainer, torch_rnn, CategoryDataReader)):
        hp = cls.create_hparams()
        hp.num_questions = num_questions
        hp.num_coded_sps = 20
        hp.out_dir = str(tmp / name)
        hp.model_name = "spk"
        hp.batch_size_train = 3
        hp.batch_size_val = 3
        hp.seed = 1
        hp.synth_fs = 16000
        if name == "port":
            hp.device = "cpu"
            hp.profiler_dir = str(tmp / "profile")
        trainer = cls(hp, {"train": list(IDS)},
                      dir_question_labels=os.path.join(fixtures_dir,
                                                       "questions"),
                      dir_world_features=os.path.join(fixtures_dir, "WORLD"))
        configs = trainer.default_data_reader_configs(hp) + [
            reader.Config(name="speaker",
                          get_category_fn=lambda i: [SPEAKER[i]])]
        trainer.init(hp, model_config=_cfg(rnn, EMB, num_questions, True),
                     data_reader_configs=configs)
        trainers[name] = (trainer, hp)
    convert.load_flax_params(
        trainers["port"][0].model_handler.model,
        jax.tree_util.tree_map(np.asarray,
                               trainers["jax"][0].model_handler.params))
    return trainers, tmp


def _jax_draw(seed, T, nb=129):
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(
        jax.random.normal(kr, (T, nb)) + 1j * jax.random.normal(ki,
                                                                 (T, nb))))


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def test_multi_input_serving_matches_jax(speaker_pair):
    """``build_serving`` of a model with a second input: the speaker
    index rides as a trailing column of the question matrix (one row
    broadcast over the frames), the pipeline splits it back by the probed
    widths, and the waveform agrees with the JAX trainer's fused
    pipeline (the port fed the JAX noise draw) by 5 ms frame energy over
    the frames within 60 dB of the loudest: bound 0.05 dB (the models
    agree at bf16 scale; measured 0.004 dB)."""
    (jt, hp_j), (pt, hp) = speaker_pair[0]["jax"], speaker_pair[0]["port"]
    pipe_j, params_j, load_j = jt.build_serving(hp_j)
    pipe_t, params_t, load_t = pt.build_serving(hp)
    assert pt.build_serving(hp)[0] is pipe_t           # cached
    ids = list(IDS)
    inputs = [load_t(i) for i in ids]
    for i, q in zip(ids, inputs):
        np.testing.assert_array_equal(q, load_j(i))
        assert q.shape[1] == 142 and np.all(q[:, -1] == SPEAKER[i])
    lengths = np.array([len(q) for q in inputs], np.int32)
    T = int(np.ceil(lengths.max() / pipe_t.bucket) * pipe_t.bucket)
    batch = np.zeros((len(ids), T, inputs[0].shape[1]), np.float32)
    for k, q in enumerate(inputs):
        batch[k, :len(q)] = q
    model_j, mlpg_j, vocoder_j = pipe_j.stage_jits()
    out_j = model_j(params_j, jnp.asarray(batch), jnp.asarray(lengths))
    smoothed, vuv = mlpg_j(out_j, jnp.asarray(lengths),
                           *pipe_j._factors_for(T))
    wavs_j = np.asarray(vocoder_j(smoothed, vuv,
                                  jnp.full(batch.shape[:2], 150.0),
                                  jax.random.PRNGKey(0)))
    b, n, f0 = pipe_t.prepare(batch, lengths)
    with torch.inference_mode():
        out = pipe_t.model_stage(params_t, b, n)
        wavs_t = pipe_t.vocoder_stage(
            *pipe_t.mlpg_stage(out, n, *pipe_t.factors_for(T)), f0,
            z=_jax_draw(0, T)).numpy()
    for k, length in enumerate(lengths):
        db_j = _frame_db(wavs_j[k, :length * 80])
        db_t = _frame_db(wavs_t[k, :length * 80])
        loud = db_j > db_j.max() - 60.0
        assert np.abs(db_t[loud] - db_j[loud]).max() < 0.05


def test_tensorboard_and_profiler_front_doors(speaker_pair):
    """One epoch of the EMB trainer with ``profiler_dir`` set writes a
    torch.profiler Chrome trace there, and the tensorboardX writer an
    event file under ``<out_dir>/<model_name>/tensorboard``."""
    trainers, tmp = speaker_pair
    trainer, hp = trainers["port"]
    hp.epochs = 1
    _, train_loss = trainer.train(hp)
    assert len(train_loss) == 1 and np.isfinite(train_loss[0])
    assert glob.glob(str(tmp / "profile" / "*.json"))
    assert glob.glob(os.path.join(hp.out_dir, "spk", "tensorboard",
                                  "events.out.tfevents.*"))
    assert trainer.summary_writer is not None


def test_gen_figure_matches_the_jax_figure(tmp_path):
    """The default figure of one sample from both packages: a non-empty
    file at the same path (as tests/unit/test_default_figure.py)."""
    rng = np.random.RandomState(0)
    sample = {"pred_acoustic_features": rng.randn(50, 30).astype(np.float32),
              "lf0": rng.randn(50).astype(np.float32),
              "vuv": (rng.rand(50) > 0.5).astype(np.float32),
              "pair": rng.randn(50, 2).astype(np.float32),
              "_id_list": "utt1"}
    paths = {}
    for name, cls, hp_cls in (("jax", JaxModularTrainer, JaxHParams),
                              ("port", ModularTrainer, ExtendedHParams)):
        hp = hp_cls.create_hparams()
        hp.out_dir = str(tmp_path / name)
        hp.model_name = "m"
        trainer = object.__new__(cls)
        paths[name] = cls.gen_figure_from_output(trainer, "utt1", sample, hp)
    assert os.path.basename(paths["port"]) == os.path.basename(paths["jax"])
    for path in paths.values():
        assert os.path.getsize(path) > 1000


def test_residual_precision_trajectory(fixtures_dir, id_list, num_questions,
                                       tmp_path):
    """The pin recipe's model (``RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67``)
    on the fixtures for 12 epochs from the JAX draw, float32 against bf16
    BiLSTM training residuals through the plain versions: the final
    train and validation losses agree within 1% (measured 7.2e-5 and
    6.9e-5 relative), which is why bf16 residuals above 32 batch rows,
    the JAX handler's rule, are the port's default (ROADMAP fault 3.4)."""
    finals = {}
    for bf16 in (False, True):
        hp = AcousticModelTrainer.create_hparams()
        hp.out_dir = str(tmp_path / str(bf16))
        hp.model_name = "traj"
        hp.epochs = 12
        hp.batch_size_train = 2
        hp.batch_size_val = 6
        hp.learning_rate = 0.002
        hp.seed = 1
        hp.test_set_perc = 0.0
        hp.val_set_perc = 0.25
        hp.num_questions = num_questions
        hp.num_coded_sps = 20
        hp.device = "cpu"
        hp.bf16_residuals = bf16
        trainer = AcousticModelTrainer(
            hp, list(id_list),
            dir_question_labels=os.path.join(fixtures_dir, "questions"),
            dir_world_features=os.path.join(fixtures_dir, "WORLD"))
        cfg = torch_rnn.convert_legacy_string(
            "RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67", num_questions)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hp, model_config=cfg)
        assert trainer.model_handler.residuals_bf16 is bf16
        convert.load_flax_params(trainer.model_handler.model,
                                 flax_init.rnn_dyn_params(cfg))
        val, train = trainer.train(hp)
        assert train[-1] < train[0]
        finals[bf16] = (train[-1], val[-1])
    for f32, bf16 in zip(finals[False], finals[True]):
        assert abs(bf16 - f32) <= 0.01 * f32


def test_residual_default_follows_the_jax_rule():
    """Without a flag the handler picks bf16 residuals above 32 rows, as
    the JAX handler does; True or False overrides."""
    handler = ModularModelHandler(device="cpu")
    assert handler.residuals_bf16 is None
    assert [handler.residuals_bf16_for(b) for b in (8, 32, 33, 64)] == [
        False, False, True, True]
    handler.residuals_bf16 = False
    assert not handler.residuals_bf16_for(64)
    handler.residuals_bf16 = True
    assert handler.residuals_bf16_for(8)
