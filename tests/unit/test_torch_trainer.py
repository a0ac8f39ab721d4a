"""The training slice as a whole on the CPU: the port's model handler
against the JAX handler for three optimiser steps on converted weights
(Adam, global-norm clipping and a scheduler), AcousticModelTrainer on the
fixture corpus, checkpoints, dropout, and the card-by-default entry
points.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.dataset import collate_batch
from idiaptts_tpu.hparams import ExtendedHParams as JaxHParams
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models.losses import NamedLoss as JaxLoss
from idiaptts_tpu.train.handler import ModularModelHandler as JaxHandler
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.ops import dispatch
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.handler import ModularModelHandler

MODEL = "RNNDYN-1_RELU_64-1_BiLSTM_128-1_FC_67"
LR = 1e-3
CLIP = 0.05     # below the fixture batches' gradient norms (0.1-0.2)


def _corpus_batches(fixtures_dir, id_list, num_questions):
    """Three batches of two fixture utterances, read by the port's
    readers (identical to the JAX ones, test_torch_training_data)."""
    trainer = AcousticModelTrainer(
        _hparams(num_questions), {"train": list(id_list)},
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    readers = trainer.default_data_reader_configs(trainer.hparams)
    trainer.data_reader_configs = readers
    trainer._setup_datareaders(trainer.hparams)
    trainer._setup_datasets(trainer.hparams)
    ds = trainer.dataset_train
    pairs = [("gen-0001", "gen-0003"), ("gen-0004", "gen-0001"),
             ("gen-0003", "gen-0004")]
    return [collate_batch([ds.get_id_name(i)[0] for i in p]) for p in pairs]


def _hparams(num_questions, cls=ExtendedHParams, **over):
    hp = cls.create_hparams()
    hp.add_hparams(num_questions=num_questions)
    hp.setattr_no_type_check("add_deltas", True)
    hp.num_coded_sps = 20
    hp.learning_rate = LR
    hp.grad_clip_norm_type = 2
    hp.grad_clip_max_norm = CLIP
    hp.scheduler_type = "ExtendedExponential"
    hp.scheduler_args = {"gamma": 0.5, "warmup_steps": 1, "decay_steps": 1}
    hp.seed = 1
    if cls is ExtendedHParams:
        hp.device = "cpu"
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


def _loss_cfg(cls):
    return [cls.Config("mse", "MSELoss",
                       ("pred_acoustic_features", "acoustic_features"),
                       seq_mask="_seq_mask", reduction="mean_per_frame")]


def _model_cfg(mod, num_questions):
    cfg = mod.convert_legacy_string(MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    return cfg


def test_handler_steps_match_jax_handler(fixtures_dir, id_list,
                                         num_questions):
    """Three Adam steps with global-norm clipping (the clip is active:
    norms above CLIP) and an ExtendedExponential schedule, from the same
    weights and batches.  Both sides run bf16 Dense layers and bf16
    LSTM matmuls; JAX on the CPU accumulates its bf16 einsums in bf16
    (ROADMAP fault 3.2), so losses and norms agree at bf16 scale (1e-2
    relative).  Adam's first updates are +-lr wherever the gradient's
    sign agrees, so the parameters agree to 2 lr per step where a
    near-zero gradient's sign differs; later updates move with the
    ratio of the steps' gradients, so 99% of entries agree to 0.1 lr
    (measured: 99th percentile 0.054 lr, on the recurrent weights)."""
    batches = _corpus_batches(fixtures_dir, id_list, num_questions)
    jh = JaxHandler()
    jh.create_model(_model_cfg(jax_rnn, num_questions),
                    example_batch=batches[0])
    hp_j = _hparams(num_questions, JaxHParams)
    jh.set_optimiser(hp_j)
    jh.set_scheduler(hp_j)
    jh.set_losses(_loss_cfg(JaxLoss))

    th = ModularModelHandler(device="cpu")
    th.create_model(_model_cfg(torch_rnn, num_questions))
    convert.load_flax_params(th.model,
                             jax.tree_util.tree_map(np.asarray, jh.params))
    hp_t = _hparams(num_questions)
    th.set_optimiser(hp_t)
    th.set_scheduler(hp_t)
    th.set_losses(_loss_cfg(NamedLoss))

    step_fn = jh._make_train_step()
    for batch in batches:
        data, lengths = jh._batch_to_model_input(batch)
        jh._rng, rng = jax.random.split(jh._rng)
        lr_j = jh._current_lr()
        (jh.params, jh.opt_state, total_j, _, norm_j, _) = step_fn(
            jh.params, None, jh.opt_state, data, lengths, rng,
            jnp.asarray(jh.total_steps), jnp.asarray(lr_j, jnp.float32))
        jh.total_steps += 1
        total_t, per_t = th.process_batches([batch])
        assert th.optimiser.param_groups[0]["lr"] == lr_j
        np.testing.assert_allclose(total_t, float(total_j), rtol=1e-2)
        np.testing.assert_allclose(th.last_grad_norm, float(norm_j),
                                   rtol=1e-2)
        assert th.last_grad_norm > CLIP
        assert per_t["mse"] == pytest.approx(total_t)
    ref = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jh.params))
    got = th.model.state_dict()
    assert th.total_steps == 3
    for name, value in ref.items():
        diff = (got[name] - value).abs()
        assert diff.max().item() <= 2 * LR * 3 + 1e-6, name
        assert (diff > 0.1 * LR).float().mean().item() < 0.01, name


def test_state_dict_round_trips_to_the_flax_tree(num_questions):
    cfg = _model_cfg(torch_rnn, num_questions)
    model = cfg.create_model(torch.Generator().manual_seed(3))
    tree = convert.state_dict_to_flax(model.state_dict())
    assert set(tree["params"]) == {"wrapped"}
    assert "inner" in tree["params"]["wrapped"]
    again = convert.flax_to_state_dict(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v)


@pytest.fixture
def trained(fixtures_dir, id_list, num_questions, tmp_path):
    hp = _hparams(num_questions, scheduler_type="default",
                  grad_clip_norm_type=None)
    hp.out_dir = str(tmp_path)
    hp.model_name = "acoustic"
    hp.epochs = 2
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    trainer = AcousticModelTrainer(
        hp, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    trainer.init(hp, model_config=_model_cfg(torch_rnn, num_questions))
    val_loss, train_loss = trainer.train(hp)
    return trainer, hp, val_loss, train_loss


def test_acoustic_trainer_trains_on_the_fixtures(trained):
    """Two epochs at lr 1e-3 on four training utterances (25%
    validation): the training loss decreases, each epoch is validated
    and checkpointed, and the best and last checkpoints exist."""
    trainer, hp, val_loss, train_loss = trained
    assert len(trainer.id_list_val) == 1 and len(trainer.id_list_train) == 5
    assert len(train_loss) == 2 and len(val_loss) == 3
    assert np.all(np.isfinite(train_loss)) and np.all(np.isfinite(val_loss))
    assert train_loss[-1] < train_loss[0]
    nn_dir = os.path.join(hp.out_dir, hp.model_name, "nn")
    for name in ("config.json", "params_best", "params_last", "params_e1",
                 "params_e2", "optimiser_last", "scheduler_last"):
        assert os.path.isfile(os.path.join(nn_dir, name)), name
    train, val = trainer.get_losses()
    assert list(train["mse"]) == pytest.approx(train_loss)


def test_checkpoint_round_trips(trained):
    """A fresh handler rebuilds the model from config.json and loads the
    same parameters, optimiser state and step count."""
    trainer, hp, _, _ = trained
    trainer.save_checkpoint(hp, epoch=7)
    fresh = ModularModelHandler(device="cpu")
    best_loss, epoch, steps = fresh.load_checkpoint(
        hp.out_dir, hp.model_name, epoch=7)
    assert epoch == 7 and steps == trainer.model_handler.total_steps
    assert best_loss == pytest.approx(trainer.best_loss)
    ours = trainer.model_handler.model.state_dict()
    theirs = fresh.model.state_dict()
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    # With an optimiser, its moments come back too.
    fresh.set_optimiser(hp)
    fresh.load_checkpoint(hp.out_dir, hp.model_name, epoch=7)
    saved = trainer.model_handler.optimiser.state_dict()["state"]
    loaded = fresh.optimiser.state_dict()["state"]
    for k in saved:
        assert torch.equal(saved[k]["exp_avg"], loaded[k]["exp_avg"])


def test_checkpoint_layer_map_and_ignore_layers(trained):
    trainer, hp, _, _ = trained
    handler = trainer.model_handler
    before = {k: v.clone() for k, v in handler.model.state_dict().items()}
    with torch.no_grad():
        for p in handler.model.parameters():
            p.add_(1.0)
    handler.load_checkpoint(hp.out_dir, hp.model_name, last=True,
                            ignore_layers=["g0_Linear"])
    after = handler.model.state_dict()
    for k in after:
        if "g0_Linear" in k:
            assert torch.equal(after[k], before[k] + 1.0), k
        else:
            assert torch.equal(after[k], before[k]), k
    # layer_map renames checkpoint paths before loading: swap the two
    # directions of the BiLSTM layer.
    handler.load_checkpoint(hp.out_dir, hp.model_name, last=True,
                            layer_map=[("g1_LSTM/bi0/b", "g1_LSTM/bi0/b")])
    assert torch.equal(handler.model.state_dict()["wrapped.g1_LSTM.bi0.b"],
                       before["wrapped.g1_LSTM.bi0.b"])


def test_frozen_layers_do_not_move(fixtures_dir, id_list, num_questions):
    batches = _corpus_batches(fixtures_dir, id_list, num_questions)[:1]
    th = ModularModelHandler(device="cpu")
    th.create_model(_model_cfg(torch_rnn, num_questions))
    hp = _hparams(num_questions, frozen_layers=["g1_LSTM"])
    th.set_optimiser(hp)
    th.set_scheduler(hp)
    th.set_losses(_loss_cfg(NamedLoss))
    before = {k: v.clone() for k, v in th.model.state_dict().items()}
    th.process_batches(batches)
    for k, v in th.model.state_dict().items():
        assert torch.equal(v, before[k]) == ("g1_LSTM" in k), k


def test_dropout_draws_from_the_generator():
    x = torch.ones(4, 8, 16)
    cfg = torch_rnn.convert_legacy_string("RNNDYN-2_RELU_16-1_FC_3", 16,
                                          dropout=0.5)
    model = cfg.create_model()
    g = torch.Generator().manual_seed(5)
    a = model(x, training=True, generator=g)
    b = model(x, training=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, model(x, training=True, generator=g))
    assert torch.equal(model(x), model(x, training=False))
    with pytest.raises(ValueError, match="Generator"):
        model(x, training=True)


def test_entry_points_default_to_the_card():
    """Without CUDA the entry points raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from idiaptts_torch.ops.mlpg import mlpg_factorise
    from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
    var = {"sp": np.ones(60), "lf0": np.ones(3), "bap": np.ones(3)}
    for build in (lambda: ModularModelHandler(),
                  lambda: AcousticModelTrainer(
                      AcousticModelTrainer.create_hparams(), ["a"]),
                  lambda: FusedAcousticPipeline(None, var, 20),
                  lambda: mlpg_factorise(np.ones(66), 22, 8),
                  lambda: dispatch.resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
