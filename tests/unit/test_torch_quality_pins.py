"""The repo's quality pins held on the port, on the CPU: the seeded
12-epoch acoustic recipe (``RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67``) and
the 12-epoch duration recipe of tests/integration/test_quality_pins.py
(:76-107, :118-162), run by the port's trainers.

Both start from the JAX recipe's initial weights, converted, with the
same split and batch order, so the two trajectories are comparable
(independent initialisations would make any bound luck).  The duration
recipe's phone-level questions come from the port's own ``gen_data``.

The scores are bounded one-sided against the pins, as ``assert_pinned``
does off the recording platform: no worse than the pin by more than 1%
relative (the file's RTOL).  Measured: MCD 4.0951, F0-RMSE 9.5238, VDE
0.02853 and BAP 12.6999 against the pins 4.097, 9.534, 0.0294 and
12.704; Dur RMSE 2.174 against 3.249 (the port's best-model pick lands
on epoch 12 where JAX's lands on epoch 4: their validation losses
differ in the fourth digit).  The whole file takes about 30 s.

On the card, where JAX is absent, ``chip_smoke.py`` starts the same
recipes from ``models/flax_init.py``'s numpy repeat of the JAX draw;
the last tests here hold that draw to JAX's.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.train.acoustic import \
    AcousticModelTrainer as JaxAcousticModelTrainer
from idiaptts_tpu.train.duration import \
    DurationModelTrainer as JaxDurationModelTrainer
from idiaptts_torch.data.normalisation import MinMaxExtractor
from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.duration import DurationModelTrainer

RTOL = 0.01
PIN_MODEL = "RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    about twice as fast as eight, and far faster when the suite's
    parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pins():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "integration", "test_quality_pins.py")
    spec = importlib.util.spec_from_file_location("_quality_pins", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.PINNED_ACOUSTIC, module.PINNED_DURATION_RMSE


PINNED_ACOUSTIC, PINNED_DURATION_RMSE = _pins()


def assert_one_sided(key, got, pinned):
    assert np.isfinite(got), (key, got)
    assert got <= pinned + max(abs(pinned) * RTOL, 1e-3), (key, got, pinned)


def _common(hp, out_dir, model_name):
    hp.out_dir = str(out_dir)
    hp.model_name = model_name
    hp.epochs = 12
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.use_best_as_final_model = True
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    return hp


def _from_jax_init(port_trainer, jax_trainer):
    convert.load_flax_params(
        port_trainer.model_handler.model,
        jax.tree_util.tree_map(np.asarray, jax_trainer.model_handler.params))


@pytest.fixture(scope="module")
def acoustic_scores(fixtures_dir, id_list, num_questions, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pin_acoustic")
    dirs = dict(dir_question_labels=os.path.join(fixtures_dir, "questions"),
                dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    trainers = {}
    for name, cls, rnn in (("jax", JaxAcousticModelTrainer, jax_rnn),
                           ("port", AcousticModelTrainer, torch_rnn)):
        hp = _common(cls.create_hparams(), tmp / name, "pin_acoustic")
        hp.num_questions = num_questions
        hp.num_coded_sps = 20
        hp.batch_size_benchmark = 6
        hp.synth_fs = 16000
        if name == "port":
            hp.device = "cpu"
        trainer = cls(hp, list(id_list), **dirs)
        cfg = rnn.convert_legacy_string(PIN_MODEL, num_questions)
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hp, model_config=cfg)
        trainers[name] = (trainer, hp)
    trainer, hp = trainers["port"]
    _from_jax_init(trainer, trainers["jax"][0])
    assert trainer.id_list_train == trainers["jax"][0].id_list_train
    trainer.train(hp)
    mcd, f0_rmse, vde, bap = trainer.benchmark(hp, trainer.id_list_train)
    return {"mcd": float(mcd), "f0_rmse": float(f0_rmse),
            "vde": float(vde), "bap": float(bap)}


@pytest.mark.parametrize("key", sorted(PINNED_ACOUSTIC))
def test_acoustic_benchmark_pinned(acoustic_scores, key):
    print("port acoustic metrics:", acoustic_scores)
    assert_one_sided(key, acoustic_scores[key], PINNED_ACOUSTIC[key])


def _phone_level_questions(fixtures_dir, id_list, question_file, out_dir):
    """The pin recipe's duration inputs from the port's gen_data: each
    phone's first frame of questions, with min-max statistics."""
    label_dict, _, _ = QuestionLabelGen.gen_data(
        os.path.join(fixtures_dir, "labels", "label_state_align"),
        question_file, dir_out=None, id_list=id_list, return_dict=True)
    os.makedirs(out_dir, exist_ok=True)
    extractor = MinMaxExtractor()
    for id_name, frames in label_dict.items():
        dur = PhonemeDurationLabelGen.load_sample(
            id_name, os.path.join(fixtures_dir, "dur"))
        phone_frames = dur.sum(axis=1).astype(np.int64)
        first = np.minimum(np.cumsum(phone_frames) - phone_frames,
                           len(frames) - 1)
        extractor.add_sample(frames[first])
        frames[first].astype(np.float32).tofile(
            os.path.join(out_dir, id_name + ".questions"))
    extractor.save(os.path.join(out_dir, "all"))
    return out_dir


def test_duration_benchmark_pinned(fixtures_dir, id_list, question_file,
                                   num_questions, tmp_path):
    dirs = dict(dir_phoneme_labels=_phone_level_questions(
                    fixtures_dir, id_list, question_file,
                    str(tmp_path / "questions")),
                dir_durations=os.path.join(fixtures_dir, "dur"))
    trainers = {}
    for name, cls in (("jax", JaxDurationModelTrainer),
                      ("port", DurationModelTrainer)):
        hp = _common(cls.create_hparams(), tmp_path / name, "pin_dur")
        hp.num_questions = num_questions
        if name == "port":
            hp.device = "cpu"
        trainer = cls(hp, list(id_list), **dirs)
        trainer.init(hp)
        trainers[name] = (trainer, hp)
    trainer, hp = trainers["port"]
    _from_jax_init(trainer, trainers["jax"][0])
    trainer.train(hp)
    rmse, pearson = trainer.benchmark(hp, trainer.id_list_train)
    print("port duration rmse:", float(rmse))
    assert pearson.shape == (5,)
    assert_one_sided("dur_rmse", float(rmse), PINNED_DURATION_RMSE)


def _jax_initial_params(model_string, num_questions):
    from idiaptts_tpu.train.handler import ModularModelHandler
    cfg = jax_rnn.convert_legacy_string(model_string, num_questions)
    cfg.input_names, cfg.output_names = ("questions",), ("pred",)
    handler = ModularModelHandler()
    handler.create_model(cfg, example_batch={
        "questions": np.zeros((1, 16, num_questions), np.float32),
        "_lengths": {"questions": np.array([16])},
        "_seq_mask": np.ones((1, 16, 1), np.float32)})
    return convert.flatten_flax(jax.tree_util.tree_map(np.asarray,
                                                       handler.params))


@pytest.mark.parametrize("model_string", [
    PIN_MODEL, "RNNDYN-3_RELU_512-1_FC_5", "RNNDYN-1_RELU_64-1_FC_67"])
def test_flax_init_repeats_the_jax_draw(num_questions, model_string):
    """models/flax_init.py draws the JAX handler's initial weights: the
    same tree, every leaf within 2e-6 (measured 9.7e-7, the QR of the
    orthogonal Wh; the Dense kernels within 9e-8: erfinv and QR in
    float64 rather than XLA's float32)."""
    ref = _jax_initial_params(model_string, num_questions)
    got = convert.flatten_flax(flax_init.rnn_dyn_params(
        torch_rnn.convert_legacy_string(model_string,
                                        num_questions))["params"])
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert got[path].dtype == np.float32 and got[path].shape == leaf.shape
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=2e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("seed, shape", [(0, (7,)), (1234, (3, 5)),
                                         (2 ** 32 - 1, (2, 2, 9))])
def test_flax_init_prng_matches_jax(seed, shape):
    """PRNGKey, fold_in and the uniform bits bit for bit; the normal and
    truncated normal draws within 2e-6 (erfinv in float64)."""
    key = jax.random.PRNGKey(seed)
    ours = flax_init.prng_key(seed)
    np.testing.assert_array_equal(ours, np.asarray(key))
    np.testing.assert_array_equal(flax_init.fold_in(ours, 77),
                                  np.asarray(jax.random.fold_in(key, 77)))
    np.testing.assert_array_equal(flax_init.random_bits(ours, shape),
                                  np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_array_equal(flax_init.uniform(ours, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_allclose(flax_init.normal(ours, shape),
                               np.asarray(jax.random.normal(key, shape)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        flax_init.truncated_normal(ours, -2.0, 2.0, shape),
        np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, shape)),
        rtol=0, atol=2e-6)


def test_pins_hold_from_the_numpy_draw(fixtures_dir, id_list,
                                       num_questions, tmp_path):
    """The acoustic pin recipe started from flax_init's draw (the card's
    way): the same one-sided bounds (measured MCD 4.0955, F0-RMSE 9.5174,
    VDE 0.02853, BAP 12.7001)."""
    hp = _common(AcousticModelTrainer.create_hparams(), tmp_path,
                 "pin_acoustic")
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.batch_size_benchmark = 6
    hp.synth_fs = 16000
    hp.device = "cpu"
    trainer = AcousticModelTrainer(
        hp, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    cfg = torch_rnn.convert_legacy_string(PIN_MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg)
    convert.load_flax_params(trainer.model_handler.model,
                             flax_init.rnn_dyn_params(cfg))
    trainer.train(hp)
    scores = trainer.benchmark(hp, trainer.id_list_train)
    for key, got in zip(("mcd", "f0_rmse", "vde", "bap"), scores):
        assert_one_sided(key, float(got), PINNED_ACOUSTIC[key])
