"""The repo's intonation and VTLN quality pins held on the port, on the
CPU: the atom recipe (``RNNDYN-1_RELU_64-1_FC_5``, 10 epochs), the
three-phase atom -> flat -> phrase neural-filter recipe (3 epochs a
phase) and the VTLN recipe (``RNNDYN-1_RELU_64-1_FC_67`` under the
all-pass warp layer, 8 epochs) of tests/integration/test_quality_pins.py
(:165-320), run by the port's trainers with the recipes' hparams.

Each starts from the JAX package's initial draw, repeated in numpy by
``models/flax_init.py`` (as ``chip_smoke.py`` starts it on the card;
the draw is held to JAX's in test_torch_intonation.py and
test_torch_vtln.py), with the same split and batch order.  The scores
are bounded one-sided against the pins, no worse by more than 1%
relative (the pin file's RTOL), as ``assert_pinned`` does off the
recording platform.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from idiaptts_torch.data.category import CategoryDataReader
from idiaptts_torch.models import convert, flax_init
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.train.atom_trainers import (
    AtomModelTrainer, AtomNeuralFilterModelTrainer,
    AtomVUVDistPosModelTrainer, PhraseAtomNeuralFilterModelTrainer)
from idiaptts_torch.train.vtln_trainer import VTLNSpeakerAdaptionModelTrainer

RTOL = 0.01
THETAS = [0.03, 0.06, 0.09, 0.12, 0.15]
WCAD = "wcad-0.030_0.060_0.090_0.120_0.150"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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
    return (module.PINNED_ATOM, module.PINNED_FLAT, module.PINNED_PHRASE,
            module.PINNED_VTLN)


PINNED_ATOM, PINNED_FLAT, PINNED_PHRASE, PINNED_VTLN = _pins()


def assert_one_sided(key, got, pinned):
    assert np.isfinite(got), (key, got)
    assert got <= pinned + max(abs(pinned) * RTOL, 1e-3), (key, got, pinned)


def _from_jax_draw(trainer):
    """The trainer's model starts from the JAX package's initial draw."""
    handler = trainer.model_handler
    convert.load_flax_params(handler.model,
                             flax_init.model_params(handler.model_config))


def _dirs(fixtures_dir):
    return dict(dir_question_labels=os.path.join(fixtures_dir, "questions"),
                dir_atom_labels=os.path.join(fixtures_dir, WCAD),
                dir_world_features=os.path.join(fixtures_dir, "WORLD"))


def _atom_config(string, num_questions):
    cfg = convert_legacy_string(string, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_atoms",)
    return cfg


def test_atom_benchmark_pinned(fixtures_dir, id_list, num_questions,
                               tmp_path):
    hp = AtomModelTrainer.create_hparams()
    hp.num_questions = num_questions
    hp.thetas = THETAS
    hp.out_dir = str(tmp_path / "exp")
    hp.model_name = "pin_atoms"
    hp.epochs = 10
    hp.batch_size_train = 3
    hp.learning_rate = 0.001
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = True
    hp.device = "cpu"
    trainer = AtomModelTrainer(hp, list(id_list), **_dirs(fixtures_dir))
    trainer.init(hp, model_config=_atom_config("RNNDYN-1_RELU_64-1_FC_5",
                                               num_questions))
    _from_jax_draw(trainer)
    trainer.train(hp)
    f0_rmse, vde = trainer.benchmark(hp, trainer.id_list_train)
    print("port atom metrics:", float(f0_rmse), float(vde))
    assert_one_sided("f0_rmse", float(f0_rmse), PINNED_ATOM["f0_rmse"])
    assert_one_sided("vde", float(vde), PINNED_ATOM["vde"])


@pytest.fixture(scope="module")
def phrase_scores(fixtures_dir, id_list, num_questions, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pin_phrase")
    dirs = _dirs(fixtures_dir)

    def base_hp(cls, name, epochs):
        hp = cls.create_hparams()
        hp.num_questions = num_questions
        hp.thetas = THETAS
        hp.out_dir = str(tmp / name)
        hp.model_name = name
        hp.epochs = epochs
        hp.batch_size_train = 3
        hp.batch_size_val = 6
        hp.learning_rate = 0.001
        hp.seed = 1
        hp.test_set_perc = 0.0
        hp.val_set_perc = 0.25
        hp.use_best_as_final_model = False
        hp.device = "cpu"
        return hp

    atom_hp = base_hp(AtomVUVDistPosModelTrainer, "atoms", 3)
    atom_tr = AtomVUVDistPosModelTrainer(atom_hp, list(id_list), **dirs)
    atom_tr.init(atom_hp, model_config=_atom_config(
        "RNNDYN-1_RELU_32-1_FC_7", num_questions))
    _from_jax_draw(atom_tr)
    flat_hp = base_hp(AtomNeuralFilterModelTrainer, "flat", 3)
    flat_tr = AtomNeuralFilterModelTrainer(flat_hp, list(id_list), **dirs)
    flat_tr.init_atom(flat_hp, atom_tr)
    flat_tr.init(flat_hp)
    _from_jax_draw(flat_tr)
    phrase_hp = base_hp(PhraseAtomNeuralFilterModelTrainer, "phrase", 3)
    phrase_hp.add_hparams(phrase_bias_init=5.2)
    phrase_tr = PhraseAtomNeuralFilterModelTrainer(phrase_hp, list(id_list),
                                                   **dirs)
    phrase_tr.init_flat(phrase_hp, flat_tr)
    phrase_tr.init(phrase_hp)
    _from_jax_draw(phrase_tr)

    phrase_tr.train_atom(atom_hp)
    phrase_tr.train_flat(flat_hp)
    phrase_tr.train(phrase_hp)
    flat = flat_tr.benchmark(flat_hp, flat_tr.id_list_train)
    phrase = phrase_tr.benchmark(phrase_hp, phrase_tr.id_list_train)
    print("port flat:", flat, "phrase:", phrase)
    return {"flat": dict(zip(("f0_rmse", "vde"), map(float, flat))),
            "phrase": dict(zip(("f0_rmse", "vde"), map(float, phrase)))}


@pytest.mark.parametrize("stage,key", [
    ("flat", "f0_rmse"), ("flat", "vde"),
    ("phrase", "f0_rmse"), ("phrase", "vde")])
def test_phrase_pipeline_benchmark_pinned(phrase_scores, stage, key):
    pins = PINNED_FLAT if stage == "flat" else PINNED_PHRASE
    assert_one_sided(key, phrase_scores[stage][key], pins[key])


@pytest.fixture(scope="module")
def vtln_scores(fixtures_dir, id_list, num_questions, tmp_path_factory):
    hp = VTLNSpeakerAdaptionModelTrainer.create_hparams()
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.out_dir = str(tmp_path_factory.mktemp("pin_vtln"))
    hp.model_name = "pin_vtln"
    hp.epochs = 8
    hp.batch_size_train = 3
    hp.batch_size_val = 6
    hp.learning_rate = 0.0005
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = True
    hp.warp_matrix_size = 20
    hp.device = "cpu"
    trainer = VTLNSpeakerAdaptionModelTrainer(
        hp, list(id_list),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    pre_net = convert_legacy_string("RNNDYN-1_RELU_64-1_FC_67", num_questions)
    pre_net.input_names = ("questions",)
    pre_net.output_names = ("pre_net_output",)
    readers = trainer.default_data_reader_configs(hp)
    readers.append(CategoryDataReader.Config(
        name="speaker_embedding", get_category_fn=lambda idn: [0.5]))
    trainer.init(hp, model_config=trainer.build_model_config(hp, pre_net, 20),
                 data_reader_configs=readers)
    _from_jax_draw(trainer)
    trainer.train(hp)
    mcd, f0_rmse, vde, bap = trainer.benchmark(hp, trainer.id_list_train)
    scores = {"mcd": float(mcd), "f0_rmse": float(f0_rmse),
              "vde": float(vde), "bap": float(bap)}
    print("port vtln metrics:", scores, trainer.mcd_sweep)
    return scores


@pytest.mark.parametrize("key", sorted(PINNED_VTLN))
def test_vtln_benchmark_pinned(vtln_scores, key):
    assert_one_sided(key, vtln_scores[key], PINNED_VTLN[key])
