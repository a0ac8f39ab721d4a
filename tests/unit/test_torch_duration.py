"""The port's DurationModelTrainer against the JAX package's, on the
fixture corpus with the quality-pin recipe's inputs (phone-level
questions taken from ``gen_data``'s frames at each phone's first frame)
and the default model ``RNNDYN-3_RELU_512-1_FC_5`` at full width.

The JAX trainer's flax weights are converted into the port's.  The
models agree at bf16 scale (ROADMAP fault 3.2), so a rounded duration
may differ where the unrounded prediction lies within bf16 rounding of
a .5 boundary: such states are counted and bounded.  Also here: the
windowing dataset against the JAX package's, and a training epoch fed
from it.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.data import dataset as jax_dataset
from idiaptts_tpu.data.normalisation import MinMaxExtractor
from idiaptts_tpu.data.phonemes import PhonemeDurationLabelGen
from idiaptts_tpu.data.questions import QuestionLabelGen
from idiaptts_tpu.train.duration import \
    DurationModelTrainer as JaxDurationModelTrainer
from idiaptts_tpu.train.trainer import ModularTrainer as JaxModularTrainer
from idiaptts_torch.data import dataset as torch_dataset
from idiaptts_torch.models import convert
from idiaptts_torch.train.duration import DurationModelTrainer
from idiaptts_torch.train.trainer import ModularTrainer

# The models' outputs are bf16 (8 significant bits), so the two packages'
# unrounded durations may differ by an ulp: 2**-7 relative covers one to
# two ulps.  A rounded duration may differ only where the prediction
# lies within that band of a .5 boundary.
BF16_BAND = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    about twice as fast as eight, and far faster when the suite's
    parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def prepare_phone_questions(fixtures_dir, id_list, question_file, out_dir):
    """The pin recipe's phone-level questions: the frame questions of
    each phone's first frame, with their min-max statistics."""
    label_dir = os.path.join(fixtures_dir, "labels", "label_state_align")
    label_dict, _, _ = QuestionLabelGen.gen_data(
        label_dir, question_file, dir_out=None, id_list=id_list,
        return_dict=True)
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


def _hparams(cls, num_questions, out_dir, **overrides):
    hp = cls.create_hparams()
    hp.num_questions = num_questions
    hp.out_dir = str(out_dir)
    hp.model_name = "dur"
    hp.epochs = 2
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.use_best_as_final_model = True
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    if cls is DurationModelTrainer:
        hp.device = "cpu"
    for key, value in overrides.items():
        hp.setattr_no_type_check(key, value)
    return hp


def converted(jax_trainer, port_trainer):
    convert.load_flax_params(
        port_trainer.model_handler.model,
        jax.tree_util.tree_map(np.asarray, jax_trainer.model_handler.params))
    return port_trainer


@pytest.fixture(scope="module")
def pair(fixtures_dir, id_list, question_file, num_questions,
         tmp_path_factory):
    """Both trainers from the same initial weights, each trained two
    epochs of the pin recipe."""
    tmp = tmp_path_factory.mktemp("duration")
    dq = prepare_phone_questions(fixtures_dir, id_list, question_file,
                                 str(tmp / "questions"))
    dirs = dict(dir_phoneme_labels=dq,
                dir_durations=os.path.join(fixtures_dir, "dur"))
    hp_j = _hparams(JaxDurationModelTrainer, num_questions, tmp / "jax")
    jt = JaxDurationModelTrainer(hp_j, list(id_list), **dirs)
    jt.init(hp_j)
    hp = _hparams(DurationModelTrainer, num_questions, tmp / "port")
    pt = DurationModelTrainer(hp, list(id_list), **dirs)
    pt.init(hp)
    converted(jt, pt)
    losses_j = jt.train(hp_j)
    losses = pt.train(hp)
    return dict(jax=jt, port=pt, hp=hp, hp_j=hp_j, dirs=dirs, tmp=tmp,
                losses=losses, losses_j=losses_j, ids=list(id_list))


def test_default_model_is_the_jax_default(pair):
    cfg = pair["port"].default_model_config(pair["hp"], 409)
    ref = pair["jax"].default_model_config(pair["hp_j"], 409)
    shape = [(c.layer_type, c.out_dim, c.num_layers, c.nonlin)
             for c in cfg.layer_configs]
    assert shape == [(c.layer_type, c.out_dim, c.num_layers, c.nonlin)
                     for c in ref.layer_configs]
    assert shape == [("Linear", 512, 3, "ReLU"), ("Linear", 5, 1, None)]


def test_training_tracks_jax(pair):
    """Two epochs from the same initial weights, the same split and
    batch order: the loss falls, and each epoch's train and validation
    losses stay within 5e-3 relative of JAX's (measured 6e-4; the
    models agree at bf16 scale and Adam passes that on)."""
    (val, train), (val_j, train_j) = pair["losses"], pair["losses_j"]
    assert pair["port"].id_list_train == pair["jax"].id_list_train
    assert len(train) == 2 and train[-1] < train[0]
    np.testing.assert_allclose(train, train_j, rtol=5e-3)
    np.testing.assert_allclose(val, val_j, rtol=5e-3)


def _converted_port(pair):
    """A fresh port trainer carrying the trained JAX weights."""
    hp = _hparams(DurationModelTrainer, pair["hp_j"].num_questions,
                  pair["tmp"] / "port_conv", epochs=0)
    trainer = DurationModelTrainer(hp, pair["ids"], **pair["dirs"])
    trainer.init(hp)
    return converted(pair["jax"], trainer), hp


def test_forward_durations_match_jax(pair):
    """forward: rounded non-negative int64 durations of the JAX shape.
    The unrounded predictions agree within BF16_BAND; a rounded state
    may differ only where the prediction lies within BF16_BAND of a .5
    boundary, and those states are at most 5% (measured 9 of 365 after
    two epochs: at 16-32 frames an ulp of bf16 is 0.125)."""
    trainer, hp = _converted_port(pair)
    ids = pair["ids"]
    got = trainer.forward(hp, ids)
    ref = pair["jax"].forward(pair["hp_j"], ids)
    raw = JaxModularTrainer.forward(pair["jax"], pair["hp_j"], ids)
    raw_port = ModularTrainer.forward(trainer, hp, ids)
    states = differing = 0
    for id_name in ids:
        assert got[id_name].dtype == np.int64
        assert got[id_name].shape == ref[id_name].shape
        assert np.all(got[id_name] >= 0)
        r = np.asarray(raw[id_name]["pred_durations"], np.float64)
        p = np.asarray(raw_port[id_name]["pred_durations"], np.float64)
        band = BF16_BAND * np.maximum(np.abs(r), 1.0)
        np.testing.assert_allclose(p, r, rtol=0, atol=band.max())
        diff = got[id_name] != ref[id_name]
        near_half = np.abs(r - np.floor(r) - 0.5) <= band
        assert not np.any(diff & ~near_half), id_name
        states += diff.size
        differing += int(diff.sum())
    assert differing <= 0.05 * states, (differing, states)


def test_benchmark_matches_jax(pair):
    """Dur RMSE within 5e-3 relative of JAX's on the same weights, an
    ulp of the bf16 outputs (measured 1.6e-3), and Pearson per state
    within 5e-3 (measured 9e-4)."""
    trainer, hp = _converted_port(pair)
    rmse, pearson = trainer.benchmark(hp, pair["ids"])
    rmse_j, pearson_j = pair["jax"].benchmark(pair["hp_j"], pair["ids"])
    assert pearson.shape == (5,)
    np.testing.assert_allclose(rmse, rmse_j, rtol=5e-3)
    np.testing.assert_allclose(pearson, pearson_j, rtol=0, atol=5e-3)


def test_checkpoint_reload_forwards_the_same(pair):
    """The port's checkpoint (its own format) rebuilt from config.json
    gives the trained trainer's durations."""
    hp = _hparams(DurationModelTrainer, pair["hp"].num_questions,
                  pair["hp"].out_dir, load_from_checkpoint=True, epochs=0)
    reloaded = DurationModelTrainer(hp, pair["ids"], **pair["dirs"])
    reloaded.init(hp)
    got = reloaded.forward(hp, pair["ids"][:2])
    ref = pair["port"].forward(pair["hp"], pair["ids"][:2])
    for id_name, dur in ref.items():
        np.testing.assert_array_equal(got[id_name], dur)


def test_gen_waveform_raises(pair):
    with pytest.raises(NotImplementedError):
        pair["port"].gen_waveform(pair["hp"], {})


def _window_pair(pair, size, step):
    readers = list(pair["port"].datareaders.values())
    return (jax_dataset.WindowingDatareadersDataset(
                pair["ids"], readers, window_size=size, window_step=step,
                random_select=False),
            torch_dataset.WindowingDatareadersDataset(
                pair["ids"], readers, window_size=size, window_step=step,
                random_select=False))


@pytest.mark.parametrize("size, step", [(5, 3), (6, 6), (500, 50), (1, 1)])
def test_windowing_dataset_matches_jax(pair, size, step):
    """work_items, get_work_item and iteration give JAX's windows."""
    ref, got = _window_pair(pair, size, step)
    items = got.work_items(pair["ids"])
    assert items == ref.work_items(pair["ids"])
    windows = [got.get_work_item(item)[0] for item in items]
    assert len(windows) == len(list(iter(got))) == len(list(iter(ref)))
    for item, window, (ref_window, _) in zip(items, windows, iter(ref)):
        assert sorted(window) == sorted(ref_window)
        assert window["_window_idx"] == ref_window["_window_idx"] == item[1]
        for key in ("questions", "durations"):
            np.testing.assert_array_equal(window[key], ref_window[key])
            assert len(window[key]) <= size
    # A plain id (not a window tuple) fetches the whole utterance.
    whole, _ = got.get_work_item(pair["ids"][0])
    assert len(whole["questions"]) == len(
        got.get_id_name(pair["ids"][0])[0]["questions"])


def test_training_batches_come_from_the_windows(pair):
    """dataset_type picks the windowing dataset; the batcher takes its
    windows as work items, so an epoch takes one step per batch of
    windows."""
    hp = _hparams(DurationModelTrainer, pair["hp"].num_questions,
                  pair["tmp"] / "windows", epochs=1,
                  dataset_type="WindowingDatareadersDataset",
                  use_best_as_final_model=False)
    trainer = DurationModelTrainer(hp, pair["ids"], **pair["dirs"])
    trainer.init(hp)
    dataset = trainer.dataset_train
    assert isinstance(dataset, torch_dataset.WindowingDatareadersDataset)
    dataset.window_size, dataset.window_step = 6, 4
    items = dataset.work_items(trainer.id_list_train)
    assert len(items) > len(trainer.id_list_train)
    batches = list(trainer._batches(dataset, trainer.id_list_train, 2,
                                    prefetch=0))
    assert len(batches) == math.ceil(len(items) / 2)
    assert all(b["questions"].shape[0] <= 2 for b in batches)
    assert max(int(n) for b in batches
               for n in b["_lengths"]["questions"]) <= 6
    _, train_losses = trainer.train(hp)
    assert trainer.model_handler.total_steps == len(batches)
    assert np.isfinite(train_losses).all()
