"""``WindowingWrapper`` and ``ClassificationTrainer`` of the port against
the JAX package: every output merge mode (window cross-fade, cat, add,
mean, mul), a sequence shorter than the window, a static 2-D first
input, the positional output names; and the classification trainer end
to end on the fixtures (training from the JAX draw against the JAX
trainer, then the confusion matrix and unweighted accuracy).

Tolerances, measured: the wrapped model is a bf16 rnn_dyn model (a
BiLSTM between bf16 Dense layers) whose bf16 outputs may differ by one
bf16 ulp where a value sits on a rounding boundary, and the merges add,
average or multiply them in float32: within 2^-8 of their magnitude
(one bf16 ulp; measured 6.0e-4, the cross-fade); the classification
losses within
1e-4 relative; after two epochs of bf16 training a frame whose two
logits nearly tie may change class: the confusion matrices within 1%
of the frames (measured 4 of 1413) and the accuracy within 0.01.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.questions import QuestionLabelGen as JaxQuestions
from idiaptts_tpu.data.reader import DataReader as JaxDataReader
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.models import wrappers as jax_wrappers
from idiaptts_tpu.train import classification as jax_cls
from idiaptts_torch.data.questions import QuestionLabelGen
from idiaptts_torch.data.reader import DataReader
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.models import wrappers as torch_wrappers
from idiaptts_torch.train import classification as torch_cls

REL = 2.0 ** -8     # one bf16 ulp of the output's magnitude


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(merge, window=8, step=5, input_names=("x", "spk")):
    configs = []
    for wrappers, rnn in ((jax_wrappers, jax_rnn),
                          (torch_wrappers, torch_rnn)):
        inner = rnn.convert_legacy_string(
            "RNNDYN-1_RELU_12-1_BiLSTM_8-1_FC_3", 6)
        inner.input_names = input_names
        inner.output_names = ("inner_out",)
        configs.append(wrappers.WindowingWrapper.Config(
            wrapped_model_config=inner, window_size=window,
            window_step=step, output_merge_type=merge,
            input_names=input_names, output_names=("y",)))
    return configs


@pytest.mark.parametrize("merge,T", [
    ("window", 23), ("cat", 23), ("add", 23), ("mean", 23), ("mul", 23),
    ("window", 6)])
def test_windowing_wrapper_matches_jax(merge, T):
    """Each merge mode on a batch whose second row is shorter (its last
    window invalid), with a static speaker row as the second input; at
    T=6 the sequence runs unwindowed."""
    cfg_j, cfg_t = _configs(merge, step=8 if merge == "cat" else 5)
    rng = np.random.RandomState(0)
    data = {"x": rng.randn(2, T, 5).astype(np.float32),
            "spk": rng.randn(2, 1).astype(np.float32)}
    lengths = np.array([T, max(1, T - 10)])
    jm = cfg_j.create_model()
    variables = jm.init(jax.random.PRNGKey(0), data,
                        lengths=jnp.asarray(lengths))
    model = cfg_t.create_model()
    convert.load_flax_params(model, _to_np(variables))
    ref = jax.jit(lambda v, d, n: jm.apply(v, d, lengths=n))(
        variables, data, jnp.asarray(lengths))
    got = model({k: torch.from_numpy(v) for k, v in data.items()},
                lengths=torch.from_numpy(lengths))
    assert set(got) == set(ref)
    r = np.asarray(ref["y"])
    g = got["y"].detach().numpy()
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= REL * np.abs(r).max()


def _classification_trainer(mod, questions_cls, reader_cls, fixtures_dir,
                            id_list, num_questions, tmp_path, port):
    class TiledCategoryReader(reader_cls):
        """A class id a utterance (the parity of the number in its
        name), tiled along time."""

        class Config(reader_cls.Config):
            def create_reader(self):
                return TiledCategoryReader(self)

        def load(self, id_name):
            return np.full((4000, 1), int(id_name[-1]) % 2, np.float32)

    cls = mod.ClassificationTrainer
    hp = cls.create_hparams()
    hp.set_hparam("num_classes", 2)
    hp.out_dir = str(tmp_path)
    hp.model_name = "clf"
    hp.epochs = 2
    hp.batch_size_train = 3
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = False
    if port:
        hp.device = "cpu"
    trainer = cls(hp, list(id_list))
    readers = [questions_cls.Config(
                   name="questions",
                   directory=os.path.join(fixtures_dir, "questions"),
                   num_questions=num_questions,
                   match_length=("class_target",)),
               TiledCategoryReader.Config(name="class_target",
                                          match_length=("questions",))]
    rnn = torch_rnn if port else jax_rnn
    cfg = rnn.convert_legacy_string("RNNDYN-2_RELU_32-1_FC_2", num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_class",)
    trainer.init(hp, model_config=cfg, data_reader_configs=readers)
    return trainer


def test_classification_trainer_end_to_end(fixtures_dir, id_list,
                                           num_questions, tmp_path):
    """Two epochs of the port's trainer against the JAX trainer's from
    the JAX draw, then the benchmark's confusion matrix and unweighted
    accuracy."""
    jt = _classification_trainer(jax_cls, JaxQuestions, JaxDataReader,
                                 fixtures_dir, id_list, num_questions,
                                 tmp_path / "jax", False)
    tt = _classification_trainer(torch_cls, QuestionLabelGen, DataReader,
                                 fixtures_dir, id_list, num_questions,
                                 tmp_path / "port", True)
    convert.load_flax_params(tt.model_handler.model,
                             _to_np(jt.model_handler.params))
    val_j, train_j = jt.train(jt.hparams)
    val_t, train_t = tt.train(tt.hparams)
    np.testing.assert_allclose(train_t, train_j, rtol=1e-4)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-4)
    assert train_t[-1] < train_t[0]
    ids = tt.id_list_train[:3]
    acc_j, conf_j = jt.benchmark(jt.hparams, ids)
    acc_t, conf_t = tt.benchmark(tt.hparams, ids)
    assert conf_t.shape == (2, 2) and conf_t.sum() > 0
    # Frames whose two logits nearly tie may change class.
    assert np.abs(conf_t - conf_j).sum() <= 0.01 * conf_j.sum()
    assert acc_t == pytest.approx(acc_j, abs=0.01)
    assert 0.0 <= acc_t <= 1.0


@pytest.mark.parametrize("module,name", [
    ("wavenet_trainer", "WaveNetVocoderTrainer"),
    ("atom_trainers", "AtomModelTrainer"),
    ("atom_trainers", "AtomVUVDistPosModelTrainer"),
    ("atom_trainers", "AtomNeuralFilterModelTrainer"),
    ("atom_trainers", "PhraseAtomNeuralFilterModelTrainer"),
    ("vtln_trainer", "VTLNSpeakerAdaptionModelTrainer"),
    ("enc_dec_trainer", "EncDecMonophoneModelTrainer"),
    ("classification", "ClassificationTrainer")])
def test_new_trainers_default_to_cuda(module, name):
    """Every trainer runs on the card unless its hparams ask for the
    CPU, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    import importlib
    cls = getattr(importlib.import_module("idiaptts_torch.train." + module),
                  name)
    hp = cls.create_hparams()
    assert hp.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(hp, ["gen-0001"])
    hp.device = "cpu"
    assert cls(hp, ["gen-0001"]).model_handler.device.type == "cpu"
