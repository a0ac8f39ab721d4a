"""The port's utilities (``utils/misc.py``, ``utils/equality.py``) and the
API that earlier slices left out of ported modules (``ops/audio_io``'s
``rms_normalise`` and ``highpass_filter``, ``ExtendedHParams.get_value``
and ``enable_backwards_compatibility`` and the mesh keys, the trainer's
reference-surface helpers, ``get_input_dim``/``get_datareader_by_name``,
``WorldFeatLabelGen.load_flags``, the question and duration CLIs, the
bundled assets), each against the JAX package on the same inputs.  All
of it is host code: results are equal, not close.
"""

import logging
import os

import numpy as np
import pytest
import torch

from idiaptts_tpu.data import dataset as jax_dataset
from idiaptts_tpu.data import phonemes as jax_phonemes
from idiaptts_tpu.data import questions as jax_questions
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_tpu.hparams import ExtendedHParams as JaxHParams
from idiaptts_tpu.ops import audio_io as jax_audio_io
from idiaptts_tpu.train.trainer import ModularTrainer as JaxTrainer
from idiaptts_tpu.utils import equality as jax_equality
from idiaptts_tpu.utils import misc as jax_misc
from idiaptts_torch.data import dataset as torch_dataset
from idiaptts_torch.data import phonemes as torch_phonemes
from idiaptts_torch.data import questions as torch_questions
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.ops import audio_io
from idiaptts_torch.train.handler import ModularModelHandler
from idiaptts_torch.train.trainer import ModularTrainer
from idiaptts_torch.utils import equality, misc

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU path is many small ops: one intra-op thread runs it
    faster, above all beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- utils/misc.py ------------------------------------------------------------

def test_misc_host_helpers_match_jax(tmp_path, fixtures_dir):
    id_list = os.path.join(fixtures_dir, "file_id_list.txt")
    assert misc.file_len(id_list) == jax_misc.file_len(id_list)
    assert misc.get_id_list(id_list) == jax_misc.get_id_list(id_list)
    path = str(tmp_path / "a" / "b")
    assert misc.makedirs_safe(path) == path and os.path.isdir(path)
    assert misc.log_git_hash(REPO) == jax_misc.log_git_hash(REPO)
    assert misc.log_git_hash(str(tmp_path)) == "unknown"
    assert misc.get_memory_usage_mb() > 0
    items = list(range(23))
    for select, skip, start in ((2, 3, 0), (1, 1, 1), (4, 0, 2)):
        assert misc.select_skip(items, select, skip, start) == \
            jax_misc.select_skip(items, select, skip, start)
    assert misc.ncr(10, 3) == jax_misc.ncr(10, 3) == 120
    assert misc.local_modification_time(id_list) == \
        jax_misc.local_modification_time(id_list)
    for value in (0.001, 1.5e-4, 0.25):
        assert misc.pretty_print_decimal_places(value) == \
            jax_misc.pretty_print_decimal_places(value)
    x = np.random.RandomState(0).randn(3, 4)
    assert misc.ndarray_to_string(x) == jax_misc.ndarray_to_string(x)
    nested = {"a": [1, {"b": x}], "c": "text"}
    assert misc.pretty_print_nested(nested) == \
        jax_misc.pretty_print_nested(nested)
    for spec in ("0,2-5,7", "-1", "(3)"):
        assert misc.parse_int_set(spec) == jax_misc.parse_int_set(spec)


def test_device_memory_stats_without_a_card():
    """``torch.cuda.memory_stats`` per card; none here."""
    assert not torch.cuda.is_available()
    assert misc.get_device_memory_stats() == {}


# -- utils/equality.py --------------------------------------------------------

EQUALITY_CASES = [
    ({"a": np.ones(3), "b": [1, 2]}, {"a": np.ones(3), "b": [1, 2]}, 0.0),
    ({"a": np.ones(3)}, {"a": np.ones(3) + 1e-3}, 0.0),
    ({"a": np.ones(3)}, {"a": np.ones(3) + 1e-3}, 1e-2),
    ({"a": np.ones(3)}, {"b": np.ones(3)}, 0.0),
    ([np.zeros((2, 2))], [np.zeros((2, 3))], 0.0),
    (["x", "y"], ["x", "y"], 0.0),
    ((1.0, "s"), (1.0, "t"), 0.0),
]


@pytest.mark.parametrize("a,b,atol", EQUALITY_CASES)
def test_equal_iterable_matches_jax(a, b, atol):
    want = jax_equality.equal_iterable(a, b, atol)
    assert equality.equal_iterable(a, b, atol) == want
    to_t = lambda v: {k: torch.as_tensor(x) if isinstance(x, np.ndarray)
                      else x for k, x in v.items()} \
        if isinstance(v, dict) else v
    assert equality.equal_iterable(to_t(a), to_t(b), atol) == want


def test_equal_model_and_checkpoint(tmp_path):
    torch.manual_seed(0)
    a = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    b = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    assert equality.equal_model(a, a.state_dict())
    assert not equality.equal_model(a, b)
    b.load_state_dict(a.state_dict())
    assert equality.equal_model(a, b)
    with torch.no_grad():
        b[0].bias.add_(1e-4)
    assert not equality.equal_model(a, b)
    assert equality.equal_model(a, b, atol=1e-3)
    # Two of the port's checkpoints, written by the handler.
    from idiaptts_torch.models import rnn_dyn
    cfg = rnn_dyn.convert_legacy_string("RNNDYN-1_RELU_8-1_FC_3", 5)
    handler = ModularModelHandler(device="cpu")
    handler.create_model(cfg)
    out = handler.save_checkpoint(str(tmp_path), "m", epoch=1)
    handler.save_checkpoint(str(tmp_path), "m", epoch=2)
    assert equality.equal_checkpoint(out, "e1", out, "e2")
    with torch.no_grad():
        next(handler.model.parameters()).add_(1.0)
    handler.save_checkpoint(str(tmp_path), "m", epoch=3)
    assert not equality.equal_checkpoint(out, "e1", out, "e3")


@pytest.mark.parametrize("length,axis,value", [(7, 0, 0.0), (5, 1, -1.0),
                                               (2, 0, 0.0)])
def test_tensor_pad_matches_jax(length, axis, value):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    want = jax_equality.tensor_pad(x, length, axis, value)
    got = equality.tensor_pad(torch.from_numpy(x), length, axis, value)
    assert torch.is_tensor(got)
    np.testing.assert_array_equal(got.numpy(), want)


# -- ops/audio_io.py ----------------------------------------------------------

def test_rms_normalise_and_highpass_match_jax(fixtures_dir):
    raw, fs = audio_io.get_raw(os.path.join(fixtures_dir, "database", "wav",
                                            "gen-0001.wav"))
    for dbfs in (-20.0, -30.0):
        got = audio_io.rms_normalise(raw, dbfs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_audio_io.rms_normalise(
            raw, dbfs))
    for cutoff, order in ((70.0, 1001), (200.0, 100)):
        np.testing.assert_array_equal(
            audio_io.highpass_filter(raw, fs, cutoff, order),
            jax_audio_io.highpass_filter(raw, fs, cutoff, order))


# -- hparams.py ---------------------------------------------------------------

def test_get_value_and_backwards_compatibility_match_jax():
    for cls in (JaxHParams, ExtendedHParams):
        assert cls.create_hparams().get_value("seed", 7) == 1234
    results = []
    for cls in (JaxHParams, ExtendedHParams):
        hp = cls.create_hparams("learning_rate=0.01")
        assert hp.get_value("synth_dir", "fallback") == "fallback"
        hp.optimiser_args = {}
        hp.load_from_checkpoint = True
        hp.add_hparams(checkpoint_epoch=4, epochs_per_checkpoint=3)
        hp.enable_backwards_compatibility()
        results.append({k: v for k, v in hp.values().items()
                        if k not in ("device", "bf16_residuals")})
    assert results[1] == results[0]
    assert results[1]["epoch_to_load"] == 4
    assert results[1]["checkpoint_epoch_interval"] == 3
    assert results[1]["optimiser_args"] == {"lr": 0.01}


def test_jax_mesh_keys_load():
    """A JAX hparams string with the mesh keys loads; use_shard_map takes
    a bool where "auto" is declared."""
    spec = ("num_devices=2,model_parallel=1,use_shard_map=True,"
            "data_axis=batch")
    ref, got = JaxHParams.create_hparams(spec), \
        ExtendedHParams.create_hparams(spec)
    for key in ("num_devices", "model_parallel", "use_shard_map",
                "mesh_shape", "data_axis"):
        assert got.get(key) == ref.get(key), key


# -- train/trainer.py ---------------------------------------------------------

@pytest.fixture
def trainers(tmp_path):
    """The JAX and the port's ModularTrainer with the same id splits and
    recorded losses."""
    out = []
    for cls, hp_cls in ((JaxTrainer, JaxHParams),
                        (ModularTrainer, ExtendedHParams)):
        hp = hp_cls.create_hparams()
        hp.out_dir = str(tmp_path / cls.__module__.split(".")[0])
        hp.seed = 3
        if hp_cls is ExtendedHParams:
            hp.device = "cpu"
        trainer = cls(hp, ["spk/u{}".format(i) for i in range(40)])
        for epoch in (1, 2):
            trainer.record_train_loss({"mse": 1.0 / epoch, "kl": 0.5},
                                      epoch)
            trainer.record_validation_loss({"mse": 2.0 / epoch,
                                            "kl": 0.25}, epoch)
        out.append((trainer, hp))
    return out


def _logged(caplog, fn, logger_name):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger_name):
        fn()
    return [r.getMessage() for r in caplog.records
            if r.name == logger_name]


def test_trainer_logging_helpers_match_jax(trainers, caplog):
    (ref, hp_ref), (got, hp) = trainers
    assert got._get_loss_names() == ref._get_loss_names() == ["mse", "kl"]
    for name in ("log_validation_set", "log_test_set", "log_losses"):
        want = _logged(caplog, getattr(ref, name), JaxTrainer.__module__)
        have = _logged(caplog, getattr(got, name), ModularTrainer.__module__)
        assert have == want and have, name
    assert any("CPU RSS" in m for m in _logged(
        caplog, got.log_memory, ModularTrainer.__module__))
    hp.epochs_per_scheduler_step = 2
    hp.epochs_per_test = 3
    hp_ref.epochs_per_scheduler_step = 2
    hp_ref.epochs_per_test = 3
    want = _logged(caplog, lambda: ref.sanity_check_train(hp_ref),
                   JaxTrainer.__module__)
    have = _logged(caplog, lambda: got.sanity_check_train(hp),
                   ModularTrainer.__module__)
    assert have == want and len(have) == 2


def test_gen_output_writes_the_jax_keys(trainers, tmp_path):
    """The same forward results give npz files with the same members."""
    sample = {"pred": np.arange(6.0).reshape(3, 2), "aux": np.ones(4),
              "_lengths": None}
    results = {"u1": sample, "u2": np.zeros((2, 2))}
    written = []
    for trainer, hp in trainers:
        trainer.forward = lambda hp_, ids: results
        out_dir = str(tmp_path / ("out_" + type(trainer).__module__))
        hp.add_hparams(save_output_dir=out_dir)
        for mapping in (None, {"pred": "reader"}):
            trainer.gen_output(hp, ["u1", "u2"], mapping)
            written.append({name: dict(np.load(os.path.join(
                out_dir, name + ".npz"), allow_pickle=True))
                for name in ("u1", "u2")})
    for jax_files, port_files in ((written[0], written[2]),
                                  (written[1], written[3])):
        for name in jax_files:
            assert sorted(port_files[name]) == sorted(jax_files[name])
            for key, value in jax_files[name].items():
                np.testing.assert_array_equal(port_files[name][key], value)


def test_get_labels_and_plots(trainers, tmp_path):
    _, (trainer, _) = trainers

    class Reader:
        def load(self, id_name):
            return {"id": id_name}

    trainer.datareaders = {"r": Reader()}
    assert trainer.get_labels("r", "u3") == {"id": "u3"}
    pytest.importorskip("matplotlib")
    p1 = trainer.plot1d(np.sin(np.arange(50) / 5.0),
                        str(tmp_path / "curve.png"), "sine")
    p2 = trainer.plot_specshow(np.random.RandomState(0).rand(40, 16),
                               str(tmp_path / "spec.png"), "spec")
    for path in (p1, p2):
        assert os.path.getsize(path) > 1000


# -- data/dataset.py, data/world_feat.py --------------------------------------

def test_dataset_helpers_match_jax(fixtures_dir, id_list, num_questions):
    from idiaptts_tpu.data.questions import QuestionLabelGen as JaxQ
    from idiaptts_torch.data.questions import QuestionLabelGen
    q_dir = os.path.join(fixtures_dir, "questions")
    world = os.path.join(fixtures_dir, "WORLD")
    sets = []
    for ds_mod, q_cls, w_cls in ((jax_dataset, JaxQ, JaxWorld),
                                 (torch_dataset, QuestionLabelGen,
                                  WorldFeatLabelGen)):
        kw = {} if w_cls is JaxWorld else {"device": "cpu"}
        readers = [q_cls.Config(name="questions", directory=q_dir,
                                num_questions=num_questions).create_reader(),
                   w_cls.Config(name="cmp", directory=world,
                                output_names=("acoustic",),
                                add_deltas=True, num_coded_sps=20,
                                **kw).create_reader()]
        sets.append(ds_mod.DatareadersDataset(list(id_list), readers))
    for names in (("questions",), ("questions", "acoustic")):
        assert sets[1].get_input_dim(names) == sets[0].get_input_dim(names)
    assert sets[1].get_input_dim(("questions",)) == num_questions
    assert sets[1].get_datareader_by_name("cmp").name == "cmp"
    with pytest.raises(KeyError):
        sets[1].get_datareader_by_name("nope")
    for flags in ((True, True, True, True), (True, False, True, False)):
        kw = dict(dir_labels=world, load_sp=flags[0], load_lf0=flags[1],
                  load_vuv=flags[2], load_bap=flags[3])
        assert WorldFeatLabelGen(device="cpu", **kw).load_flags == \
            JaxWorld(**kw).load_flags == flags


# -- the CLIs and the assets --------------------------------------------------

def _npz_members(path):
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def test_question_and_duration_clis_match_jax(fixtures_dir, tmp_path,
                                              monkeypatch):
    labels = os.path.join(fixtures_dir, "labels", "label_state_align")
    hed = os.path.join(fixtures_dir, "questions-gen_dnn.hed")
    ids = tmp_path / "ids.txt"
    ids.write_text("gen-0001\ngen-0002\n")
    # The JAX side with its Python matcher: nothing is built in native/.
    monkeypatch.setattr(jax_questions.QuestionSet, "native",
                        lambda self: None)
    outputs = {}
    for name, mod in (("jax", jax_questions), ("torch", torch_questions)):
        out = tmp_path / ("q_" + name)
        argv = ["-l", labels, "-q", hed, "-o", str(out), "-i", str(ids)]
        if name == "jax":
            monkeypatch.setattr("sys.argv", ["questions"] + argv)
            mod.main()
        else:
            mod.main(argv)
        outputs[name] = out
    for id_name in ("gen-0001", "gen-0002"):
        with open(outputs["jax"] / (id_name + ".questions"), "rb") as a, \
                open(outputs["torch"] / (id_name + ".questions"), "rb") as b:
            assert a.read() == b.read()
    for name, mod in (("jax", jax_phonemes), ("torch", torch_phonemes)):
        out = tmp_path / ("d_" + name)
        argv = ["-l", labels, "-o", str(out), "-i", str(ids)]
        if name == "jax":
            monkeypatch.setattr("sys.argv", ["phonemes"] + argv)
            mod.main()
        else:
            mod.main(argv)
        outputs[name] = out
    jax_files = sorted(os.listdir(outputs["jax"]))
    assert sorted(os.listdir(outputs["torch"])) == jax_files
    for f in jax_files:
        a, b = outputs["jax"] / f, outputs["torch"] / f
        if f.endswith(".npz"):
            got, want = _npz_members(b), _npz_members(a)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert a.read_bytes() == b.read_bytes(), f


def test_cli_runs_as_a_module(fixtures_dir, tmp_path):
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "idiaptts_torch.data.questions", "--help"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--file_questions" in proc.stdout


def test_assets_are_byte_copies():
    src = os.path.join(REPO, "idiaptts_tpu", "assets")
    dst = os.path.join(REPO, "idiaptts_torch", "assets")
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(dst)) == names and len(names) == 4
    for name in names:
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(dst, name), "rb") as b:
            assert a.read() == b.read(), name


def test_no_port_module_reads_the_jax_package():
    """No module of the port names a path under idiaptts_tpu/ (its
    docstrings may cite the JAX package; the code may not join it into
    a path)."""
    import ast
    root = os.path.join(REPO, "idiaptts_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and any(
                        isinstance(a, ast.Constant) and a.value
                        == "idiaptts_tpu" for a in node.args):
                    pytest.fail("{} joins idiaptts_tpu into a path".format(
                        os.path.join(dirpath, f)))
