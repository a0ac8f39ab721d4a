"""The port's recipes (``idiaptts_torch/egs``) stage by stage on the CPU,
on the repository's six fixture utterances: the LJSpeech recipe's
stages 1-7 with ``--small_models --epochs 1 --device cpu`` and the
intonation recipe's stages 1-6 with ``--epochs 1 --device cpu`` (its
models are small as published).

Against the JAX package: stage 1's features within the bounds of
``test_torch_feature_gen.py`` (the analyses round differently: coded
spectrum 0.2, lf0 1e-4, bap 0.05, vuv equal, statistics' means 5e-3 and
covariances 2e-2), stage 2's question and duration labels byte for byte,
the intonation recipe's wcad atoms (a numpy copy) equal on the same
features.  Every stage completes with finite losses and scores.
"""

import os

import numpy as np
import pytest
import torch

from idiaptts_tpu.data import questions as jax_questions
from idiaptts_tpu.data import wcad as jax_wcad
from idiaptts_tpu.data.phonemes import PhonemeDurationLabelGen as JaxDur
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_torch.egs import intonation_demo, ljspeech_demo, recipe_common

STREAM_TOL = {"mcep20": 0.2, "lf0": 1e-4, "bap": 0.05}
MEAN_TOL, COV_TOL = 5e-3, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lj(tmp_path_factory, fixtures_dir):
    work = str(tmp_path_factory.mktemp("lj"))
    results = ljspeech_demo.main([
        "--work_dir", work, "--fixtures", fixtures_dir, "--small_models",
        "--epochs", "1", "--device", "cpu"])
    return work, results


@pytest.fixture(scope="module")
def into(tmp_path_factory, fixtures_dir):
    work = str(tmp_path_factory.mktemp("into"))
    results = intonation_demo.main([
        "--work_dir", work, "--fixtures", fixtures_dir, "--epochs", "1",
        "--device", "cpu"])
    return work, results


def test_fixture_defaults(fixtures_dir):
    assert os.path.samefile(recipe_common.DEFAULT_FIXTURES, fixtures_dir)
    assert recipe_common.read_ids(fixtures_dir) == [
        "gen-000{}".format(i) for i in range(1, 7)]


def test_lj_runs_stages_1_to_7(lj):
    _, results = lj
    assert sorted(results) == list(range(1, 8))
    for stage in (3, 4):
        losses = results[stage]["val_loss"] + results[stage]["train_loss"]
        assert losses and np.all(np.isfinite(losses))
    assert len(results[5]) == 4 and np.all(np.isfinite(results[5]))
    assert len(results[6]) == 2
    for path in results[6].values():
        assert os.path.getsize(path) > 44
    stats = results[7]["stats"]
    assert stats["requests"] == 6 and stats["batches"] >= 1
    assert len(results[7]["paths"]) == 6


def test_lj_stage1_features_match_jax(lj, fixtures_dir, tmp_path):
    work, _ = lj
    ids = recipe_common.read_ids(fixtures_dir)
    ref = str(tmp_path / "WORLD")
    JaxWorld(dir_labels=ref, add_deltas=True, num_coded_sps=20).gen_data(
        os.path.join(fixtures_dir, "database", "wav"), dir_out=ref,
        id_list=ids)
    got = os.path.join(work, "WORLD")
    for id_name in ids:
        for sub, tol in STREAM_TOL.items():
            with np.load(os.path.join(got, sub, id_name + ".npz")) as p, \
                    np.load(os.path.join(ref, sub, id_name + ".npz")) as j:
                assert sorted(p.files) == sorted(j.files)
                for k in p.files:
                    assert np.abs(p[k] - j[k]).max() < tol, (sub, k)
        with np.load(os.path.join(got, "vuv", id_name + ".npz")) as p, \
                np.load(os.path.join(ref, "vuv", id_name + ".npz")) as j:
            np.testing.assert_array_equal(p["vuv"], j["vuv"])
    for stream in ("mcep20", "lf0", "bap"):
        path = os.path.join("cmp_mcep20", stream + "-mean-covariance.npz")
        with np.load(os.path.join(got, path)) as p, \
                np.load(os.path.join(ref, path)) as j:
            assert np.abs(p["mean"] - j["mean"]).max() < MEAN_TOL
            assert np.abs(p["covariance"] - j["covariance"]).max() < COV_TOL


def test_lj_stage2_labels_match_jax(lj, fixtures_dir, tmp_path,
                                    monkeypatch):
    work, _ = lj
    ids = recipe_common.read_ids(fixtures_dir)
    labels = os.path.join(fixtures_dir, "labels", "label_state_align")
    monkeypatch.setattr(jax_questions.QuestionSet, "native",
                        lambda self: None)
    jax_questions.QuestionLabelGen.gen_data(
        labels, recipe_common.question_file(fixtures_dir),
        dir_out=str(tmp_path / "questions"), id_list=ids)
    JaxDur.gen_data(labels, dir_out=str(tmp_path / "dur"), id_list=ids)
    for sub, ext in (("questions", ".questions"), ("dur", ".dur")):
        for id_name in ids:
            with open(os.path.join(work, sub, id_name + ext), "rb") as a, \
                    open(tmp_path / sub / (id_name + ext), "rb") as b:
                assert a.read() == b.read(), (sub, id_name)


def test_lj_stage_resume(lj, fixtures_dir):
    """``--stage 5 --stop_stage 5`` on the trained work dir: the same
    scores again."""
    work, results = lj
    again = ljspeech_demo.main([
        "--work_dir", work, "--fixtures", fixtures_dir, "--small_models",
        "--stage", "5", "--stop_stage", "5", "--device", "cpu"])
    np.testing.assert_allclose(again[5], results[5], rtol=1e-6)
    with pytest.raises(SystemExit):
        ljspeech_demo.main(["--work_dir", work, "--stage", "9",
                            "--device", "cpu"])


def test_recipes_default_to_the_card(tmp_path, fixtures_dir):
    for mod in (ljspeech_demo, intonation_demo):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["--work_dir", str(tmp_path / mod.__name__),
                      "--fixtures", fixtures_dir, "--stop_stage", "1"])


def test_intonation_runs_stages_1_to_6(into):
    _, results = into
    assert sorted(results) == list(range(1, 7))
    for stage in (4, 5, 6):
        assert np.all(np.isfinite(results[stage]["scores"])), stage
    assert len(results[4]["figures"]) == 2


def test_intonation_atoms_match_jax(into, fixtures_dir, tmp_path):
    """Stage 3 against the JAX wcad on the recipe's own WORLD features."""
    work, _ = into
    ids = recipe_common.read_ids(fixtures_dir)
    jax_wcad.gen_data(os.path.join(work, "WORLD"), intonation_demo.THETAS,
                      str(tmp_path), ids, min_amp=0.08,
                      file_id_list_name="file_id_list")
    got_dir = intonation_demo._atom_dir(
        type("A", (), {"work_dir": work})())
    names = sorted(os.listdir(tmp_path))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(tmp_path, name)
        if name.endswith(".npz"):
            with np.load(a) as p, np.load(b) as j:
                assert sorted(p.files) == sorted(j.files)
                for k in p.files:
                    np.testing.assert_array_equal(p[k], j[k])
        else:
            with open(a, "rb") as p, open(b, "rb") as j:
                assert p.read() == j.read(), name
