"""Parity of the port's corpus feature generation with the JAX
package's: ``WorldFeatLabelGen.gen_data`` and ``import_corpus``, the
statistics' accumulation and subset combination, ``LF0LabelGen`` /
``FlatLF0LabelGen``, the 48 kHz extraction round trip, and a small
acoustic model trained on the port's own extracted corpus.

``import_corpus`` takes identical features on both sides, so its npz
files and statistics are compared bit for bit (each archive member's
bytes: the zip entries' timestamps differ).  ``gen_data`` extracts on
both sides, so the features carry the analysis's differences
(``test_torch_world_analysis.py``); measured on the CPU on the six
16 kHz wavs: coded spectrum (statics and deltas) max 0.033, lf0
1.6e-6, bap 4.6e-3, the statistics' means 2.6e-4 and covariances
1.8e-3 absolute.  Bounds: 0.2, 1e-4, 0.05, 5e-3 and 2e-2; vuv is equal.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from idiaptts_tpu.data.lf0 import FlatLF0LabelGen as JaxFlatLF0
from idiaptts_tpu.data.lf0 import LF0LabelGen as JaxLF0
from idiaptts_tpu.data.normalisation import (
    MeanCovarianceExtractor as JaxCov, MeanStdDevExtractor as JaxStd,
    MinMaxExtractor as JaxMinMax)
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_tpu.ops import interpolation as jax_interpolation
from idiaptts_torch.data.lf0 import FlatLF0LabelGen, LF0LabelGen
from idiaptts_torch.data.normalisation import (MeanCovarianceExtractor,
                                               MeanStdDevExtractor,
                                               MinMaxExtractor)
from idiaptts_torch.data.world_feat import WorldFeatLabelGen, main
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import rnn_dyn
from idiaptts_torch.ops import interpolation
from idiaptts_torch.ops.world.extract import world_analysis
from idiaptts_torch.train.acoustic import AcousticModelTrainer

NUM_SPS = 20
IDS = tuple("gen-000{}".format(i) for i in range(1, 7))
STREAM_TOL = {"mcep20": 0.2, "lf0": 1e-4, "bap": 0.05}
MEAN_TOL, COV_TOL = 5e-3, 2e-2
SMALL_MODEL = "RNNDYN-2_RELU_128-1_BiLSTM_64-1_FC_67"



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    faster when the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _wav_dir(fixtures_dir, sub="wav"):
    return os.path.join(fixtures_dir, "database", sub)


@pytest.fixture(scope="module")
def corpora(fixtures_dir, tmp_path_factory):
    """gen_data of the six 16 kHz wavs, 20 mcep with deltas, by both
    packages: (port dir, JAX dir, port dict, JAX dict)."""
    root = tmp_path_factory.mktemp("gen")
    out = []
    for name, cls, kw in (("port", WorldFeatLabelGen, {"device": "cpu"}),
                          ("jax", JaxWorld, {})):
        d = str(root / name)
        gen = cls(dir_labels=d, add_deltas=True, num_coded_sps=NUM_SPS,
                  **kw)
        labels, _ = gen.gen_data(_wav_dir(fixtures_dir), dir_out=d,
                                 id_list=list(IDS), return_dict=True)
        out += [d, labels]
    return out[0], out[2], out[1], out[3]


def _members(path):
    """{member: bytes} of an npz archive (the .npy payloads)."""
    with zipfile.ZipFile(path) as archive:
        return {n: archive.read(n) for n in archive.namelist()}


def _files(directory):
    return sorted(os.path.relpath(os.path.join(r, f), directory)
                  for r, _, fs in os.walk(directory) for f in fs)


def test_gen_data_matches_jax(corpora):
    port_dir, jax_dir, port_dict, jax_dict = corpora
    assert _files(port_dir) == _files(jax_dir)
    assert len(_files(port_dir)) == 4 * len(IDS) + 6
    for id_name in IDS:
        assert port_dict[id_name].shape == jax_dict[id_name].shape
        for sub, key in (("mcep20", "mcep"), ("lf0", "lf0"), ("bap", "bap")):
            with np.load(os.path.join(port_dir, sub, id_name + ".npz")) as p, \
                    np.load(os.path.join(jax_dir, sub,
                                         id_name + ".npz")) as j:
                assert sorted(p.files) == sorted(j.files) == sorted(
                    [key, key + "_deltas", key + "_double_deltas"])
                for k in p.files:
                    assert p[k].dtype == j[k].dtype == np.float32
                    assert np.abs(p[k] - j[k]).max() < STREAM_TOL[sub], \
                        (sub, k)
        with np.load(os.path.join(port_dir, "vuv", id_name + ".npz")) as p, \
                np.load(os.path.join(jax_dir, "vuv", id_name + ".npz")) as j:
            np.testing.assert_array_equal(p["vuv"], j["vuv"])
    for stream in ("mcep20", "lf0", "bap"):
        path = os.path.join("cmp_mcep20", stream + "-mean-covariance.npz")
        with np.load(os.path.join(port_dir, path)) as p, \
                np.load(os.path.join(jax_dir, path)) as j:
            assert p["sum_length"] == j["sum_length"]
            assert np.abs(p["mean"] - j["mean"]).max() < MEAN_TOL
            assert np.abs(p["covariance"] - j["covariance"]).max() < COV_TOL


def test_gen_data_without_deltas_matches_jax(fixtures_dir, tmp_path):
    """Mean-std_dev statistics per stream directory, 60 coefficients
    (the default), two utterances listed in a file id list."""
    ids = list(IDS[:2])
    stats = []
    for name, cls, kw in (("port", WorldFeatLabelGen, {"device": "cpu"}),
                          ("jax", JaxWorld, {})):
        d = str(tmp_path / name)
        gen = cls(dir_labels=d, add_deltas=False, **kw)
        mean, std = gen.gen_data(_wav_dir(fixtures_dir), dir_out=d,
                                 file_id_list="lists/train.txt",
                                 id_list=ids)
        stats.append((d, mean, std))
    (port_dir, mean, std), (jax_dir, mean_j, std_j) = stats
    assert _files(port_dir) == _files(jax_dir)
    assert "mcep60/train-mean-std_dev.npz" in _files(port_dir)
    assert np.abs(mean - mean_j).max() < MEAN_TOL
    assert np.abs(std - std_j).max() < MEAN_TOL
    reader = WorldFeatLabelGen(dir_labels=port_dir, device="cpu")
    reader.get_normalisation_params(file_name="train")
    assert reader.load(ids[0]).shape[1] == 60 + 3


def test_import_corpus_is_bit_identical(fixtures_dir, tmp_path):
    """Identical statics in, identical files out: every npz member of
    the features and of the statistics, with and without deltas."""
    feats = {}
    for id_name in IDS[:3]:
        s = WorldFeatLabelGen.load_sample(
            id_name, os.path.join(fixtures_dir, "WORLD"), add_deltas=True,
            num_coded_sps=NUM_SPS)
        feats[id_name] = WorldFeatLabelGen.convert_to_world_features(
            s, contains_deltas=True, num_coded_sps=NUM_SPS)
    for deltas in (True, False):
        dirs = []
        for name, cls, kw in (("port", WorldFeatLabelGen,
                               {"device": "cpu"}), ("jax", JaxWorld, {})):
            d = str(tmp_path / "{}{}".format(name, int(deltas)))
            cls(dir_labels=d, add_deltas=deltas, num_coded_sps=NUM_SPS,
                **kw).import_corpus(feats, d, file_id_list_name="all")
            dirs.append(d)
        files = _files(dirs[0])
        assert files == _files(dirs[1]) and len(files) > 12
        for f in files:
            assert _members(os.path.join(dirs[0], f)) == _members(
                os.path.join(dirs[1], f)), f


def test_extract_features_codings_match_jax(fixtures_dir):
    """extract_features for each coding: mcep and mgc through the
    one-pass analysis, mfbanks and amp_sp through the separate stages."""
    for sp_type, tol in (("mcep", 0.2), ("mgc", 0.2), ("mfbanks", 1.0),
                         ("amp_sp", 5e-3)):
        (c, lf0, vuv, bap), fs = WorldFeatLabelGen.extract_features(
            _wav_dir(fixtures_dir), IDS[0], num_coded_sps=NUM_SPS,
            sp_type=sp_type, device="cpu")
        (c_j, lf0_j, vuv_j, bap_j), fs_j = JaxWorld.extract_features(
            _wav_dir(fixtures_dir), IDS[0], num_coded_sps=NUM_SPS,
            sp_type=sp_type)
        assert fs == fs_j and c.shape == c_j.shape and c.dtype == np.float32
        assert np.abs(c - c_j).max() < tol, (sp_type, np.abs(c - c_j).max())
        np.testing.assert_array_equal(vuv, vuv_j)
        np.testing.assert_allclose(lf0, lf0_j, rtol=0, atol=1e-4)
        assert np.abs(bap - bap_j).max() < 0.05


def test_48khz_round_trip(fixtures_dir):
    """The 48 kHz fixture (5 bap bands, 60 mcep): extraction, decoding
    and resynthesis at the higher rate, as test_world_feat_labelgen.py
    checks the JAX package."""
    from idiaptts_torch.ops.audio_io import get_raw
    from idiaptts_torch.ops.interpolation import interpolate_lin
    raw, fs = get_raw(os.path.join(_wav_dir(fixtures_dir, "wav48"),
                                   "gen48-0001.wav"))
    assert fs == 48000
    f0, coded, bap = world_analysis(raw[:fs * 2], fs, num_coded_sps=60,
                                    device="cpu")
    assert coded.shape[1] == 60 and bap.shape[1] == 5
    assert 0.1 < (f0 > 0).mean() < 0.95
    ip, vuv = interpolate_lin(np.array(f0))
    lf0 = np.log(np.maximum(ip, 1e-10)).astype(np.float32)
    amp = WorldFeatLabelGen.mcep_to_amp_sp(coded, fs, device="cpu")
    np.testing.assert_allclose(
        amp, JaxWorld.mcep_to_amp_sp(coded, fs), rtol=1e-4, atol=1e-12)
    wav = WorldFeatLabelGen.world_features_to_raw(amp, lf0, vuv, bap, fs,
                                                  device="cpu")
    assert len(wav) == len(f0) * int(fs * 0.005)
    assert 0.005 < np.sqrt((wav ** 2).mean()) < 1.0


def test_lf0_readers_match_jax(fixtures_dir, tmp_path):
    world = os.path.join(fixtures_dir, "WORLD")
    # Without deltas the readers load lf0 + vuv statics: write them
    # (and their statistics) with import_corpus from the fixtures.
    flat = str(tmp_path / "flat")
    feats = {i: WorldFeatLabelGen.convert_to_world_features(
        WorldFeatLabelGen.load_sample(i, world, add_deltas=True,
                                      num_coded_sps=NUM_SPS),
        contains_deltas=True, num_coded_sps=NUM_SPS) for i in IDS[:2]}
    WorldFeatLabelGen(dir_labels=flat, num_coded_sps=NUM_SPS,
                      device="cpu").import_corpus(feats, flat)
    phrase_dir = tmp_path / "phrase"
    phrase_dir.mkdir()
    for i in IDS[:2]:
        np.random.RandomState(int(i[-1])).randn(len(feats[i][0])).astype(
            np.float32).tofile(str(phrase_dir / (i + ".phrase")))
    for port_cls, jax_cls, directory, kw in (
            (LF0LabelGen, JaxLF0, world, {"add_deltas": True}),
            (LF0LabelGen, JaxLF0, flat, {}),
            (FlatLF0LabelGen, JaxFlatLF0, flat,
             {"dir_phrase": str(phrase_dir)})):
        port = port_cls.Config("lf0", directory=directory,
                               **kw).create_reader()
        ref = jax_cls.Config("lf0", directory=directory,
                             **kw).create_reader()
        for i in IDS[:2]:
            np.testing.assert_array_equal(port.load(i), ref.load(i))
        if directory == flat:
            for a, b in zip(port.norm_params, ref.norm_params):
                np.testing.assert_array_equal(a, b)


def _tracks():
    """f0-like tracks with leading, interior and trailing gaps, one whose
    only voiced frame is the last, and one with none."""
    rs = np.random.RandomState(4)
    track = 100.0 + 50.0 * rs.rand(40)
    track[:3] = track[10:14] = track[20] = track[36:] = 0.0
    last = np.zeros(9)
    last[-1] = 120.0
    gap_before_last = 100.0 + rs.rand(12)
    gap_before_last[-2] = 0.0
    return [track, last, gap_before_last, np.zeros(5), np.array([0.0, 90.0])]


@pytest.mark.parametrize("index", range(5))
def test_interpolation_matches_jax(index):
    """interpolate_lin, the deltas (numpy and on a tensor) and
    surround_with_norm_dist: the same numpy (and float32 torch)
    arithmetic, so equal results."""
    track = _tracks()[index]
    for a, b in zip(interpolation.interpolate_lin(track),
                    jax_interpolation.interpolate_lin(track)):
        np.testing.assert_array_equal(a, b)
    feats = np.random.RandomState(index).randn(max(len(track), 3), 4)
    np.testing.assert_array_equal(interpolation.add_deltas(feats),
                                  jax_interpolation.add_deltas(feats))
    feats32 = feats.astype(np.float32)
    np.testing.assert_allclose(
        interpolation.compute_deltas_jnp(torch.from_numpy(feats32)).numpy(),
        np.asarray(jax_interpolation.compute_deltas_jnp(feats32)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        interpolation.compute_deltas_jnp(torch.from_numpy(feats32)).numpy(),
        interpolation.compute_deltas(feats32), rtol=0, atol=1e-6)
    atoms = np.zeros((len(track) + 6, 2))
    atoms[::4] = np.random.RandomState(index).randn(len(atoms[::4]), 2)
    for kw in ({}, {"window_size": 8, "std_dev": 2.0, "threshold": 0.1}):
        np.testing.assert_array_equal(
            interpolation.surround_with_norm_dist(atoms, **kw),
            jax_interpolation.surround_with_norm_dist(atoms, **kw))
        np.testing.assert_array_equal(
            interpolation.surround_with_norm_dist(atoms[:, 0], **kw),
            jax_interpolation.surround_with_norm_dist(atoms[:, 0], **kw))


def test_combine_functions_match_jax(tmp_path):
    """combine_stats and combine_min_max over three subsets: the same
    totals and the same files."""
    rs = np.random.RandomState(5)
    subsets = [rs.randn(n, 4) for n in (7, 11, 3)]
    for name, port_cls, jax_cls in (("std", MeanStdDevExtractor, JaxStd),
                                    ("cov", MeanCovarianceExtractor,
                                     JaxCov)):
        paths = []
        for k, x in enumerate(subsets):
            e = port_cls()
            e.add_sample(x)
            prefix = str(tmp_path / "{}{}".format(name, k))
            e.save(prefix)
            paths.append(prefix + "-stats.npz")
        out_p, out_j = tmp_path / (name + "_p"), tmp_path / (name + "_j")
        out_p.mkdir()
        out_j.mkdir()
        total = port_cls.combine_stats(paths, str(out_p))
        total_j = jax_cls.combine_stats(paths, str(out_j))
        for a, b in zip(total.get_params(), total_j.get_params()):
            np.testing.assert_array_equal(a, b)
        whole = port_cls()
        whole.add_sample(np.concatenate(subsets))
        for a, b in zip(total.get_params(), whole.get_params()):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        for f in os.listdir(out_j):
            assert _members(out_p / f) == _members(out_j / f), f
        for path in paths:
            for a, b in zip(port_cls.load_stats(path),
                            jax_cls.load_stats(path)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        MeanStdDevExtractor.load_mean_std_dev_from_stats(paths[0]
                                                         .replace("cov",
                                                                  "std")),
        JaxStd.load_mean_std_dev_from_stats(paths[0].replace("cov", "std")))
    mm = []
    for k, x in enumerate(subsets):
        e = MinMaxExtractor()
        e.add_sample(x)
        e.save(str(tmp_path / "mm{}".format(k)))
        mm.append(str(tmp_path / "mm{}-min-max.npz".format(k)))
    (tmp_path / "mm_p").mkdir()
    (tmp_path / "mm_j").mkdir()
    total = MinMaxExtractor.combine_min_max(mm, str(tmp_path / "mm_p"))
    total_j = JaxMinMax.combine_min_max(mm, str(tmp_path / "mm_j"))
    for a, b in zip(total.get_params(), total_j.get_params()):
        np.testing.assert_array_equal(a, b)
    assert _members(tmp_path / "mm_p" / "min-max.npz") == _members(
        tmp_path / "mm_j" / "min-max.npz")


def test_main_extracts_a_corpus(fixtures_dir, tmp_path):
    """The command line entry point (``python -m
    idiaptts_torch.data.world_feat``) on one wav."""
    ids = tmp_path / "ids.txt"
    ids.write_text(IDS[0] + "\n")
    main(["-a", _wav_dir(fixtures_dir), "-o", str(tmp_path / "out"),
          "-i", str(ids), "--num_coded_sps", "20", "--add_deltas",
          "--device", "cpu"])
    assert sorted(_files(str(tmp_path / "out"))) == sorted(
        ["bap/gen-0001.npz", "lf0/gen-0001.npz", "mcep20/gen-0001.npz",
         "vuv/gen-0001.npz"] + ["cmp_mcep20/ids-{}-{}.npz".format(s, k)
                                for s in ("mcep20", "lf0", "bap")
                                for k in ("stats", "mean-covariance")])


def test_small_model_trains_on_the_extracted_corpus(corpora, fixtures_dir,
                                                    num_questions,
                                                    tmp_path):
    """The quality-pin recipe's model (its learning rate and batch size)
    trained four epochs on the port's own gen_data output (features and
    statistics): the losses are finite and the validation loss falls at
    every epoch (measured 1.1001 -> 1.0182; the training loss of two
    steps an epoch wanders, 0.9335 / 0.9264 / 0.8985 / 0.9480, as it
    does on the committed fixture features)."""
    port_dir = corpora[0]
    hp = ExtendedHParams.create_hparams()
    hp.add_hparams(num_questions=num_questions)
    hp.setattr_no_type_check("add_deltas", True)
    hp.num_coded_sps = NUM_SPS
    hp.device = "cpu"
    hp.seed = 1
    hp.out_dir = str(tmp_path)
    hp.model_name = "extracted"
    hp.epochs = 4
    hp.batch_size_train = 2
    hp.batch_size_val = 6
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.learning_rate = 0.002
    trainer = AcousticModelTrainer(
        hp, list(IDS),
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=port_dir)
    cfg = rnn_dyn.convert_legacy_string(SMALL_MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    torch.manual_seed(1)
    trainer.init(hp, model_config=cfg)
    val_loss, train_loss = trainer.train(hp)
    assert np.all(np.isfinite(train_loss)) and np.all(np.isfinite(val_loss))
    assert len(val_loss) == hp.epochs + 1
    assert np.all(np.diff(val_loss) < 0), val_loss
