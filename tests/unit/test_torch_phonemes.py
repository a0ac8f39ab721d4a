"""The port's TextGrid reader and phoneme label generators against the
JAX package's, on the committed fixture labels: ``read_textgrid`` on
every TextGrid, ``PhonemeLabelGen`` on every label type it reads,
``PhonemeDurationLabelGen`` loading and ``gen_data`` with its
statistics.  Host numpy code: every array must be equal, with no
tolerance.
"""

import os
import zipfile

import numpy as np
import pytest

from idiaptts_tpu.data import phonemes as jax_phonemes
from idiaptts_tpu.data import textgrid as jax_textgrid
from idiaptts_torch.data import phonemes as torch_phonemes
from idiaptts_torch.data import textgrid as torch_textgrid

ALL_IDS = ("gen-0001", "gen-0002", "gen-0003", "gen-0004", "gen-0005",
           "gen-0006", "gen48-0001", "gen48-0002")
# label type -> the fixture directory it reads
LABEL_TYPES = {"mono_no_align": "mono_no_align",
               "full_state_align": "label_state_align",
               "HTK full": "full",
               "mfa": "mfa"}


def _labels(fixtures_dir, sub):
    return os.path.join(fixtures_dir, "labels", sub)


@pytest.mark.parametrize("id_name", ALL_IDS)
def test_read_textgrid_matches_jax(fixtures_dir, id_name):
    path = os.path.join(_labels(fixtures_dir, "mfa"), id_name + ".TextGrid")
    ref = jax_textgrid.read_textgrid(path)
    got = torch_textgrid.read_textgrid(path)
    assert (got.minTime, got.maxTime) == (ref.minTime, ref.maxTime)
    assert [t.name for t in got] == [t.name for t in ref]
    for tier_g, tier_r in zip(got, ref):
        assert tier_g.tier_class == tier_r.tier_class
        assert [tuple(e) for e in tier_g] == [tuple(e) for e in tier_r]


def test_read_textgrid_short_form_and_point_tier(tmp_path):
    """The short form, doubled-quote escapes and a TextTier."""
    path = tmp_path / "short.TextGrid"
    path.write_text("\n".join([
        '"ooTextFile"', '"TextGrid"', "0", "1.5", "<exists>", "2",
        '"IntervalTier"', '"phones"', "0", "1.5", "2",
        "0", "0.5", '"say ""hi"""', "0.5", "1.5", '"B"',
        '"TextTier"', '"marks"', "0", "1.5", "1", "0.7", '"m"']))
    ref = jax_textgrid.read_textgrid(str(path))
    got = torch_textgrid.read_textgrid(str(path))
    for name in ("phones", "marks"):
        assert [tuple(e) for e in got.get_tier(name)] \
            == [tuple(e) for e in ref.get_tier(name)]


def _phoneme_reader(module, fixtures_dir, label_type, **kwargs):
    return module.PhonemeLabelGen.Config(
        name="phonemes",
        directory=_labels(fixtures_dir, LABEL_TYPES[label_type]),
        file_symbol_dict=_labels(fixtures_dir, "mono_phone.list"),
        label_type=label_type, **kwargs).create_reader()


@pytest.mark.parametrize("label_type", sorted(LABEL_TYPES))
@pytest.mark.parametrize("one_hot, add_eof", [(False, False), (True, True),
                                              (False, True)])
def test_phoneme_label_gen_matches_jax(fixtures_dir, label_type, one_hot,
                                       add_eof):
    """load, the reader's preprocessed sample (ids or one-hot, with or
    without EOF) and postprocess_sample back to ids."""
    kwargs = dict(one_hot=one_hot, add_EOF=add_eof)
    ref_reader = _phoneme_reader(jax_phonemes, fixtures_dir, label_type,
                                 **kwargs)
    reader = _phoneme_reader(torch_phonemes, fixtures_dir, label_type,
                             **kwargs)
    assert reader.symbol_dict == ref_reader.symbol_dict
    assert reader.num_symbols == ref_reader.num_symbols
    for id_name in ALL_IDS:
        ref = ref_reader[id_name]["phonemes"]
        got = reader[id_name]["phonemes"]
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=id_name)
        np.testing.assert_array_equal(reader.postprocess_sample(got),
                                      ref_reader.postprocess_sample(ref))


def test_state_aligned_phonemes_count_the_durations(fixtures_dir):
    reader = _phoneme_reader(torch_phonemes, fixtures_dir,
                             "full_state_align")
    for id_name in ALL_IDS:
        dur = torch_phonemes.PhonemeDurationLabelGen.load_sample(
            id_name, os.path.join(fixtures_dir, "dur"))
        assert len(reader.load(id_name)) == len(dur)


@pytest.mark.parametrize("source, label_type", [
    ("dur", "full_state_align"), ("label_state_align", "full_state_align"),
    ("mfa", "mfa")])
def test_duration_load_matches_jax(fixtures_dir, source, label_type):
    """Durations from the ``.dur`` files, from the state-aligned labels
    and from the TextGrids."""
    directory = os.path.join(fixtures_dir, "dur") if source == "dur" \
        else _labels(fixtures_dir, source)
    for id_name in ALL_IDS:
        ref = jax_phonemes.PhonemeDurationLabelGen.load_sample(
            id_name, directory, label_type=label_type)
        got = torch_phonemes.PhonemeDurationLabelGen.load_sample(
            id_name, directory, label_type=label_type)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=id_name)


def test_duration_reader_normalises_and_builds_attention(fixtures_dir,
                                                         tmp_path):
    """The reader with mean/std-dev statistics written by gen_data, and
    with ``load_as_matrix`` (the hard-attention matrix)."""
    dur_dir = os.path.join(fixtures_dir, "dur")
    stats = str(tmp_path)
    torch_phonemes.PhonemeDurationLabelGen.gen_data(
        _labels(fixtures_dir, "label_state_align"), dir_out=stats,
        id_list=list(ALL_IDS))
    for kwargs in (dict(norm_params_path=os.path.join(
                            stats, "all-mean-std_dev.npz")),
                   dict(load_as_matrix=True)):
        readers = [m.PhonemeDurationLabelGen.Config(
            name="durations", directory=dur_dir, **kwargs).create_reader()
            for m in (jax_phonemes, torch_phonemes)]
        for id_name in ALL_IDS[:3]:
            ref = readers[0][id_name]["durations"]
            got = readers[1][id_name]["durations"]
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                readers[1].postprocess_sample(got),
                readers[0].postprocess_sample(ref))


@pytest.mark.parametrize("seed", range(4))
def test_hard_attention_matrix_matches_jax(seed):
    durations = np.random.RandomState(seed).randint(0, 9, 5 + 7 * seed)
    got = torch_phonemes.PhonemeDurationLabelGen \
        .durations_to_hard_attention_matrix(durations)
    ref = jax_phonemes.PhonemeDurationLabelGen \
        .durations_to_hard_attention_matrix(durations)
    assert got.shape == (durations.sum(), len(durations))
    np.testing.assert_array_equal(got, ref)


def _npz_arrays(path):
    with zipfile.ZipFile(path) as archive:
        return {name: archive.read(name) for name in archive.namelist()}


@pytest.mark.parametrize("label_type", ("full_state_align", "mfa"))
def test_duration_gen_data_matches_jax(fixtures_dir, tmp_path, label_type):
    """gen_data: the label dict, mean and std-dev, the ``.dur`` files
    byte for byte, and the arrays of the statistics archives
    (``all-stats.npz`` and ``all-mean-std_dev.npz``) byte for byte."""
    src = _labels(fixtures_dir, "mfa" if label_type == "mfa"
                  else "label_state_align")
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    dict_j, mean_j, std_j = jax_phonemes.PhonemeDurationLabelGen.gen_data(
        src, dir_out=out_j, id_list=list(ALL_IDS), label_type=label_type,
        return_dict=True)
    dict_t, mean_t, std_t = torch_phonemes.PhonemeDurationLabelGen.gen_data(
        src, dir_out=out_t, id_list=list(ALL_IDS), label_type=label_type,
        return_dict=True)
    np.testing.assert_array_equal(mean_t, mean_j)
    np.testing.assert_array_equal(std_t, std_j)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in os.listdir(out_j):
        if name.endswith(".npz"):
            assert _npz_arrays(os.path.join(out_t, name)) \
                == _npz_arrays(os.path.join(out_j, name)), name
        else:
            with open(os.path.join(out_t, name), "rb") as a, \
                    open(os.path.join(out_j, name), "rb") as b:
                assert a.read() == b.read(), name
    for id_name in ALL_IDS:
        np.testing.assert_array_equal(dict_t[id_name], dict_j[id_name])
    # Without an id list the labels are globbed.
    mean_g, std_g = torch_phonemes.PhonemeDurationLabelGen.gen_data(
        src, label_type=label_type)
    np.testing.assert_array_equal(mean_g, mean_j)
    np.testing.assert_array_equal(std_g, std_j)


@pytest.mark.parametrize("cls, archives", [
    ("MeanStdDevExtractor", ("stats", "mean-std_dev")),
    ("MinMaxExtractor", ("min-max",))])
def test_extractors_match_jax(tmp_path, cls, archives):
    """The accumulating half of normalisation on seeded samples:
    add_sample, get_params, and the arrays of the saved archives byte
    for byte, which load back equal."""
    from idiaptts_tpu.data import normalisation as jax_norm
    from idiaptts_torch.data import normalisation as torch_norm
    rs = np.random.RandomState(5)
    samples = [rs.randn(int(n), 7).astype(np.float32) * 3 + 1
               for n in rs.randint(1, 40, 6)]
    ref, got = getattr(jax_norm, cls)(), getattr(torch_norm, cls)()
    for sample in samples:
        ref.add_sample(sample)
        got.add_sample(sample)
    for r, g in zip(ref.get_params(), got.get_params()):
        np.testing.assert_array_equal(g, r)
    ref.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "port"))
    for name in archives:
        path_j = str(tmp_path / "jax-{}.npz".format(name))
        path_t = str(tmp_path / "port-{}.npz".format(name))
        assert _npz_arrays(path_t) == _npz_arrays(path_j)
        if name != "stats":
            for r, g in zip(getattr(jax_norm, cls).load(path_j),
                            getattr(torch_norm, cls).load(path_t)):
                np.testing.assert_array_equal(g, r)
