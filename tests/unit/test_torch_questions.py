"""Question generation of the port against the JAX package's: question
matching (``QuestionSet``), state- and phone-aligned frame expansion
with every subphone variant (``HTSLabelNormalisation``), and
``QuestionLabelGen.gen_data`` with its min-max statistics, on every
fixture label.  This is numpy code, so the tolerance is none: the same
float32 arrays, bit for bit.

The JAX side runs its Python matcher (``QuestionSet.native`` patched to
None), which keeps these tests from building the JAX bridge's library
in ``native/``; its answers are the truth that both native matchers are
held to.
"""

import glob
import os
import random
import zipfile

import numpy as np
import pytest

from idiaptts_tpu.data import questions as jax_questions
from idiaptts_torch.data import native_questions
from idiaptts_torch.data import questions as torch_questions

STATE_LABELS = ("gen-0001", "gen-0002", "gen-0003", "gen-0004", "gen-0005",
                "gen-0006", "gen48-0001", "gen48-0002")
STATE_VARIANTS = ("full", "state_only", "frame_only", "uniform_state",
                  "minimal_frame", "coarse_coding", "none")
PHONE_VARIANTS = ("minimal_phoneme", "coarse_coding", "none")


@pytest.fixture(autouse=True)
def jax_python_matcher(monkeypatch):
    monkeypatch.setattr(jax_questions.QuestionSet, "native",
                        lambda self: None)


@pytest.fixture(scope="module")
def label_dir(fixtures_dir):
    return os.path.join(fixtures_dir, "labels", "label_state_align")


@pytest.fixture(scope="module")
def sets(question_file):
    return (jax_questions.QuestionSet(question_file),
            torch_questions.QuestionSet(question_file))


def _phone_labels(label_dir, ids=STATE_LABELS):
    labels = []
    for id_name in ids:
        labels += [p[0] for p in jax_questions._parse_state_label(
            os.path.join(label_dir, id_name + ".lab"))]
    return labels


@pytest.mark.parametrize("pattern, numbers", [
    ("*-sil+*", False), ("a-*", False), ("*+b", False), ("x", False),
    ("*/A:(\\d+)_*", True), ("*/J:([\\d.]+)+*", True), ("*^p-*", False),
    ("*=o@*", False)])
def test_wildcards2regex_matches_jax(pattern, numbers):
    assert torch_questions.wildcards2regex(pattern, numbers) \
        == jax_questions.wildcards2regex(pattern, numbers)


@pytest.mark.parametrize("id_name", STATE_LABELS)
def test_question_set_matches_every_phone(sets, label_dir, id_name):
    """Every phone of the fixture label: the port's Python matcher, its
    native matcher and the JAX Python matcher give the same answers."""
    jax_set, port_set = sets
    assert port_set.dict_size == jax_set.dict_size
    assert port_set.raw_binary == jax_set.raw_binary
    assert port_set.raw_continuous == jax_set.raw_continuous
    native = port_set.native()
    assert native is not None
    labels = _phone_labels(label_dir, (id_name,))
    assert labels
    for label in labels:
        ref = jax_set.match(label)
        np.testing.assert_array_equal(port_set.match(label), ref,
                                      err_msg=label)
        np.testing.assert_array_equal(native.match(label), ref,
                                      err_msg=label)


@pytest.mark.parametrize("variant", STATE_VARIANTS)
@pytest.mark.parametrize("use_native", (True, False))
def test_state_alignment_matches_jax(question_file, label_dir, variant,
                                     use_native):
    for id_name in STATE_LABELS:
        path = os.path.join(label_dir, id_name + ".lab")
        if variant == "none":
            kwargs = dict(add_frame_features=False, subphone_feats="none")
        else:
            kwargs = dict(subphone_feats=variant)
        ref = jax_questions.HTSLabelNormalisation(
            question_file, **kwargs).load_labels_with_state_alignment(path)
        got = torch_questions.HTSLabelNormalisation(
            question_file, use_native=use_native,
            **kwargs).load_labels_with_state_alignment(path)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=id_name)


def test_phone_variant_of_state_alignment_raises(question_file, label_dir):
    """minimal_phoneme is a phone-alignment feature set; both packages
    refuse it for state-aligned labels."""
    path = os.path.join(label_dir, "gen-0001.lab")
    for module in (jax_questions, torch_questions):
        with pytest.raises(ValueError, match="minimal_phoneme"):
            module.HTSLabelNormalisation(
                question_file, subphone_feats="minimal_phoneme"
            ).load_labels_with_state_alignment(path)


def _phone_aligned(label_dir, id_name, out_dir, timed=True):
    """The fixture's state timings merged per phone (one line a phone),
    with or without the timings."""
    phones = []
    with open(os.path.join(label_dir, id_name + ".lab")) as f:
        for line in f:
            parts = line.split()
            start, end, label = int(parts[0]), int(parts[1]), parts[2]
            if int(label[-2]) == 2:
                phones.append([start, end, label[:-3]])
            else:
                phones[-1][1] = end
    path = os.path.join(str(out_dir), id_name + ".lab")
    with open(path, "w") as f:
        for start, end, label in phones:
            f.write("{} {} {}\n".format(start, end, label) if timed
                    else label + "\n")
    return path, len(phones)


@pytest.mark.parametrize("variant", PHONE_VARIANTS)
@pytest.mark.parametrize("timed", (True, False))
def test_phone_alignment_matches_jax(question_file, label_dir, tmp_path,
                                     variant, timed):
    """Phone-aligned labels, from their timings or (label-only lines) from
    an explicit durations sequence."""
    for id_name in STATE_LABELS[:3] + STATE_LABELS[-1:]:
        path, num_phones = _phone_aligned(label_dir, id_name, tmp_path,
                                          timed)
        durations = None if timed else \
            list(np.random.RandomState(3).randint(1, 9, num_phones))
        ref = jax_questions.HTSLabelNormalisation(
            question_file, subphone_feats=variant
        ).load_labels_with_phone_alignment(path, durations=durations)
        got = torch_questions.HTSLabelNormalisation(
            question_file, subphone_feats=variant
        ).load_labels_with_phone_alignment(path, durations=durations)
        np.testing.assert_array_equal(got, ref, err_msg=id_name)
    with pytest.raises(ValueError):
        torch_questions.HTSLabelNormalisation(
            question_file, subphone_feats="full"
        ).load_labels_with_phone_alignment(path)


@pytest.mark.parametrize("phone_dur", (1, 2, 7, 33, 200))
def test_coarse_coding_matches_jax(phone_dur):
    np.testing.assert_array_equal(
        torch_questions.HTSLabelNormalisation._coarse_coding(phone_dur),
        jax_questions.HTSLabelNormalisation._coarse_coding(phone_dur))


def _npz_members(path):
    """{member name: bytes} of an npz archive: the .npy payloads, which
    carry dtype, shape and data (the zip's own timestamps aside)."""
    with zipfile.ZipFile(path) as archive:
        return {name: archive.read(name) for name in archive.namelist()}


def test_gen_data_matches_jax(question_file, label_dir, id_list, tmp_path):
    """gen_data on the fixture labels with questions-gen_dnn.hed: the
    returned label dict and statistics are equal, the written
    ``.questions`` files are byte-equal, and so is every array in the
    min-max statistics archive."""
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    dict_j, min_j, max_j = jax_questions.QuestionLabelGen.gen_data(
        label_dir, question_file, dir_out=out_j, id_list=id_list,
        return_dict=True)
    dict_t, min_t, max_t = torch_questions.QuestionLabelGen.gen_data(
        label_dir, question_file, dir_out=out_t, id_list=id_list,
        return_dict=True)
    assert sorted(dict_t) == sorted(dict_j) == sorted(id_list)
    for id_name in id_list:
        np.testing.assert_array_equal(dict_t[id_name], dict_j[id_name])
        with open(os.path.join(out_j, id_name + ".questions"), "rb") as a, \
                open(os.path.join(out_t, id_name + ".questions"),
                     "rb") as b:
            assert a.read() == b.read()
    np.testing.assert_array_equal(min_t, min_j)
    np.testing.assert_array_equal(max_t, max_j)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    assert _npz_members(os.path.join(out_t, "all-min-max.npz")) \
        == _npz_members(os.path.join(out_j, "all-min-max.npz"))
    # The fixture corpus' committed questions are what gen_data writes.
    for id_name in id_list:
        committed = np.fromfile(os.path.join(
            os.path.dirname(os.path.dirname(label_dir)), "questions",
            id_name + ".questions"), np.float32)
        np.testing.assert_array_equal(dict_t[id_name].ravel(), committed)


def test_gen_data_without_an_id_list_globs_the_labels(question_file,
                                                       label_dir):
    vmin_j, vmax_j = jax_questions.QuestionLabelGen.gen_data(
        label_dir, question_file)
    vmin, vmax = torch_questions.QuestionLabelGen.gen_data(
        label_dir, question_file)
    np.testing.assert_array_equal(vmin, vmin_j)
    np.testing.assert_array_equal(vmax, vmax_j)


def test_generated_questions_read_back_normalised(question_file, label_dir,
                                                  id_list, num_questions,
                                                  tmp_path):
    """The port's reader takes gen_data's output with its statistics and
    normalises it as the JAX reader does."""
    out = str(tmp_path)
    torch_questions.QuestionLabelGen.gen_data(label_dir, question_file,
                                              dir_out=out, id_list=id_list)
    readers = [cls.Config(name="questions", directory=out,
                          num_questions=num_questions).create_reader()
               for cls in (jax_questions.QuestionLabelGen,
                           torch_questions.QuestionLabelGen)]
    for id_name in id_list[:2]:
        np.testing.assert_array_equal(readers[1][id_name]["questions"],
                                      readers[0][id_name]["questions"])


def test_native_matcher_agrees_on_fuzzed_labels(sets):
    """Random HTS-style labels (mutated phones, numbers, junk fields):
    the port's native matcher, its Python matcher and JAX's agree."""
    jax_set, port_set = sets
    native = port_set.native()
    rng = random.Random(11)
    phones = ["p", "r", "ih", "n", "t", "sil", "pau", "ax", "jh", "zh",
              "xx", "oy", "eh", "w", "#", "a", "@"]

    def field():
        return rng.choice([rng.choice(phones), str(rng.randint(0, 40)),
                           "content", "0", "x" * rng.randint(0, 3)])

    for _ in range(300):
        label = "{}~{}-{}+{}={}:{}_{}/A/{}_{}_{}/B/{}-{}/J/{}+{}-{}".format(
            *[field() for _ in range(15)])
        if rng.random() < 0.5:
            label = label.replace("/", rng.choice(["/", "|", "$"]))
        ref = jax_set.match(label)
        np.testing.assert_array_equal(port_set.match(label), ref,
                                      err_msg=label)
        np.testing.assert_array_equal(native.match(label), ref,
                                      err_msg=label)
    batch = native.match_many(["a", "b", "sil"])
    assert batch.shape == (3, port_set.dict_size)


def test_native_library_lands_in_the_port_build_dir(sets):
    """The port's matcher library is built under idiaptts_torch/_build/
    (which .gitignore lists), named by the source's hash, and counts its
    matches."""
    _, port_set = sets
    native = port_set.native()
    path = native_questions.lib_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(native_questions.__file__)))),
        "idiaptts_torch", "_build")
    assert native_questions.SRC.endswith(
        os.path.join("native", "question_matcher.cpp"))
    before = native_questions.matches
    native.match("xx~xx-sil+l=a:1_8/A/c_silence/B/1-2/J/8+3-1")
    assert native_questions.matches == before + 1
    assert native.lib._name == path
    assert not glob.glob(os.path.join(os.path.dirname(
        native_questions.SRC), "libquestion_matcher_*.so"))


def test_phoneme_index_helpers_match_jax(label_dir, question_file):
    """questions_to_phoneme_indices / _per_frame / questions_to_phonemes
    and get_HTK_label_timings_ms."""
    frames = torch_questions.HTSLabelNormalisation(
        question_file).load_labels_with_state_alignment(
        os.path.join(label_dir, "gen-0001.lab"))
    indices = [3, 5, 8, 13, 21]
    names = ["a", "b", "c", "d", "e"]
    for fn, args in (("questions_to_phoneme_indices", (indices,)),
                     ("questions_to_phoneme_per_frame", (indices, names))):
        np.testing.assert_array_equal(
            getattr(torch_questions.QuestionLabelGen, fn)(frames, *args),
            getattr(jax_questions.QuestionLabelGen, fn)(frames, *args))
    assert torch_questions.QuestionLabelGen.questions_to_phonemes(
        frames, indices, names) == \
        jax_questions.QuestionLabelGen.questions_to_phonemes(
            frames, indices, names)
    line = "350000 650000 xx~xx-sil+l=a[3]"
    assert torch_questions.QuestionLabelGen.get_HTK_label_timings_ms(line) \
        == jax_questions.QuestionLabelGen.get_HTK_label_timings_ms(line)
