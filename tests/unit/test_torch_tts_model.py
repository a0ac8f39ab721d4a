"""The text front door as a whole on the CPU: the port's
``TTSModel.run_DM_AM`` and ``TextToSpeechServer`` against the JAX
package's, with the recipe of tests/integration/test_tts_model.py
(``test_run_dm_am``): the default duration model trained two epochs and
``RNNDYN-1_RELU_64-1_FC_67`` one epoch, both by the JAX package, their
flax weights converted into the port's trainers.

What must agree:
- the durations, within the bf16 band of test_torch_duration.py (a
  rounded state may differ only next to a .5 boundary);
- the aligned label files, line for line where the durations agree, and
  the frame questions, bit for bit on the same aligned labels;
- the waveforms by 5 ms frame energy (ROADMAP fault 3.5): the modular
  synth with the original spectrum and voicing, so that they are loud,
  and the port's vocoder fed the JAX noise draw.
"""

import os

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.data import questions as jax_questions
from idiaptts_tpu.data.normalisation import MinMaxExtractor
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.synth.tts_model import TTSModel as JaxTTSModel
from idiaptts_tpu.train.acoustic import \
    AcousticModelTrainer as JaxAcousticModelTrainer
from idiaptts_tpu.train.duration import \
    DurationModelTrainer as JaxDurationModelTrainer
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.ops import audio_io
from idiaptts_torch.synth import tts_model
from idiaptts_torch.synth.pipeline import BatchedWorldSynth
from idiaptts_torch.synth.tts_model import TextToSpeechServer, TTSModel
from idiaptts_torch.train.acoustic import AcousticModelTrainer
from idiaptts_torch.train.duration import DurationModelTrainer

BF16_BAND = 2.0 ** -7
AM_MODEL = "RNNDYN-1_RELU_64-1_FC_67"
TEXTS = ("hello world", "testing speech", "a stitch in time")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    about twice as fast as eight, and far faster when the suite's
    parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def jax_python_matcher(monkeypatch):
    """The JAX side uses its Python matcher (identical answers; no build
    of the JAX bridge's library in native/)."""
    monkeypatch.setattr(jax_questions.QuestionSet, "native",
                        lambda self: None)


def _dur_hparams(cls, num_questions, out_dir):
    hp = cls.create_hparams()
    hp.num_questions = num_questions - 9
    hp.out_dir = str(out_dir)
    hp.model_name = "dm"
    hp.epochs = 2
    hp.batch_size_train = 4
    hp.learning_rate = 0.002
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.2
    hp.use_best_as_final_model = False
    if cls is DurationModelTrainer:
        hp.device = "cpu"
    return hp


def _am_hparams(cls, num_questions, out_dir):
    hp = cls.create_hparams()
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.out_dir = str(out_dir)
    hp.model_name = "am"
    hp.epochs = 1
    hp.batch_size_train = 3
    hp.learning_rate = 0.001
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.2
    hp.use_best_as_final_model = False
    hp.synth_fs = 16000
    if cls is AcousticModelTrainer:
        hp.device = "cpu"
    return hp


def _weights(trainer):
    return jax.tree_util.tree_map(np.asarray, trainer.model_handler.params)


@pytest.fixture(scope="module")
def recipe(fixtures_dir, id_list, question_file, num_questions,
           tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tts")
    label_dir = os.path.join(fixtures_dir, "labels", "label_state_align")
    dur_q_dir = str(tmp / "dur_questions")
    os.makedirs(dur_q_dir)
    operator = jax_questions.HTSLabelNormalisation(
        question_file, add_frame_features=False, subphone_feats="none",
        use_native=False)
    extractor = MinMaxExtractor()
    for id_name in id_list:
        with open(os.path.join(label_dir, id_name + ".lab")) as f:
            labels = JaxTTSModel.strip_timings([l for l in f if l.strip()])
        q = JaxTTSModel.phone_question_matrix(operator, labels)
        extractor.add_sample(q)
        q.tofile(os.path.join(dur_q_dir, id_name + ".questions"))
    extractor.save(os.path.join(dur_q_dir, "all"))
    dur_dirs = dict(dir_phoneme_labels=dur_q_dir,
                    dir_durations=os.path.join(fixtures_dir, "dur"))
    am_dirs = dict(
        dir_question_labels=os.path.join(fixtures_dir, "questions"),
        dir_world_features=os.path.join(fixtures_dir, "WORLD"))

    hp_dj = _dur_hparams(JaxDurationModelTrainer, num_questions, tmp / "j")
    dj = JaxDurationModelTrainer(hp_dj, list(id_list), **dur_dirs)
    dj.init(hp_dj)
    dj.train(hp_dj)
    hp_aj = _am_hparams(JaxAcousticModelTrainer, num_questions, tmp / "j")
    aj = JaxAcousticModelTrainer(hp_aj, list(id_list), **am_dirs)
    cfg = jax_rnn.convert_legacy_string(AM_MODEL, num_questions)
    cfg.input_names, cfg.output_names = ("questions",), \
        ("pred_acoustic_features",)
    aj.init(hp_aj, model_config=cfg)
    aj.train(hp_aj)

    hp_d = _dur_hparams(DurationModelTrainer, num_questions, tmp / "p")
    hp_d.epochs = 0
    dp = DurationModelTrainer(hp_d, list(id_list), **dur_dirs)
    dp.init(hp_d)
    convert.load_flax_params(dp.model_handler.model, _weights(dj))
    hp_a = _am_hparams(AcousticModelTrainer, num_questions, tmp / "p")
    ap = AcousticModelTrainer(hp_a, list(id_list), **am_dirs)
    cfg = torch_rnn.convert_legacy_string(AM_MODEL, num_questions)
    cfg.input_names, cfg.output_names = ("questions",), \
        ("pred_acoustic_features",)
    ap.init(hp_a, model_config=cfg)
    convert.load_flax_params(ap.model_handler.model, _weights(aj))

    hp_a.add_hparams(duration_trainer=dp, acoustic_trainer=ap)
    hp_a.question_file = question_file
    hp_aj.add_hparams(duration_trainer=dj, acoustic_trainer=aj)
    hp_aj.question_file = question_file
    return dict(tmp=tmp, hp=hp_a, hp_j=hp_aj, label_dir=label_dir,
                ids=list(id_list), question_file=question_file,
                dur_q_dir=dur_q_dir)


def _jax_draw(seed, T, nb=129):
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(
        jax.random.normal(kr, (T, nb)) + 1j * jax.random.normal(ki,
                                                                 (T, nb))))


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def _aligned(path):
    """An aligned label file -> (labels, (P, 5) durations in frames)."""
    labels, frames = [], []
    with open(path) as f:
        for line in f:
            start, end, label = line.split()
            if label.endswith("[2]"):
                labels.append(label[:-3])
                frames.append([])
            frames[-1].append((int(end) - int(start)) // 50000)
    return labels, np.array(frames)


@pytest.fixture(scope="module")
def dm_am_runs(recipe):
    """run_DM_AM of both packages on the fixture labels, modular synth
    with the original spectrum and voicing and one noise draw."""
    ids = recipe["ids"][:3]
    plain_call = BatchedWorldSynth.__call__

    def with_jax_noise(self, samples, seed=0, z=None):
        T = int(np.ceil(max(len(s) for s in samples) / self.bucket)
                * self.bucket)
        return plain_call(self, samples, z=_jax_draw(seed, T))

    BatchedWorldSynth.__call__ = with_jax_noise
    runs = {}
    try:
        for name, run, hp in (("port", TTSModel.run_DM_AM, recipe["hp"]),
                              ("jax", JaxTTSModel.run_DM_AM,
                               recipe["hp_j"])):
            hp.synth_dir = str(recipe["tmp"] / ("dm_am_" + name))
            hp.use_fused_synth = False
            hp.synth_load_org_sp = hp.synth_load_org_vuv = True
            try:
                runs[name] = run(hp, label_dir=recipe["label_dir"],
                                 id_list=ids)
            finally:
                hp.synth_load_org_sp = hp.synth_load_org_vuv = False
                hp.use_fused_synth = True
    finally:
        BatchedWorldSynth.__call__ = plain_call
    return dict(ids=ids, paths=runs)


def test_run_dm_am_durations_and_labels_match_jax(recipe, dm_am_runs):
    """The aligned label files: the same phone labels, and durations
    equal but where the unrounded prediction lies within BF16_BAND of a
    .5 boundary (at most 5% of the states; measured none), every one at
    least 1 frame."""
    states = differing = 0
    for id_name in dm_am_runs["ids"]:
        paths = [os.path.join(str(recipe["tmp"]), "dm_am_" + name,
                              "label_state_align", id_name + ".lab")
                 for name in ("port", "jax")]
        (labels, dur), (labels_j, dur_j) = map(_aligned, paths)
        assert labels == labels_j
        assert dur.shape == dur_j.shape and dur.min() >= 1
        states += dur.size
        differing += int((dur != dur_j).sum())
        if np.array_equal(dur, dur_j):
            with open(paths[0]) as a, open(paths[1]) as b:
                assert a.read() == b.read()
    assert differing <= 0.05 * states, (differing, states)


def test_run_dm_am_frame_questions_match_jax(recipe, dm_am_runs):
    """The port's frame questions from the JAX run's aligned labels are
    JAX's, bit for bit; and the port's own run wrote the same questions
    wherever its durations equal JAX's."""
    tmp = str(recipe["tmp"])
    aligned_j = os.path.join(tmp, "dm_am_jax", "label_state_align")
    label_dict, _, _ = tts_model.QuestionLabelGen.gen_data(
        aligned_j, recipe["question_file"], id_list=dm_am_runs["ids"],
        return_dict=True)
    for id_name in dm_am_runs["ids"]:
        ref = np.fromfile(os.path.join(tmp, "dm_am_jax", "questions",
                                       id_name + ".questions"), np.float32)
        np.testing.assert_array_equal(label_dict[id_name].ravel(), ref)
        own = np.fromfile(os.path.join(tmp, "dm_am_port", "questions",
                                       id_name + ".questions"), np.float32)
        if own.shape == ref.shape:
            np.testing.assert_array_equal(own, ref)


def test_run_dm_am_waveforms_match_jax(dm_am_runs):
    """One wav per utterance, 80 samples a frame of the predicted
    durations, audible, and within 0.05 dB of the JAX run's 5 ms frame
    energies over the frames within 60 dB of the loudest (measured
    0.017 dB) wherever the durations agree (two of the three utterances:
    one flips 2 states at a .5 boundary)."""
    paths = dm_am_runs["paths"]
    compared = 0
    assert sorted(paths["port"]) == sorted(dm_am_runs["ids"])
    for id_name in dm_am_runs["ids"]:
        got, fs = audio_io.get_raw(paths["port"][id_name])
        ref, _ = audio_io.get_raw(paths["jax"][id_name])
        assert fs == 16000 and np.isfinite(got).all()
        assert len(got) > fs / 2 and 1e-5 < np.abs(got).max() <= 1.0
        if got.shape != ref.shape:
            continue     # a duration flipped at a .5 boundary
        db_got, db_ref = _frame_db(got), _frame_db(ref)
        loud = db_ref > db_ref.max() - 60.0
        assert np.abs(db_got[loud] - db_ref[loud]).max() < 0.05
        compared += 1
    assert compared >= 1


def test_run_dm_am_fused_from_text(recipe):
    """Text in, the built-in front end, the fused synth: wavs of
    sum(durations) x 80 samples with finite values, and every duration
    at least 1 frame."""
    hp = recipe["hp"]
    hp.synth_dir = str(recipe["tmp"] / "fused_text")
    paths = TTSModel.run_DM_AM(hp, input_strings=list(TEXTS))
    assert sorted(paths) == ["utt000", "utt001", "utt002"]
    for id_name, path in paths.items():
        _, dur = _aligned(os.path.join(hp.synth_dir, "label_state_align",
                                       id_name + ".lab"))
        raw, fs = audio_io.get_raw(path)
        assert dur.min() >= 1
        assert raw.shape == (int(dur.sum()) * 80,)
        assert np.isfinite(raw).all()


def test_server_gives_what_run_dm_am_gives(recipe):
    """TextToSpeechServer on three texts submitted at once: the futures
    resolve to the waveforms run_DM_AM synthesises for the same texts
    (its fused pipeline on its frame questions, before the PCM16
    encoding that leaves this one-epoch model's wavs silent; the noise
    draw is the same when the utterances share the server's length
    bucket, which the texts are chosen for), within 1e-5 of their peak
    (measured: equal); the host's front half is timed."""
    hp = recipe["hp"]
    hp.synth_dir = str(recipe["tmp"] / "server_ref")
    paths = TTSModel.run_DM_AM(hp, input_strings=list(TEXTS))
    pipeline, params, load_inputs = \
        hp.acoustic_trainer.build_serving(hp)
    refs = pipeline(params, [load_inputs(i) for i in sorted(paths)])
    server = TTSModel.serve(hp, max_batch=4, max_wait_ms=200.0)
    try:
        futures = [server.submit(text) for text in TEXTS]
        wavs = [f.result(timeout=300) for f in futures]
        stats = server.stats()
    finally:
        server.shutdown()
    assert not os.path.exists(server.work_root)
    assert stats["requests"] == 3 and stats["batches"] <= 3
    assert stats["front_seconds"] > 0
    lengths = [len(w) // 80 for w in wavs]
    assert len({-(-n // 256) for n in lengths}) == 1, lengths
    for wav, ref, id_name in zip(wavs, refs, sorted(paths)):
        written, _ = audio_io.get_raw(paths[id_name])
        assert wav.shape == ref.shape == written.shape
        assert np.isfinite(wav).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(wav, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_load_trainers_from_checkpoint_paths(recipe, num_questions):
    """The checkpoint-path interface: trainers rebuilt from the port's
    own checkpoints and the norm-stat directories give the same wav as
    the trainers they were saved from."""
    hp = recipe["hp"]
    tmp = recipe["tmp"]
    for trainer in (hp.duration_trainer, hp.acoustic_trainer):
        trainer.model_handler.save_checkpoint(
            str(tmp / "ckpt"), "dm" if trainer is hp.duration_trainer
            else "am", last=True)
    path_hp = TTSModel.create_hparams()
    path_hp.device = "cpu"
    path_hp.question_file = recipe["question_file"]
    path_hp.num_questions = num_questions
    path_hp.setattr_no_type_check("num_coded_sps", 20)
    path_hp.setattr_no_type_check("duration_model",
                                  os.path.join(str(tmp / "ckpt"), "dm"))
    path_hp.setattr_no_type_check("acoustic_model",
                                  os.path.join(str(tmp / "ckpt"), "am"))
    path_hp.setattr_no_type_check("duration_labels_dir", recipe["dur_q_dir"])
    fixtures = os.path.dirname(os.path.dirname(recipe["label_dir"]))
    path_hp.setattr_no_type_check("question_labels_norm_file",
                                  os.path.join(fixtures, "questions"))
    path_hp.setattr_no_type_check("world_features_dir",
                                  os.path.join(fixtures, "WORLD"))
    path_hp.synth_dir = str(tmp / "from_paths")
    got = TTSModel.run_DM_AM(path_hp, label_dir=recipe["label_dir"],
                             id_list=recipe["ids"][:1])
    hp.synth_dir = str(tmp / "from_trainers")
    ref = TTSModel.run_DM_AM(hp, label_dir=recipe["label_dir"],
                             id_list=recipe["ids"][:1])
    (id_name,) = got
    raw, _ = audio_io.get_raw(got[id_name])
    raw_ref, _ = audio_io.get_raw(ref[id_name])
    np.testing.assert_array_equal(raw, raw_ref)


def test_front_end_and_labels_helpers_match_jax(recipe, tmp_path):
    """run_front_end (built-in, both accents), strip_timings,
    phone_question_matrix and write_alignment against the JAX module."""
    from idiaptts_torch.hparams import ExtendedHParams
    for accent in ("en-US", "en-GB"):
        hp = ExtendedHParams.create_hparams()
        hp.add_hparams(front_end_accent=accent)
        ids = TTSModel.run_front_end(hp, list(TEXTS), str(tmp_path / accent))
        ids_j = JaxTTSModel.run_front_end(hp, list(TEXTS),
                                          str(tmp_path / (accent + "_j")))
        assert ids == ids_j == ["utt000", "utt001", "utt002"]
        for uid in ids:
            with open(str(tmp_path / accent / (uid + ".lab"))) as a, \
                    open(str(tmp_path / (accent + "_j") / (uid + ".lab"))) \
                    as b:
                lines, lines_j = a.readlines(), b.readlines()
            assert lines == lines_j
    with open(os.path.join(recipe["label_dir"], "gen-0001.lab")) as f:
        lines = [l for l in f if l.strip()]
    labels = TTSModel.strip_timings(lines)
    assert labels == JaxTTSModel.strip_timings(lines)
    operator = tts_model.HTSLabelNormalisation(
        recipe["question_file"], add_frame_features=False,
        subphone_feats="none")
    operator_j = jax_questions.HTSLabelNormalisation(
        recipe["question_file"], add_frame_features=False,
        subphone_feats="none")
    np.testing.assert_array_equal(
        TTSModel.phone_question_matrix(operator, labels),
        JaxTTSModel.phone_question_matrix(operator_j, labels))
    dur = np.random.RandomState(2).randint(0, 4, (len(labels), 5))
    path = TTSModel.write_alignment(str(tmp_path / "a"), "x", labels, dur)
    path_j = JaxTTSModel.write_alignment(str(tmp_path / "b"), "x", labels,
                                         dur)
    with open(path) as a, open(path_j) as b:
        assert a.read() == b.read()


def test_front_end_cmd_subprocess(tmp_path):
    """front_end_cmd: synth.txt written, the command run with it and the
    output directory, and the .lab files it leaves listed."""
    from idiaptts_torch.hparams import ExtendedHParams
    script = tmp_path / "fe.sh"
    script.write_text("#!/bin/sh\nwhile read id text; do echo \"x-$id+y\" "
                      "> \"$2/$id.lab\"; done < \"$1\"\n")
    script.chmod(0o755)
    hp = ExtendedHParams.create_hparams()
    hp.add_hparams(front_end_cmd=str(script))
    ids = TTSModel.run_front_end(hp, ["one", "two"], str(tmp_path / "out"))
    assert ids == ["utt000", "utt001"]
    with open(str(tmp_path / "out" / "utt001.lab")) as f:
        assert f.read() == "x-utt001+y\n"


def test_write_durations_into_labels():
    """Mirrors tests/integration/test_tts_model.py."""
    labels = ["a-b+c", "b-c+d"]
    dur = np.array([[2, 1, 1, 1, 1], [1, 1, 1, 1, 2]])
    lines = TTSModel.write_durations_into_labels(labels, dur)
    assert len(lines) == 10
    assert lines[0] == "0 100000 a-b+c[2]"
    assert lines[1].startswith("100000 150000")
    assert lines[-1].split()[1] == str(dur.sum() * 50000)
    assert lines == JaxTTSModel.write_durations_into_labels(labels, dur)


def test_entry_points_default_to_the_card(question_file):
    """Without CUDA the text server and the trainers it loads raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hp = TTSModel.create_hparams()
    assert hp.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DurationModelTrainer(hp, ["a"])
    hp.question_file = question_file
    hp.setattr_no_type_check("duration_model", "nowhere/dm")
    hp.setattr_no_type_check("acoustic_model", "nowhere/am")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextToSpeechServer(hp)
