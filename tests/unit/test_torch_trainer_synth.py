"""The evaluation and WORLD synthesis slice as a whole on the CPU: the
port's AcousticModelTrainer (``benchmark``, ``forward``, modular and
fused ``synth``, ``copy_synth``, ``serve``) against the JAX package's, at
``RNNDYN-1_RELU_64-1_BiLSTM_32-1_FC_67`` on the fixture corpus, with the
JAX trainer's flax weights converted into the port.  Mirrors
tests/integration/test_acoustic_trainer.py."""

import os

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.train.acoustic import \
    AcousticModelTrainer as JaxAcousticModelTrainer
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.ops import audio_io
from idiaptts_torch.train.acoustic import AcousticModelTrainer

MODEL = "RNNDYN-1_RELU_64-1_BiLSTM_32-1_FC_67"
IDS = ("gen-0001", "gen-0002", "gen-0003")


def _hparams(cls, num_questions, tmp):
    hp = cls.create_hparams()
    hp.num_questions = num_questions
    hp.num_coded_sps = 20
    hp.out_dir = str(tmp)
    hp.model_name = "acoustic"
    hp.batch_size_val = 3
    hp.batch_size_benchmark = 3
    hp.batch_size_synth = 2
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.0
    hp.synth_fs = 16000
    if cls is AcousticModelTrainer:
        hp.device = "cpu"
    return hp


def _trainer(cls, rnn, hp, fixtures_dir, num_questions):
    trainer = cls(hp, {"train": list(IDS)},
                  dir_question_labels=os.path.join(fixtures_dir,
                                                   "questions"),
                  dir_world_features=os.path.join(fixtures_dir, "WORLD"))
    cfg = rnn.convert_legacy_string(MODEL, num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_acoustic_features",)
    trainer.init(hp, model_config=cfg)
    return trainer


@pytest.fixture(scope="module")
def pair(fixtures_dir, num_questions, tmp_path_factory):
    """The JAX trainer and the port's with the same weights, and the JAX
    trainer's benchmark scores and forward outputs."""
    tmp = tmp_path_factory.mktemp("trainer_synth")
    hp_j = _hparams(JaxAcousticModelTrainer, num_questions, tmp / "jax")
    jt = _trainer(JaxAcousticModelTrainer, jax_rnn, hp_j, fixtures_dir,
                  num_questions)
    hp = _hparams(AcousticModelTrainer, num_questions, tmp / "port")
    pt = _trainer(AcousticModelTrainer, torch_rnn, hp, fixtures_dir,
                  num_questions)
    convert.load_flax_params(pt.model_handler.model, jax.tree_util.tree_map(
        np.asarray, jt.model_handler.params))
    return dict(jax=jt, port=pt, hp=hp, hp_j=hp_j, tmp=tmp,
                fixtures_dir=fixtures_dir,
                scores_j=jt.benchmark(hp_j, list(IDS)),
                forward_j=jt.forward(hp_j, list(IDS)))


def _raw(path):
    raw, fs = audio_io.get_raw(path)
    assert fs == 16000
    return raw


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def _jax_draw(seed, T, nb=129):
    """The noise the JAX BatchedWorldSynth draws for a batch padded to T
    frames with ``seed``."""
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(
        jax.random.normal(kr, (T, nb)) + 1j * jax.random.normal(ki,
                                                                 (T, nb))))


def _frames(fixtures_dir, id_name):
    return len(np.load(os.path.join(fixtures_dir, "WORLD", "lf0",
                                    id_name + ".npz"))["lf0"])


def test_benchmark_scores_match_jax(pair):
    """MCD, F0-RMSE, VDE and BAP distortion of both trainers' MLPG-
    smoothed predictions against the original features.  The models
    agree at bf16 scale (ROADMAP fault 3.2) and MLPG passes that on:
    measured 1.2e-4 relative (F0-RMSE), 1.5e-6 (MCD), 4e-7 (BAP).  VDE
    counts voicing decisions at 0.5, where a prediction within bf16 noise
    of the threshold may flip: measured equal; allowed 4 of the 847
    frames."""
    scores = pair["port"].benchmark(pair["hp"], list(IDS))
    scores_j = pair["scores_j"]
    assert len(scores) == 4 and np.all(np.isfinite(scores))
    for i in (0, 1, 3):     # MCD, F0-RMSE, BAP distortion
        np.testing.assert_allclose(scores[i], scores_j[i], rtol=1e-3)
    assert abs(scores[2] - scores_j[2]) <= 0.005


def test_forward_postprocessed_features_match_jax(pair):
    """forward: the post-processed [mcep | lf0 | vuv | bap] statics, per
    stream relative to the stream's largest magnitude (bf16-scale model
    outputs, denormalised and smoothed; measured 2.3e-4)."""
    out = pair["port"].forward(pair["hp"], list(IDS))
    for id_name in IDS:
        got = out[id_name]["pred_acoustic_features"]
        ref = np.asarray(pair["forward_j"][id_name]["pred_acoustic_features"])
        assert got.shape == ref.shape == (ref.shape[0], 23)
        for cols in (slice(0, 20), slice(20, 21), slice(22, 23)):
            top = np.abs(ref[:, cols]).max()
            np.testing.assert_allclose(got[:, cols], ref[:, cols], rtol=0,
                                       atol=1e-3 * top)
        vuv_flips = np.mean(got[:, 21] != ref[:, 21])
        assert vuv_flips <= 0.01


def test_modular_fused_and_copy_synth_write_waveforms(pair, fixtures_dir):
    """The modular path (forward, per-utterance MLPG, BatchedWorldSynth),
    the fused path and copy_synth write one wav per utterance of 80
    samples a frame; copy_synth of the original features is loud.  (The
    untrained model predicts unvoiced frames at c0 near -12.8: its
    waveforms are under one PCM16 step, so their loudness is checked in
    test_modular_synth_matches_jax.)"""
    trainer, hp, tmp = pair["port"], pair["hp"], pair["tmp"]
    ids = list(IDS[:2])
    paths = {}
    for name, fused in (("modular", False), ("fused", True)):
        hp.synth_dir = str(tmp / name)
        hp.use_fused_synth = fused
        paths[name] = trainer.synth(hp, ids)
    hp.synth_dir = str(tmp / "copy")
    paths["copy"] = trainer.copy_synth(hp, ids)
    hp.use_fused_synth = True
    for name, by_id in paths.items():
        assert sorted(by_id) == ids, name
        for id_name, path in by_id.items():
            raw = _raw(path)
            assert raw.shape == (_frames(fixtures_dir, id_name) * 80,), name
            assert np.isfinite(raw).all(), name
            if name == "copy":
                assert np.sqrt(np.mean(raw ** 2)) > 0.01


def test_modular_synth_matches_jax(pair, monkeypatch):
    """The modular synth of both trainers from the same weights, with the
    original spectrum and voicing (``synth_load_org_sp`` and ``_vuv``) so
    that the waveforms are loud while the predicted pitch and
    aperiodicity are heard (the untrained model alone predicts unvoiced
    frames at c0 near -12.8, under one PCM16 step), and the port's
    BatchedWorldSynth fed the JAX noise draw.  The written wavs are
    audible (peak above 1e-5, as the JAX test asks) and agree with the
    JAX trainer's by 5 ms frame energy over the frames within 60 dB of
    the loudest (the harmonic phase drifts apart in time, ROADMAP fault
    3.5; the models agree at bf16 scale): measured 0.008 dB."""
    from idiaptts_torch.synth.pipeline import BatchedWorldSynth
    trainer, hp, tmp = pair["port"], pair["hp"], pair["tmp"]
    jt, hp_j = pair["jax"], pair["hp_j"]
    ids = list(IDS[:2])
    plain_call = BatchedWorldSynth.__call__

    def with_jax_noise(self, samples, seed=0, z=None):
        T = int(np.ceil(max(len(s) for s in samples) / self.bucket)
                * self.bucket)
        return plain_call(self, samples, z=_jax_draw(seed, T))

    monkeypatch.setattr(BatchedWorldSynth, "__call__", with_jax_noise)
    paths = {}
    for name, t, h in (("port", trainer, hp), ("jax", jt, hp_j)):
        h.synth_dir = str(tmp / ("org_sp_vuv_" + name))
        h.synth_load_org_sp = h.synth_load_org_vuv = True
        try:
            paths[name] = t.synth(h, ids)
        finally:
            h.synth_load_org_sp = h.synth_load_org_vuv = False
    for id_name in ids:
        got, ref = _raw(paths["port"][id_name]), _raw(paths["jax"][id_name])
        assert got.shape == ref.shape
        assert np.isfinite(got).all()
        assert 1e-5 < np.abs(got).max() <= 1.0 and np.ptp(got) > 0
        db_got, db_ref = _frame_db(got), _frame_db(ref)
        loud = db_ref > db_ref.max() - 60.0
        assert np.abs(db_got[loud] - db_ref[loud]).max() < 0.05


def test_synth_load_org_streams_changes_the_waveform(pair):
    """Per-stream ground-truth override: with the original sp, lf0 and
    vuv the waveform differs from the all-predicted one (the override
    takes the modular path)."""
    trainer, hp, tmp = pair["port"], pair["hp"], pair["tmp"]
    ids = list(IDS[:1])
    hp.synth_dir = str(tmp / "plain")
    plain = _raw(trainer.synth(hp, ids)[ids[0]])
    hp.synth_dir = str(tmp / "org_streams")
    for s in ("sp", "lf0", "vuv"):
        setattr(hp, "synth_load_org_" + s, True)
    try:
        assert not AcousticModelTrainer.uses_fused_synth(hp)
        org = _raw(trainer.synth(hp, ids)[ids[0]])
    finally:
        for s in ("sp", "lf0", "vuv"):
            setattr(hp, "synth_load_org_" + s, False)
    assert org.shape == plain.shape and np.isfinite(org).all()
    assert not np.allclose(plain, org)


def test_fused_synth_failure_raises(pair, monkeypatch):
    """A failure on the fused path raises; synth does not drop to the
    modular path."""
    trainer, hp = pair["port"], pair["hp"]

    def broken(*args, **kwargs):
        raise RuntimeError("fused pipeline broken")

    def modular(*args, **kwargs):
        raise AssertionError("synth fell back to the modular path")

    monkeypatch.setattr(trainer, "build_serving", broken)
    monkeypatch.setattr(trainer, "gen_waveform", modular)
    hp.use_fused_synth = True
    with pytest.raises(RuntimeError, match="fused pipeline broken"):
        trainer.synth(hp, list(IDS[:1]))


def test_serve_front_door(pair):
    """trainer.serve(): a SynthesisServer over the fused pipeline answers
    concurrent requests with waveforms of 80 samples a frame."""
    trainer, hp = pair["port"], pair["hp"]
    server = trainer.serve(hp, max_batch=4, max_wait_ms=50.0)
    try:
        _, _, load_inputs = trainer.build_serving(hp)
        futures = [(i, server.submit(load_inputs(i))) for i in IDS[:2]]
        for id_name, fut in futures:
            wav = fut.result(timeout=300)
            assert wav.shape == (len(load_inputs(id_name)) * 80,)
            assert np.isfinite(wav).all()
        assert server.stats()["requests"] == 2
    finally:
        server.shutdown()


def test_griffin_lim_and_gen_figure_raise(pair, monkeypatch):
    """Both raised here until they were ported.  The trainer's
    ``synth_vocoder == "GriffinLim"`` branch hands the utterance's
    features to ``Synthesiser.run_griffin_lim`` as the JAX trainer does.
    Fed the JAX package's initial angles, the written waveform matches
    the JAX trainer's: correlation 0.999996, loud frames' energies within
    0.37 dB (bounds 0.9999 and 1 dB).  The input is degenerate (the 23
    feature columns as a spectrogram: 44-point frames at an 80-sample
    hop, no overlap), so 60 iterations amplify float32 rounding; on a
    real spectrogram the two agree to 1.4e-5 (test_torch_stft.py).
    gen_figure writes the acoustic figure of each utterance (predicted
    coded spectrum, lf0 against the original) as the JAX trainer
    does."""
    from idiaptts_torch.ops import stft as stft_ops
    plain = stft_ops.griffin_lim

    def jax_angles(amp, *args, generator=None, angles=None, **kw):
        angles = np.array(jax.random.uniform(
            jax.random.PRNGKey(0), tuple(amp.shape), minval=-np.pi,
            maxval=np.pi))
        return plain(amp, *args, angles=angles, **kw)

    monkeypatch.setattr(stft_ops, "griffin_lim", jax_angles)
    trainer, hp = pair["port"], pair["hp"]
    hp.synth_vocoder = pair["hp_j"].synth_vocoder = "GriffinLim"
    try:
        paths = trainer.gen_waveform(hp, {IDS[0]: {}},
                                     use_org_features=True)
        paths_j = pair["jax"].gen_waveform(pair["hp_j"], {IDS[0]: {}},
                                           use_org_features=True)
    finally:
        hp.synth_vocoder = pair["hp_j"].synth_vocoder = "WORLD"
    pcm = [scipy.io.wavfile.read(p[IDS[0]])[1].astype(np.int32)
           for p in (paths, paths_j)]
    assert pcm[0].shape == pcm[1].shape == (
        (_frames(pair["fixtures_dir"], IDS[0]) - 1) * 80,)
    assert np.corrcoef(pcm[0], pcm[1])[0, 1] > 0.9999
    db = [_frame_db(p) for p in pcm]
    loud = db[1] > db[1].max() - 40.0
    assert np.abs(db[0] - db[1])[loud].max() < 1.0
    assert np.abs(pcm[0]).max() > 10000
    hp.synth_dir = str(pair["tmp"] / "figures")
    paths = trainer.gen_figure(hp, list(IDS[:2]))
    paths_j = pair["jax"].gen_figure(pair["hp_j"], list(IDS[:2]))
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in paths_j]
    for path in paths:
        assert os.path.dirname(path) == hp.synth_dir
        assert os.path.getsize(path) > 1000


@pytest.mark.parametrize("value, expected", [
    (["a", "b"], ["a", "b"]), (("a",), ["a"]), ("gen-0001", ["gen-0001"])])
def test_input_to_str_list(value, expected):
    assert AcousticModelTrainer._input_to_str_list(value) == expected


def test_split_batch_cuts_to_lengths():
    data = {"x": np.arange(24, dtype=np.float32).reshape(2, 4, 3)}
    out = AcousticModelTrainer.split_batch(data, {"x": [2, 4]})
    assert [v.shape for v in out["x"]] == [(2, 3), (4, 3)]
    np.testing.assert_array_equal(out["x"][1], data["x"][1])


def test_entry_points_default_to_the_card(num_questions):
    """Without CUDA the new entry points raise rather than run on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    from idiaptts_torch.ops.mlpg import MLPG
    from idiaptts_torch.synth.pipeline import BatchedWorldSynth
    reader = WorldFeatLabelGen(dir_labels=".", add_deltas=True,
                               num_coded_sps=1, num_bap=1)
    reader.covs = [np.eye(3)] * 4
    sample = np.zeros((4, 10), np.float32)
    for build in (lambda: MLPG().generation(np.zeros((4, 3)), np.eye(3), 1),
                  lambda: reader.postprocess_sample(sample),
                  lambda: BatchedWorldSynth(20)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
