"""Parity of the port's WORLD post-processing and synthesis front door
(``WorldFeatLabelGen.postprocess_sample``, ``Metrics``,
``BatchedWorldSynth``, ``Synthesiser.run_world_synth`` and
``copy_synth``) with the JAX package's, on the fixture corpus's WORLD
features (20 mcep + lf0 + vuv + bap, with deltas and covariances)."""

import os

import jax
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_tpu.synth.metrics import Metrics as JaxMetrics
from idiaptts_tpu.synth.pipeline import BatchedWorldSynth as JaxSynth
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.ops import audio_io
from idiaptts_torch.synth.metrics import Metrics
from idiaptts_torch.synth.pipeline import BatchedWorldSynth
from idiaptts_torch.synth.synthesiser import Synthesiser

IDS = ("gen-0001", "gen-0002", "gen-0003")
NUM_SPS = 20


def _world(fixtures_dir):
    return os.path.join(fixtures_dir, "WORLD")


def _readers(fixtures_dir):
    kw = dict(name="cmp", directory=_world(fixtures_dir), add_deltas=True,
              num_coded_sps=NUM_SPS)
    return (JaxWorld.Config(**kw).create_reader(),
            WorldFeatLabelGen.Config(device="cpu", **kw).create_reader())


def _prediction(reader, id_name):
    """A normalised cmp matrix as a network would predict it: the
    utterance's own features plus seeded noise."""
    x = reader[id_name]["cmp"]
    noise = np.random.RandomState(0).randn(*x.shape)
    return (x + 0.3 * noise).astype(np.float32)


@pytest.mark.parametrize("apply_mlpg", [True, False])
@pytest.mark.parametrize("id_name", IDS)
def test_postprocess_sample_matches_jax(fixtures_dir, id_name, apply_mlpg):
    jax_reader, reader = _readers(fixtures_dir)
    np.testing.assert_array_equal(reader[id_name]["cmp"],
                                  jax_reader[id_name]["cmp"])
    sample = _prediction(reader, id_name)
    out = reader.postprocess_sample(sample, apply_mlpg=apply_mlpg)
    ref = jax_reader.postprocess_sample(sample, apply_mlpg=apply_mlpg)
    assert out.shape == ref.shape == (len(sample), NUM_SPS + 3)
    if not apply_mlpg:
        # Denormalisation and slicing only: the same numpy operations.
        np.testing.assert_array_equal(out, ref)
        return
    # Float32 solves of the same systems; the fixture covariances make
    # them stiffer than random ones, so the few-ulp differences of the
    # two recurrences grow: measured 1.7e-5 of each stream's largest
    # magnitude.
    for cols in (slice(0, NUM_SPS), slice(NUM_SPS, NUM_SPS + 1),
                 slice(NUM_SPS + 2, NUM_SPS + 3)):
        top = np.abs(ref[:, cols]).max()
        np.testing.assert_allclose(out[:, cols], ref[:, cols], rtol=0,
                                   atol=1e-4 * top)
    np.testing.assert_array_equal(out[:, NUM_SPS + 1], ref[:, NUM_SPS + 1])


def test_default_postprocessing_fn_runs_mlpg(fixtures_dir):
    """The reader's postprocessing_fn defaults to the WORLD
    post-processing, as in the JAX reader."""
    _, reader = _readers(fixtures_dir)
    sample = _prediction(reader, IDS[0])
    denorm = reader._denormalise(sample, 0)
    np.testing.assert_array_equal(reader.postprocessing_fn(denorm),
                                  reader.postprocess_sample(sample))


def test_metrics_match_jax(fixtures_dir):
    jax_reader, reader = _readers(fixtures_dir)
    names = [Metrics.MCD, "MCD_10", Metrics.F0_RMSE, Metrics.GPE,
             Metrics.FFE, Metrics.VDE, Metrics.BAP_distortion]
    ours, theirs = Metrics(names), JaxMetrics(names)
    for id_name in IDS:
        org = WorldFeatLabelGen.convert_to_world_features(
            WorldFeatLabelGen.load_sample(id_name, _world(fixtures_dir),
                                          num_coded_sps=NUM_SPS),
            num_coded_sps=NUM_SPS)
        out = WorldFeatLabelGen.convert_to_world_features(
            reader.postprocess_sample(_prediction(reader, id_name)),
            num_coded_sps=NUM_SPS)
        kw = dict(org_coded_sp=org[0], org_lf0=org[1], org_vuv=org[2],
                  org_bap=org[3], output_coded_sp=out[0], output_lf0=out[1],
                  output_vuv=out[2], output_bap=out[3])
        got = Metrics.get_metrics(names, **kw)
        ref = JaxMetrics.get_metrics(names, **kw)
        assert [n for n, _ in got] == names
        # The same numpy code on the same inputs.
        np.testing.assert_array_equal([v for _, v in got],
                                      [v for _, v in ref])
        ours.accumulate(id_name, got)
        theirs.accumulate(id_name, ref)
    np.testing.assert_array_equal(ours.get_cum_values(),
                                  theirs.get_cum_values())
    assert ours.max_value_ids == theirs.max_value_ids


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def _jax_draw(seed, T, nb=129):
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(
        jax.random.normal(kr, (T, nb)) + 1j * jax.random.normal(ki,
                                                                 (T, nb))))


def test_batched_world_synth_matches_jax(fixtures_dir):
    """The JAX package's noise draw fed in as z.  The harmonic phase of
    the two packages drifts apart linearly in time (ROADMAP fault 3.5),
    so samples are compared over the first 64 frames (measured 5.6e-4 of
    peak) and whole utterances by 5 ms frame energy (measured 0.002
    dB)."""
    feats = [WorldFeatLabelGen.load_sample(i, _world(fixtures_dir),
                                           num_coded_sps=NUM_SPS)
             for i in IDS[:2]]
    lengths = [len(f) for f in feats]
    T = int(np.ceil(max(lengths) / 256) * 256)
    ref = JaxSynth(NUM_SPS, 16000)(feats, seed=0)
    out = BatchedWorldSynth(NUM_SPS, 16000, device="cpu")(
        feats, z=_jax_draw(0, T))
    head = 64 * 80
    for o, r, n in zip(out, ref, lengths):
        assert o.shape == r.shape == (n * 80,)
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o[:head], r[:head], rtol=0,
                                   atol=3e-3 * np.abs(r).max())
        db_r, db_o = _frame_db(r), _frame_db(o)
        loud = db_r > db_r.max() - 60.0
        assert np.abs(db_o[loud] - db_r[loud]).max() < 0.05


def test_batched_world_synth_draws_from_seed(fixtures_dir):
    feats = [WorldFeatLabelGen.load_sample(IDS[0], _world(fixtures_dir),
                                           num_coded_sps=NUM_SPS)[:40]]
    synth = BatchedWorldSynth(NUM_SPS, 16000, device="cpu")
    a, b, c = (synth(feats, seed=s)[0] for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert synth([]) == []


def _hparams(tmp_path, **over):
    hp = ExtendedHParams.create_hparams()
    hp.device = "cpu"
    hp.num_coded_sps = NUM_SPS
    hp.synth_dir = str(tmp_path)
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


def test_copy_synth_world_writes_loud_waveforms(fixtures_dir, tmp_path):
    """Synthesiser.copy_synth with the WORLD vocoder: the original
    features through run_world_synth, one wav per utterance of 80
    samples a frame, as loud as speech."""
    hp = _hparams(tmp_path)
    paths = Synthesiser.copy_synth(hp, list(IDS[:2]),
                                   feature_dir=_world(fixtures_dir))
    assert sorted(paths) == list(IDS[:2])
    for id_name, path in paths.items():
        raw, fs = audio_io.get_raw(path)
        frames = len(WorldFeatLabelGen.load_sample(
            id_name, _world(fixtures_dir), num_coded_sps=NUM_SPS))
        assert fs == 16000 and raw.shape == (frames * 80,)
        assert np.sqrt(np.mean(raw ** 2)) > 0.01


def test_copy_synth_raw_resamples_the_original_audio(tmp_path):
    fs_in = 48000
    t = np.arange(fs_in // 10) / fs_in
    src = tmp_path / "src"
    audio_io.raw_to_file(str(src / "utt.wav"),
                         0.5 * np.sin(2 * np.pi * 440 * t), fs_in)
    hp = _hparams(tmp_path / "out", synth_vocoder="raw")
    paths = Synthesiser.copy_synth(hp, ["utt"], feature_dir=str(src))
    raw, fs = audio_io.get_raw(paths["utt"])
    assert fs == 16000 and raw.shape == (1600,)
    assert 0.3 < np.abs(raw).max() < 0.6


def test_non_cepstral_synthesis_raises(tmp_path):
    hp = _hparams(tmp_path, sp_type="mfbanks")
    with pytest.raises(NotImplementedError, match="item 10"):
        Synthesiser.run_world_synth({"a": np.zeros((4, 23))}, hp)
    with pytest.raises(NotImplementedError, match="item 10"):
        Synthesiser.run_griffin_lim({"a": np.zeros((4, 5))}, hp)
    with pytest.raises(NotImplementedError, match="item 10"):
        WorldFeatLabelGen.decode_sp(np.zeros((4, 20)), sp_type="mfbanks")


def test_world_synth_cache_is_keyed_by_device():
    cpu = Synthesiser._batched_world_synth(NUM_SPS, 16000, 5, 1, False,
                                           device="cpu")
    assert cpu is Synthesiser._batched_world_synth(NUM_SPS, 16000, 5, 1,
                                                   False, device="cpu")
    assert cpu.device == torch.device("cpu") and not cpu.post_filter
    assert Synthesiser._batched_world_synth(NUM_SPS, 16000, 5, 1, True,
                                            device="cpu").post_filter
