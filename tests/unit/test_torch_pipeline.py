"""The label -> waveform slice as a whole: the port's FusedAcousticPipeline
(idiaptts_torch.synth.pipeline) against the JAX package's, on the fixture
corpus (6 utterances of 229-487 frames, 141 question features, bucket
T = 512), with a small acoustic model whose weights are converted from
the flax model."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.normalisation import MeanCovarianceExtractor
from idiaptts_tpu.data.questions import QuestionLabelGen, QuestionSet
from idiaptts_tpu.models import rnn_dyn as jax_rnn
from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline as JaxPipeline
from idiaptts_tpu.synth.server import SynthesisServer
from idiaptts_torch.models import convert
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.synth.pipeline import FusedAcousticPipeline

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "fixtures")
MODEL = "RNNDYN-2_RELU_64-2_BiLSTM_64-1_FC_67"
NUM_SPS, FS, BUCKET = 20, 16000, 256


def _corpus():
    with open(os.path.join(FIXTURES, "file_id_list.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    num_q = QuestionSet(os.path.join(
        FIXTURES, "questions-gen_dnn.hed")).dict_size + 9
    questions = [QuestionLabelGen.load_sample(
        i, os.path.join(FIXTURES, "questions"), num_questions=num_q)
        for i in ids]
    stats = {}
    for name in ("mcep20", "lf0", "bap"):
        mean, cov = MeanCovarianceExtractor.load(os.path.join(
            FIXTURES, "WORLD", "cmp_mcep20", name + "-mean-covariance.npz"))
        stats[name] = (np.asarray(mean).reshape(-1),
                       np.ascontiguousarray(np.diagonal(cov)))
    variances = {"sp": stats["mcep20"][1], "lf0": stats["lf0"][1],
                 "bap": stats["bap"][1]}
    # Denormalise the cmp-ordered output [mcep(60) | lf0(3) | vuv | bap(3)]
    # with the corpus statistics.  The voicing channel gets mean 1 so that
    # random weights give voiced frames: the harmonic part, whose phase a
    # bf16-level lf0 difference shifts, is then audible.
    mean = np.concatenate([stats["mcep20"][0], stats["lf0"][0], [1.0],
                           stats["bap"][0]]).astype(np.float32)
    scale = np.sqrt(np.concatenate([stats["mcep20"][1], stats["lf0"][1],
                                    [1.0], stats["bap"][1]])
                    ).astype(np.float32)
    return questions, variances, mean, scale, num_q


@pytest.fixture(scope="module")
def slice_setup():
    questions, variances, mean, scale, num_q = _corpus()
    lengths = np.array([len(q) for q in questions], np.int32)
    T = int(np.ceil(lengths.max() / BUCKET) * BUCKET)
    batch = np.zeros((len(questions), T, num_q), np.float32)
    for i, q in enumerate(questions):
        batch[i, :len(q)] = q

    cfg_j = jax_rnn.convert_legacy_string(MODEL, num_q)
    cfg_t = torch_rnn.convert_legacy_string(MODEL, num_q)
    for cfg in (cfg_j, cfg_t):
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred",)
    model_j = cfg_j.create_model()
    params = model_j.init({"params": jax.random.PRNGKey(0)},
                          {"questions": jnp.asarray(batch[:1])},
                          lengths=jnp.asarray(lengths[:1]), training=False)
    model_t = convert.load_flax_params(
        cfg_t.create_model(), jax.tree_util.tree_map(np.asarray, params))

    def apply_j(p, q, lens):
        return model_j.apply(p, {"questions": q}, lengths=lens,
                             training=False)["pred"]

    def apply_t(m, q, lens):
        return m({"questions": q}, lengths=lens)["pred"]

    pipe_j = JaxPipeline(apply_j, variances, num_coded_sps=NUM_SPS, fs=FS,
                         mean=mean, scale=scale, bucket=BUCKET)
    pipe_t = FusedAcousticPipeline(apply_t, variances,
                                   num_coded_sps=NUM_SPS, fs=FS, mean=mean,
                                   scale=scale, bucket=BUCKET,
                                   device="cpu")
    setup = dict(questions=questions, batch=batch, lengths=lengths, T=T,
                 params=params, model_t=model_t, pipe_j=pipe_j,
                 pipe_t=pipe_t, variances=variances, apply_t=apply_t)
    setup["jax_run"] = _jax_stages(setup)
    return setup


def _jax_draw(seed, T, nb=129):
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(
        jax.random.normal(kr, (T, nb)) + 1j * jax.random.normal(ki,
                                                                 (T, nb))))


def _jax_stages(s, out=None):
    """The JAX pipeline's stages; ``out`` replaces its model stage."""
    model_j, mlpg_j, vocoder_j = s["pipe_j"].stage_jits()
    lengths = jnp.asarray(s["lengths"])
    if out is None:
        out = model_j(s["params"], jnp.asarray(s["batch"]), lengths)
    factors, tau = s["pipe_j"]._factors_for(s["T"])
    smoothed, vuv = mlpg_j(out, lengths, factors, tau)
    f0_cont = jnp.full(s["batch"].shape[:2], 150.0, jnp.float32)
    wavs = vocoder_j(smoothed, vuv, f0_cont, jax.random.PRNGKey(0))
    return np.asarray(out), np.asarray(smoothed), np.asarray(wavs)


def _torch_stages(s, out=None, smoothed=None):
    """The port's stages; ``out`` replaces the model stage, ``smoothed``
    (with its voicing) the MLPG stage."""
    pipe = s["pipe_t"]
    batch, lengths, f0_cont = pipe.prepare(s["batch"], s["lengths"])
    with torch.inference_mode():
        if out is None:
            out = pipe.model_stage(s["model_t"], batch, lengths)
        if smoothed is None:
            smoothed = pipe.mlpg_stage(out, lengths,
                                       *pipe.factors_for(s["T"]))
        wavs = pipe.vocoder_stage(*smoothed, f0_cont,
                                  z=_jax_draw(0, s["T"]))
    return out.numpy(), smoothed[0].numpy(), wavs.numpy()


def _frame_db(wav, hop=80):
    frames = wav[:len(wav) // hop * hop].reshape(-1, hop).astype(np.float64)
    return 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-30)


def _assert_frame_energy_close(wavs_t, wavs_j, lengths, max_db):
    """Waveforms of equal length whose 5 ms frame log-energies agree
    within ``max_db`` on every frame above -60 dB re the loudest one."""
    for i, n in enumerate(lengths):
        wj, wt = wavs_j[i, :n * 80], wavs_t[i, :n * 80]
        assert wt.shape == wj.shape == (n * 80,)
        assert np.isfinite(wt).all()
        db_j, db_t = _frame_db(wj), _frame_db(wt)
        loud = db_j > db_j.max() - 60.0
        assert np.abs(db_t[loud] - db_j[loud]).max() < max_db


def test_mlpg_and_vocoder_stages_match_jax(slice_setup):
    """(a) The JAX model's output through both pipelines' MLPG and
    vocoder stages, with the same noise draw."""
    s = slice_setup
    out_j, smoothed_j, wavs_j = s["jax_run"]
    out = torch.from_numpy(np.array(out_j))
    _, smoothed_t, wavs_t = _torch_stages(s, out)
    valid = np.arange(s["T"])[None, :] < s["lengths"][:, None]
    # MLPG: float32 solves of the same system; the factors' few-ulp
    # differences come out amplified by the system's conditioning.
    # Measured 1.4e-5 of the largest feature.  The padded tail is
    # silenced alike.
    top = np.abs(smoothed_j[valid]).max()
    np.testing.assert_allclose(smoothed_t, smoothed_j, rtol=0,
                               atol=1e-4 * top)
    # Vocoder on the same smoothed features.  The harmonic phase drifts
    # apart linearly in time: each frame adds a float32 sum of 80 phase
    # increments, summed in another order by each library, and harmonic
    # h multiplies the drift h-fold.  So samples are compared over the
    # first 64 frames (measured 9e-4 of peak), whole utterances by frame
    # energy (measured 0.007 dB).
    vuv_j = torch.from_numpy(np.array(out_j[..., 3 * NUM_SPS + 3] > 0.5)
                             & valid)
    _, _, wavs_v = _torch_stages(
        s, out, (torch.from_numpy(np.array(smoothed_j)), vuv_j))
    assert wavs_v.shape == wavs_j.shape == (6, s["T"] * 80)
    head = 64 * 80
    np.testing.assert_allclose(wavs_v[:, :head], wavs_j[:, :head], rtol=0,
                               atol=3e-3 * np.abs(wavs_j).max())
    _assert_frame_energy_close(wavs_v, wavs_j, s["lengths"], 0.05)
    # Chained MLPG + vocoder: measured 0.008 dB.
    _assert_frame_energy_close(wavs_t, wavs_j, s["lengths"], 0.05)


def test_each_package_end_to_end(slice_setup):
    """(b) Each package runs its own model: the model stage agrees at
    bf16 scale; the waveforms agree in length and in frame log-energy,
    a measure blind to the harmonic phase that a bf16-level lf0
    difference shifts over a second of audio."""
    s = slice_setup
    out_j, _, wavs_j = s["jax_run"]
    out_t, _, wavs_t = _torch_stages(s)
    # bf16 FC output, denormalised by the corpus scale: 4 bf16 ulps of
    # the normalised output times the largest scale.  Measured 2 ulps.
    raw_top = np.abs((out_j - s["pipe_j"]._mean) / s["pipe_j"]._scale
                     ).max()
    np.testing.assert_allclose(
        out_t, out_j, rtol=0,
        atol=2.0 ** -6 * raw_top * float(np.max(s["pipe_j"]._scale)))
    # Phase-blind, as in (a); measured 0.02 dB.
    _assert_frame_energy_close(wavs_t, wavs_j, s["lengths"], 0.1)


def test_server_serves_the_port(slice_setup):
    """(c) The port's own SynthesisServer (a copy of the reference's, not
    a re-export) over the port's pipeline answers six concurrent
    requests."""
    from idiaptts_torch.synth import server as torch_server
    assert torch_server.SynthesisServer is not SynthesisServer
    s = slice_setup
    server = torch_server.SynthesisServer(s["pipe_t"], s["model_t"],
                                          max_batch=8, max_wait_ms=100.0)
    results = [None] * len(s["questions"])

    def client(i):
        results[i] = server.synth(s["questions"][i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(s["questions"]))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
    for wav, q in zip(results, s["questions"]):
        assert wav.shape == (len(q) * s["pipe_t"].hop,)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    stats = server.stats()
    assert stats["requests"] == 6
    assert stats["mean_batch_occupancy"] > 1.0


def test_run_pcm_encodes_int16(slice_setup):
    """Loudness normalisation (peak-normalise above 0.85) and PCM16, on
    a pipeline without denormalisation, whose random-weight output is
    loud."""
    s = slice_setup
    pipe = FusedAcousticPipeline(s["apply_t"], s["variances"],
                                 num_coded_sps=NUM_SPS, fs=FS,
                                 bucket=BUCKET, device="cpu")
    questions = s["questions"][:2]
    rows = pipe(s["model_t"], questions, device_output=True).numpy()
    pcm = pipe(s["model_t"], questions, pcm16=True)
    for row, p, q in zip(rows, pcm, questions):
        assert p.dtype == np.int16 and p.shape == (len(q) * 80,)
        # As in the reference's run_pcm, the peak is the padded row's
        # (the last frames' noise overlap-add runs past the trim).
        peak = np.abs(row).max()
        assert peak > 0.85
        expected = (np.clip(row[:len(p)] * np.float32(0.85 / peak), -1.0,
                            1.0) * 32767.0).astype(np.int16)
        # The device path scales in float32 too; allow one LSB.
        assert np.abs(p.astype(np.int32) - expected).max() <= 1
