"""Batch-split serving of the port (``FusedAcousticPipeline(devices=...)``,
the JAX pipeline's ``mesh`` branch) on two CPU "devices" against one,
and against the JAX pipeline over a two-device mesh.

The split run's waveforms equal the one-device run's sample for sample
(each device runs its rows through the same stages and draws the same
noise from the seed).  Against the JAX mesh pipeline on the same linear
model, frame log-energies agree within 0.05 dB (the harmonic phase of
the two packages drifts apart with their float32 sums, ROADMAP fault
3.5; measured in ``test_torch_pipeline.py`` as 0.008 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.parallel.mesh import make_data_mesh
from idiaptts_tpu.synth.pipeline import FusedAcousticPipeline as JaxPipeline
from idiaptts_torch.models import rnn_dyn as torch_rnn
from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
from idiaptts_torch.synth.server import SynthesisServer

D, NB, NQ = 20, 1, 33


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU path is many small ops: one intra-op thread runs it
    faster, above all beside the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0, B=4):
    rng = np.random.RandomState(seed)
    W = (rng.randn(NQ, 3 * (D + 1 + NB) + 1) * 0.01).astype(np.float32)
    variances = {"sp": np.abs(rng.randn(3 * D)) + 0.1,
                 "lf0": np.abs(rng.randn(3)) + 0.1,
                 "bap": np.abs(rng.randn(3 * NB)) + 0.1}
    questions = [rng.randn(100 + 10 * i, NQ).astype(np.float32)
                 for i in range(B)]
    return W, variances, questions


def _linear(params, q, lengths):
    return q @ params["W"]


def _pipelines(variances, **kw):
    one = FusedAcousticPipeline(_linear, variances, num_coded_sps=D,
                                fs=16000, device="cpu", **kw)
    two = FusedAcousticPipeline(_linear, variances, num_coded_sps=D,
                                fs=16000, devices=["cpu", "cpu"], **kw)
    return one, two


def test_split_equals_one_device():
    W, variances, questions = _setup()
    one, two = _pipelines(variances)
    params = {"W": torch.from_numpy(W)}
    ref = one(params, questions, seed=3)
    got = two(params, questions, seed=3)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # Each device keeps its own factor cache.
    assert all(shard._factor_cache for shard in two._shards)
    assert not two._factor_cache


def test_module_params_follow_in_place_changes():
    """A module already on a shard's device is used as it stands, with
    no copy, so an in-place change of its weights shows in the next
    call."""
    cfg = torch_rnn.convert_legacy_string("RNNDYN-1_RELU_16-1_BiLSTM_16-"
                                          "1_FC_67", NQ)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    model = cfg.create_model()
    _, variances, questions = _setup(1)

    def apply(m, q, lengths):
        return m({"questions": q}, lengths=lengths)["pred"]

    one = FusedAcousticPipeline(apply, variances, num_coded_sps=D,
                                device="cpu")
    two = FusedAcousticPipeline(apply, variances, num_coded_sps=D,
                                devices=["cpu", "cpu"])
    for _ in range(2):
        ref = one(model, questions, seed=1)
        got = two(model, questions, seed=1)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert all(two._replica(i, model) is model for i in range(2))
        assert two._replicas == [None, None]
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)


def test_f0_cont_given_as_a_tensor():
    """``f0_cont`` as a tensor splits as the one-device path takes it,
    with no trip through numpy.  The denormalisation voices every frame,
    so the contour reaches the harmonic part."""
    W, variances, questions = _setup(6)
    mean = np.zeros(3 * (D + 1 + NB) + 1, np.float32)
    mean[3 * D], mean[3 * D + 3], mean[3 * D + 4] = 5.0, 1.0, -30.0
    one, two = _pipelines(variances, mean=mean, scale=np.ones_like(mean))
    params = {"W": torch.from_numpy(W)}
    T = 256
    f0 = torch.from_numpy(np.random.RandomState(6).uniform(
        90.0, 220.0, (len(questions), T)).astype(np.float32))
    ref = one(params, questions, f0_cont=f0, seed=2)
    got = two(params, questions, f0_cont=f0, seed=2)
    flat = two(params, questions, seed=2)
    for a, b, c in zip(got, ref, flat):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def test_nondivisible_batch_runs_whole_and_pcm16_refused():
    """Three rows over two devices run on the first, unsplit; pcm16 over
    a split batch is refused, as the JAX pipeline refuses it over a
    mesh."""
    W, variances, questions = _setup(2, B=3)
    one, two = _pipelines(variances)
    params = {"W": torch.from_numpy(W)}
    for a, b in zip(two(params, questions), one(params, questions)):
        np.testing.assert_array_equal(a, b)
    assert not any(shard._factor_cache for shard in two._shards)
    with pytest.raises(ValueError, match="single-device"):
        two(params, questions[:2], pcm16=True)


def test_padded_tail_is_silent():
    """The untrimmed split output: past each row's frames the waveform
    stays as quiet as the one-device run's (the silenced padding), and
    equal to it."""
    W, variances, questions = _setup(3)
    one, two = _pipelines(variances)
    params = {"W": torch.from_numpy(W)}
    got = two(params, questions, device_output=True).numpy()
    ref = one(params, questions, device_output=True).numpy()
    np.testing.assert_array_equal(got, ref)
    for row, q in zip(got, questions):
        body, tail = row[:len(q) * two.hop], row[len(q) * two.hop + 400:]
        assert np.abs(tail).max() < 1e-3 * np.abs(body).max()


def test_split_matches_jax_mesh_pipeline():
    """The JAX pipeline over a two-device mesh against the port over two
    devices, same linear model, by frame energy.  The denormalisation
    makes every frame voiced at ~150 Hz with bap -30 dB, so the harmonic
    part dominates the two packages' different noise draws."""
    if len(jax.devices()) < 2:
        pytest.skip("needs two virtual CPU devices")
    W, variances, questions = _setup(4)
    mean = np.zeros(3 * (D + 1 + NB) + 1, np.float32)
    mean[3 * D], mean[3 * D + 3], mean[3 * D + 4] = 5.0, 1.0, -30.0
    scale = np.ones_like(mean)
    ref = JaxPipeline(lambda p, q, lengths: q @ p["W"], variances,
                      num_coded_sps=D, fs=16000, mean=mean, scale=scale,
                      mesh=make_data_mesh(2))({"W": jnp.asarray(W)},
                                              questions)
    _, two = _pipelines(variances, mean=mean, scale=scale)
    got = two({"W": torch.from_numpy(W)}, questions)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        hop = 80
        db = [10 * np.log10(np.mean(w[:len(w) // hop * hop].reshape(
            -1, hop).astype(np.float64) ** 2, axis=1) + 1e-30)
            for w in (a, np.asarray(b))]
        loud = db[1] > db[1].max() - 60.0
        assert np.abs(db[0][loud] - db[1][loud]).max() < 0.05


def test_server_serves_the_split_pipeline():
    W, variances, questions = _setup(5)
    _, two = _pipelines(variances)
    server = SynthesisServer(two, {"W": torch.from_numpy(W)}, max_batch=4,
                             max_wait_ms=50.0)
    try:
        futures = [server.submit(q) for q in questions]
        wavs = [f.result(timeout=120) for f in futures]
    finally:
        server.shutdown()
    for wav, q in zip(wavs, questions):
        assert wav.shape == (len(q) * two.hop,) and np.isfinite(wav).all()
