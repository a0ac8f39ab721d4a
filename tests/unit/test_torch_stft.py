"""Parity of the port's STFT ops (``idiaptts_torch.ops.stft``), the
``AudioProcessing`` facade, the non-cepstral spectrum decodings and the
amplitude-spectrum WORLD synthesis (``world_synthesis``,
``world_features_to_raw``) with the JAX package's, on the same numpy
inputs.  Random draws are inputs: Griffin-Lim gets the JAX package's
initial angles, the synthesis its complex noise draw.

Measured differences (on the CPU) and the bounds held:
- ``stft``: 1.3e-7 of the spectrum's peak (bound 1e-6); ``istft``
  1.8e-7 absolute (bound 1e-6);
- ``griffin_lim``, 50 iterations from the same angles: 1.4e-5 on a 0.61
  peak (bound 1e-4);
- ``mfbanks_to_amp_sp`` (30 NNLS iterations): 2.6e-4 of the frame's
  peak (bound 1e-3);
- ``world_synthesis`` of a fixture's CheapTrick envelope: 4.1e-4 on a
  0.70 peak sample by sample over the first 64 frames (the port keeps
  the harmonic phase offsets in float64; ROADMAP fault 3.5; bound
  2e-3), frame energies 5.0e-4 dB apart over the whole utterance
  (frames within 60 dB of the loudest; bound 0.01 dB).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.data.audio_processing import AudioProcessing as JaxAP
from idiaptts_tpu.data.world_feat import WorldFeatLabelGen as JaxWorld
from idiaptts_tpu.ops import stft as jax_stft
from idiaptts_tpu.ops.audio_io import get_raw
from idiaptts_tpu.ops.world import synthesis as jax_synthesis
from idiaptts_tpu.ops.world.d4c import (code_aperiodicity as jax_code,
                                        decode_aperiodicity as jax_decode)
from idiaptts_torch.data.audio_processing import AudioProcessing
from idiaptts_torch.data.world_feat import WorldFeatLabelGen
from idiaptts_torch.ops import stft
from idiaptts_torch.ops.world.synthesis import world_synthesis

jax_f0 = importlib.import_module("idiaptts_tpu.ops.world.f0")
jax_ct = importlib.import_module("idiaptts_tpu.ops.world.cheaptrick")
jax_d4c = importlib.import_module("idiaptts_tpu.ops.world.d4c")

STFT_TOL = 1e-6
GL_TOL = 1e-4
MFBANKS_TOL = 1e-3
MCEP_STFT_TOL = 1e-2
SPAN_FRAMES, SPAN_TOL = 64, 2e-3
FRAME_DB_TOL = 0.01



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    faster when the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def wav16(fixtures_dir):
    return get_raw(os.path.join(fixtures_dir, "database", "wav",
                                "gen-0001.wav"))


@pytest.fixture(scope="module")
def world_inputs(fixtures_dir):
    """{fs: (f0, power envelope, decoded aperiodicity)} from the JAX
    analysis of a 16 kHz and a 48 kHz fixture wav."""
    out = {}
    for sub, name in (("wav", "gen-0002"), ("wav48", "gen48-0001")):
        raw, fs = get_raw(os.path.join(fixtures_dir, "database", sub,
                                       name + ".wav"))
        f0 = jax_f0.extract_f0(raw, fs)
        sp = np.asarray(jax_ct.cheaptrick(raw, f0, fs))
        bap = jax_code(jax_d4c.d4c_band_aperiodicity(raw, f0, fs))
        ap = np.asarray(jax_decode(bap, sp.shape[1], fs))
        out[fs] = (f0, sp, ap, np.asarray(bap))
    return out


def _jax_noise(T, num_bins, seed=0):
    """The complex draw of the JAX package's ``_noise_part``."""
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(kr, (T, num_bins)))
            + 1j * np.asarray(jax.random.normal(ki, (T, num_bins)))).astype(
                np.complex64)


def _frame_db(wav, hop):
    return 10.0 * np.log10(np.mean(wav.reshape(-1, hop) ** 2, axis=1)
                           + 1e-10)


def _check_waveform(wav, ref, hop):
    assert wav.shape == ref.shape and np.isfinite(wav).all()
    span = SPAN_FRAMES * hop
    assert np.abs(wav[:span] - ref[:span]).max() < SPAN_TOL
    db, db_ref = _frame_db(wav, hop), _frame_db(ref, hop)
    loud = db_ref > db_ref.max() - 60.0
    assert np.abs(db - db_ref)[loud].max() < FRAME_DB_TOL


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 80, None), (512, 80, 400),
                                           (1024, 256, None),
                                           (512, 128, 320)])
def test_stft_and_istft_match_jax(wav16, n_fft, hop, win):
    raw = wav16[0]
    ref = np.asarray(jax_stft.stft(jnp.asarray(raw), n_fft, hop, win))
    spec = stft.stft(torch.from_numpy(raw), n_fft, hop, win).numpy()
    assert spec.shape == ref.shape
    assert np.abs(spec - ref).max() < STFT_TOL * np.abs(ref).max()
    np.testing.assert_allclose(
        stft.amp_spectrum(torch.from_numpy(raw), n_fft, hop, win).numpy(),
        np.abs(ref), rtol=0, atol=STFT_TOL * np.abs(ref).max())
    back = stft.istft(torch.from_numpy(ref.copy()), n_fft, hop, win,
                      len(raw)).numpy()
    ref_back = np.asarray(jax_stft.istft(jnp.asarray(ref), n_fft, hop, win,
                                         len(raw)))
    np.testing.assert_allclose(back, ref_back, rtol=0, atol=STFT_TOL)
    # Without a length: hop * (frames - 1) samples, as librosa.
    assert stft.istft(torch.from_numpy(ref.copy()), n_fft, hop,
                      win).shape == (
        hop * (len(ref) - 1),)


@pytest.mark.parametrize("n", [1000, 100, 2, 1])
def test_frame_signal_and_window_match_jax(wav16, n):
    """Framing, also of signals shorter than the centre padding (the
    reflection repeats, as numpy's does)."""
    raw = wav16[0][:n].copy()
    for center in (True, False):
        if not center and n < 256:
            continue
        np.testing.assert_array_equal(
            stft.frame_signal(torch.from_numpy(raw), 256, 64,
                              center).numpy(),
            np.asarray(jax_stft.frame_signal(jnp.asarray(raw), 256, 64,
                                             center)))
    np.testing.assert_allclose(stft.hann_window(400).numpy(),
                               np.asarray(jax_stft.hann_window(400)),
                               rtol=0, atol=1e-7)


def test_griffin_lim_with_the_jax_angles(wav16):
    raw = wav16[0]
    amp = np.abs(np.asarray(jax_stft.stft(jnp.asarray(raw), 1024, 256)))
    angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                           amp.shape, minval=-np.pi,
                                           maxval=np.pi))
    ref = np.asarray(jax_stft.griffin_lim(jnp.asarray(amp), 1024, 256,
                                          num_iters=50, length=len(raw)))
    out = stft.griffin_lim(torch.from_numpy(amp), 1024, 256, num_iters=50,
                           length=len(raw), angles=angles).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=GL_TOL)
    gen = torch.Generator().manual_seed(0)
    drawn = stft.griffin_lim(torch.from_numpy(amp), 1024, 256, num_iters=2,
                             generator=gen)
    assert drawn.shape == (256 * (len(amp) - 1),)
    with pytest.raises(ValueError, match="generator or angles"):
        stft.griffin_lim(torch.from_numpy(amp), 1024, 256)


@pytest.mark.parametrize("fs,n_fft,n_mels", [(16000, 1024, 20),
                                             (16000, 512, 80),
                                             (48000, 2048, 60)])
def test_mel_scale_and_filterbank_match_jax(fs, n_fft, n_mels):
    np.testing.assert_array_equal(
        stft.mel_filterbank(fs, n_fft, n_mels=n_mels),
        jax_stft.mel_filterbank(fs, n_fft, n_mels=n_mels))
    hz = np.linspace(0.0, fs / 2.0, 97)
    np.testing.assert_array_equal(stft.hz_to_mel(hz), jax_stft.hz_to_mel(hz))
    np.testing.assert_array_equal(stft.mel_to_hz(stft.hz_to_mel(hz)),
                                  jax_stft.mel_to_hz(jax_stft.hz_to_mel(hz)))


def _mfbanks(fixtures_dir):
    (coded, _, _, _), _ = JaxWorld.extract_features(
        os.path.join(fixtures_dir, "database", "wav"), "gen-0001",
        num_coded_sps=20, sp_type="mfbanks")
    return coded


def test_mfbanks_to_amp_sp_matches_jax(fixtures_dir):
    coded = _mfbanks(fixtures_dir)
    ref = np.asarray(jax_stft.mfbanks_to_amp_sp(coded, 16000))
    out = stft.mfbanks_to_amp_sp(coded, 16000, device="cpu").numpy()
    assert out.shape == ref.shape == (len(coded), 513)
    rel = np.abs(out - ref) / ref.max(axis=1, keepdims=True)
    assert rel.max() < MFBANKS_TOL, rel.max()
    db = np.array([-20.0, 0.0, 6.0])
    np.testing.assert_allclose(stft.db_to_amp(torch.from_numpy(db)).numpy(),
                               np.asarray(jax_stft.db_to_amp(db)), rtol=1e-6)
    amp = np.array([1e-12, 0.1, 2.0], np.float32)
    np.testing.assert_allclose(stft.amp_to_db(torch.from_numpy(amp)).numpy(),
                               np.asarray(jax_stft.amp_to_db(amp)), rtol=1e-6)


@pytest.mark.parametrize("sp_type,post", [("mcep", False), ("mcep", True),
                                          ("mgc", False), ("mfbanks", False),
                                          ("amp_sp", False)])
def test_decode_sp_matches_jax(fixtures_dir, sp_type, post):
    if sp_type == "mfbanks":
        coded = _mfbanks(fixtures_dir)
    else:
        coded = np.random.RandomState(2).randn(50, 20).astype(np.float32)
        coded[:, 0] -= 4.0
        if sp_type == "amp_sp":
            coded = np.exp(coded)
    out = WorldFeatLabelGen.decode_sp(coded, sp_type=sp_type, fs=16000,
                                      post_filtering=post, device="cpu")
    ref = np.asarray(JaxWorld.decode_sp(coded, sp_type=sp_type, fs=16000,
                                        post_filtering=post))
    assert out.shape == ref.shape
    rel = np.abs(out - ref) / ref.max(axis=1, keepdims=True)
    assert rel.max() < MFBANKS_TOL, rel.max()
    with pytest.raises(NotImplementedError, match="Unknown feature type"):
        WorldFeatLabelGen.decode_sp(coded, sp_type="lpc", fs=16000,
                                    device="cpu")


@pytest.mark.parametrize("fs", [16000, 48000])
def test_world_synthesis_matches_jax(world_inputs, fs):
    f0, sp, ap, _ = world_inputs[fs]
    ref = np.asarray(jax_synthesis.world_synthesis(f0, sp, ap, fs))
    out = world_synthesis(f0, sp, ap, fs, z=_jax_noise(*sp.shape),
                          device="cpu").numpy()
    _check_waveform(out, ref, fs // 200)


def test_world_features_to_raw_matches_jax(world_inputs):
    """amplitude spectrum + lf0 + vuv + coded bap -> waveform."""
    f0, sp, _, bap = world_inputs[16000]
    lf0 = np.log(np.maximum(f0, 1e-10)).astype(np.float32)
    vuv = (f0 > 0).astype(np.float32)
    amp = np.sqrt(sp)
    ref = JaxWorld.world_features_to_raw(amp, lf0, vuv, bap, 16000)
    out = WorldFeatLabelGen.world_features_to_raw(
        amp, lf0, vuv, bap, 16000, z=_jax_noise(*sp.shape), device="cpu")
    _check_waveform(out, np.asarray(ref), 80)
    seeded = WorldFeatLabelGen.world_features_to_raw(amp, lf0, vuv, bap,
                                                     16000, device="cpu")
    assert seeded.shape == out.shape and np.isfinite(seeded).all()


def test_audio_processing_matches_jax(wav16, fixtures_dir):
    raw, fs = wav16
    ap = AudioProcessing
    assert ap.fs_to_mgc_alpha(fs) == JaxAP.fs_to_mgc_alpha(fs)
    assert ap.fs_to_frame_length(48000) == JaxAP.fs_to_frame_length(48000)
    assert ap.fs_to_num_bap(48000) == JaxAP.fs_to_num_bap(48000) == 5
    np.testing.assert_array_equal(ap.framing(raw[:900], 400, 80),
                                  JaxAP.framing(raw[:900], 400, 80))
    emph = ap.preemphasis(raw)
    np.testing.assert_array_equal(emph, JaxAP.preemphasis(raw))
    np.testing.assert_array_equal(ap.depreemphasis(emph),
                                  JaxAP.depreemphasis(emph))
    amp = ap.librosa_extract_amp_sp(raw, fs, device="cpu")
    amp_j = JaxAP.librosa_extract_amp_sp(raw, fs)
    np.testing.assert_allclose(amp, amp_j, rtol=0,
                               atol=STFT_TOL * amp_j.max())
    mel = ap.extract_mfbanks(amp_sp=amp_j, fs=fs, num_coded_sps=20,
                             device="cpu")
    np.testing.assert_array_equal(mel, JaxAP.extract_mfbanks(
        amp_sp=amp_j, fs=fs, num_coded_sps=20))
    np.testing.assert_allclose(
        ap.extract_mfbanks(raw, fs, num_coded_sps=20, device="cpu"), mel,
        rtol=0, atol=1e-5 * mel.max())
    rel = np.abs(ap.mfbanks_to_amp_sp(mel, fs, device="cpu")
                 - JaxAP.mfbanks_to_amp_sp(mel, fs))
    assert rel.max() < MFBANKS_TOL * JaxAP.mfbanks_to_amp_sp(mel, fs).max()
    # Mel-cepstra of raw STFT magnitudes (harmonic ripple and deep
    # valleys, unlike a CheapTrick envelope): 2.9e-3 apart (bound 1e-2).
    mcep = ap.extract_mcep(amp_j + 1e-3, 20, 0.41, device="cpu")
    np.testing.assert_allclose(
        mcep, JaxAP.extract_mcep(amp_j + 1e-3, 20, 0.41), rtol=0,
        atol=MCEP_STFT_TOL)
    np.testing.assert_allclose(
        ap.extract_mgc(amp_j + 1e-3, 20, fs, device="cpu"),
        JaxAP.extract_mgc(amp_j + 1e-3, 20, fs), rtol=0,
        atol=MCEP_STFT_TOL)
    for fn in ("mcep_to_amp_sp", "mgc_to_amp_sp"):
        np.testing.assert_allclose(
            getattr(ap, fn)(mcep, fs, device="cpu"),
            getattr(JaxAP, fn)(mcep, fs), rtol=1e-4)
    np.testing.assert_allclose(
        ap.decode_sp(mel, "mfbanks", fs, device="cpu"),
        JaxAP.decode_sp(mel, "mfbanks", fs), rtol=0,
        atol=MFBANKS_TOL * JaxAP.decode_sp(mel, "mfbanks", fs).max())
    np.testing.assert_allclose(ap.amp_to_db(amp[:3]),
                               JaxAP.amp_to_db(amp[:3]), rtol=1e-5)
    np.testing.assert_allclose(ap.db_to_amp(-amp[:3]),
                               JaxAP.db_to_amp(-amp[:3]), rtol=1e-5)
    # Griffin-Lim with de-emphasis, from the JAX package's angles.
    angles = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), amp_j.shape, minval=-np.pi, maxval=np.pi))
    wav = ap.amp_sp_to_raw(amp_j, fs, num_iters=10, angles=angles,
                           device="cpu")
    wav_j = JaxAP.amp_sp_to_raw(amp_j, fs, num_iters=10)
    np.testing.assert_allclose(wav, wav_j, rtol=0, atol=GL_TOL)
