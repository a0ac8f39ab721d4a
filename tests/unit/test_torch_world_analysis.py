"""Parity of the port's WORLD analysis (``idiaptts_torch.ops.world``:
``extract_f0``, ``cheaptrick``, ``d4c_band_aperiodicity``,
``world_analysis``; ``ops.mcep.amp_sp_to_mcep``) with the JAX package's,
on the same numpy waveforms: the six 16 kHz and two 48 kHz fixture wavs
and the edge cases of ``test_world_edge_cases.py`` (silence, a
harmonic tone, white noise, a very short input).

Both sides run float32 on the CPU; their FFTs (pocketfft here, XLA's
own there) round differently, so every bound below is a measured
difference with headroom, stated beside it (measured on the CPU):
- voicing: every frame agreed on every wav and case (bound: 99%);
- voiced F0, relative: at most 4.8e-5 (48 kHz, before the voicing
  refinement), 1.7e-6 at 16 kHz (bound 5e-4);
- CheapTrick, |d ln power|: mean at most 0.020, at most 0.41 in bins
  within 60 dB of the frame's peak (float32 rounding of the smoothing
  FFTs dominates the deep valleys, up to 2.8 below that; bounds 0.05
  and 1.0);
- D4C, |d ln ap|: scaled mean at most 0.0095, max 0.39; raw mean
  0.0019, max 0.073 (bounds 0.03 / 1.0 and 0.01 / 0.25);
- ``amp_sp_to_mcep`` on the same spectra: 1.9e-6 (bound 1e-4);
- ``world_analysis``'s coded spectrum: max 0.056, mean 1.3e-3 (bounds
  0.2 and 5e-3); its bap: max 0.57, mean 0.011 (bounds 1.5 and 0.05).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import mcep as jax_mcep
from idiaptts_tpu.ops.audio_io import get_raw
from idiaptts_tpu.ops.world.extract import world_analysis as jax_analysis
from idiaptts_torch.ops import mcep
from idiaptts_torch.ops.world import (cheaptrick, d4c_band_aperiodicity,
                                      extract_f0)
from idiaptts_torch.ops.world.extract import world_analysis

jax_f0 = importlib.import_module("idiaptts_tpu.ops.world.f0")
jax_ct = importlib.import_module("idiaptts_tpu.ops.world.cheaptrick")
jax_d4c = importlib.import_module("idiaptts_tpu.ops.world.d4c")
f0_mod = importlib.import_module("idiaptts_torch.ops.world.f0")

WAVS = tuple(("wav", "gen-000{}".format(i)) for i in range(1, 7)) + (
    ("wav48", "gen48-0001"), ("wav48", "gen48-0002"))
# The standalone CheapTrick / D4C comparisons at 48 kHz run on the first
# 48 kHz wav (the JAX D4C takes several seconds a wav there).
STAGE_WAVS = WAVS[:7]
FS = 16000

VOICING_AGREEMENT = 0.99
F0_REL_TOL = 5e-4
CT_MEAN_TOL, CT_MAX60_TOL = 0.05, 1.0
D4C_TOL = {True: (0.03, 1.0), False: (0.01, 0.25)}
MCEP_TOL = 1e-4
CODED_MAX_TOL, CODED_MEAN_TOL = 0.2, 5e-3
BAP_MAX_TOL, BAP_MEAN_TOL = 1.5, 0.05



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    faster when the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def wavs(fixtures_dir):
    return {name: get_raw(os.path.join(fixtures_dir, "database", sub,
                                       name + ".wav"))
            for sub, name in WAVS}


@pytest.fixture(scope="module")
def jax_f0s(wavs):
    """The JAX package's refined F0 of each fixture wav: the stages'
    common input."""
    return {name: jax_f0.extract_f0(raw, fs)
            for name, (raw, fs) in wavs.items()}


@pytest.fixture(scope="module")
def analyses(wavs):
    """{id: (JAX (f0, coded, bap), port's)} of ``world_analysis`` with
    20 coded coefficients (the recipes' NUM_SPS) on every fixture wav."""
    return {name: (jax_analysis(raw, fs, 20),
                   world_analysis(raw, fs, 20, device="cpu"))
            for name, (raw, fs) in wavs.items()}


def _edge_cases():
    t = np.arange(FS) / FS
    sig = sum((0.3 / h) * np.sin(2 * np.pi * 220.0 * h * t)
              for h in range(1, 30))
    return {
        "silence": np.zeros(FS, np.float32),
        "tone": (sig / np.abs(sig).max() * 0.5).astype(np.float32),
        "white_noise": (0.1 * np.random.RandomState(0).randn(FS)).astype(
            np.float32),
        "very_short": (0.1 * np.random.RandomState(1).randn(400)).astype(
            np.float32),
    }


def _check_f0(f0, ref):
    assert f0.shape == ref.shape and f0.dtype == np.float32
    voiced, ref_voiced = f0 > 0, ref > 0
    assert (voiced == ref_voiced).mean() >= VOICING_AGREEMENT
    both = voiced & ref_voiced
    if both.any():
        rel = np.abs(f0[both] - ref[both]) / ref[both]
        assert rel.max() < F0_REL_TOL, rel.max()


def _check_features(out, ref):
    (f0, coded, bap), (f0_r, coded_r, bap_r) = out, ref
    _check_f0(f0, f0_r)
    assert coded.shape == coded_r.shape and bap.shape == bap_r.shape
    assert np.isfinite(coded).all() and np.isfinite(bap).all()
    d_coded, d_bap = np.abs(coded - coded_r), np.abs(bap - bap_r)
    assert d_coded.max() < CODED_MAX_TOL, d_coded.max()
    assert d_coded.mean() < CODED_MEAN_TOL, d_coded.mean()
    assert d_bap.max() < BAP_MAX_TOL, d_bap.max()
    assert d_bap.mean() < BAP_MEAN_TOL, d_bap.mean()


@pytest.mark.parametrize("vuv_refine", [True, False])
@pytest.mark.parametrize("name", [name for _, name in WAVS])
def test_extract_f0_matches_jax(wavs, jax_f0s, name, vuv_refine):
    raw, fs = wavs[name]
    ref = jax_f0s[name] if vuv_refine else jax_f0.extract_f0(
        raw, fs, vuv_refine=False)
    _check_f0(extract_f0(raw, fs, vuv_refine=vuv_refine, device="cpu"),
              ref)


@pytest.mark.parametrize("name", [name for _, name in STAGE_WAVS])
def test_cheaptrick_matches_jax(wavs, jax_f0s, name):
    raw, fs = wavs[name]
    f0 = jax_f0s[name]
    ref = np.asarray(jax_ct.cheaptrick(raw, f0, fs))
    out = cheaptrick(raw, f0, fs, device="cpu").numpy()
    assert out.shape == ref.shape == (len(f0),
                                      mcep.fs_to_frame_length(fs) // 2 + 1)
    d = np.abs(np.log(out) - np.log(ref))
    assert d.mean() < CT_MEAN_TOL, d.mean()
    near = ref >= ref.max(axis=1, keepdims=True) * 1e-6
    assert d[near].max() < CT_MAX60_TOL, d[near].max()


@pytest.mark.parametrize("d4c_scale", [True, False])
@pytest.mark.parametrize("name", [name for _, name in STAGE_WAVS])
def test_d4c_matches_jax(wavs, jax_f0s, name, d4c_scale):
    raw, fs = wavs[name]
    f0 = jax_f0s[name]
    ref = np.asarray(jax_d4c.d4c_band_aperiodicity(raw, f0, fs,
                                                   d4c_scale=d4c_scale))
    out = d4c_band_aperiodicity(raw, f0, fs, d4c_scale=d4c_scale,
                                device="cpu").numpy()
    assert out.shape == ref.shape
    assert ((out > 0) & (out <= 1)).all()
    np.testing.assert_array_equal(out[f0 == 0], 1.0)
    d = np.abs(np.log(out) - np.log(ref))
    mean_tol, max_tol = D4C_TOL[d4c_scale]
    assert d.mean() < mean_tol, d.mean()
    assert d.max() < max_tol, d.max()


@pytest.mark.parametrize("name", ["gen-0001", "gen48-0001"])
def test_amp_sp_to_mcep_matches_jax(wavs, jax_f0s, name):
    """The same amplitude spectra through both mel-cepstral analyses
    (least squares, then 32 fixed-Hessian iterations), 60 coefficients."""
    raw, fs = wavs[name]
    amp = np.sqrt(np.asarray(jax_ct.cheaptrick(raw, jax_f0s[name], fs)))
    alpha = mcep.fs_to_mgc_alpha(fs)
    for port_fn, jax_fn in ((mcep.amp_sp_to_mcep, jax_mcep.amp_sp_to_mcep),
                            (mcep.amp_sp_to_mcep_ls,
                             jax_mcep.amp_sp_to_mcep_ls)):
        out = port_fn(torch.from_numpy(amp), 59, alpha).numpy()
        ref = np.asarray(jax_fn(jnp.asarray(amp), 59, alpha))
        np.testing.assert_allclose(out, ref, rtol=0, atol=MCEP_TOL)


def test_min_phase_log_spectrum_matches_jax():
    log_amp = np.random.RandomState(3).randn(4, 513).astype(np.float32)
    out = mcep.min_phase_log_spectrum(torch.from_numpy(log_amp)).numpy()
    ref = np.asarray(jax_mcep.min_phase_log_spectrum(jnp.asarray(log_amp)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", [name for _, name in WAVS])
def test_world_analysis_matches_jax(analyses, name):
    ref, out = analyses[name]
    _check_features(out, ref)
    assert out[2].shape[1] == (1 if name.startswith("gen-") else 5)


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_world_analysis_edge_cases_match_jax(case):
    raw = _edge_cases()[case]
    out = world_analysis(raw, FS, num_coded_sps=20, device="cpu")
    _check_features(out, jax_analysis(raw, FS, num_coded_sps=20))
    f0, coded, bap = out
    assert len(f0) == max(1, 1 + (len(raw) - 1) // 80)
    voiced = f0 > 0
    if case == "tone":
        assert voiced.mean() > 0.8
        assert np.median(np.abs(f0[voiced] - 220.0)) < 3.0
        assert np.median(bap[voiced, 0]) < -5.0
    else:
        assert voiced.mean() < 0.5


def test_f0_matches_generating_parameters(fixtures_dir, id_list, wavs):
    """The port's F0 against the contour the fixture wavs were
    synthesised from, with test_world.py's bounds."""
    for utt in id_list[:3]:
        raw, fs = wavs[utt]
        f0 = extract_f0(raw, fs, device="cpu")
        f0_true = np.load(os.path.join(fixtures_dir, "params",
                                       utt + ".npz"))["f0"]
        n = min(len(f0), len(f0_true))
        both = (f0[:n] > 0) & (f0_true[:n] > 0)
        assert np.median(np.abs(f0[:n][both] - f0_true[:n][both])) < 0.6
        assert ((f0[:n] > 0) == (f0_true[:n] > 0)).mean() > 0.85


def test_top_k_keeps_the_lower_index_among_ties():
    """``jax.lax.top_k``'s order: equal scores keep the lower index
    first.  Rows with many ties at -1 (the non-peaks)."""
    rs = np.random.RandomState(0)
    scores = np.where(rs.rand(16, 60) < 0.1, rs.rand(16, 60),
                      -1.0).astype(np.float32)
    scores[3] = -1.0
    values, lags = f0_mod._top_k_lower_first(torch.from_numpy(scores), 8)
    ref_values, ref_lags = jax.lax.top_k(jnp.asarray(scores), 8)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    np.testing.assert_array_equal(lags.numpy(), np.asarray(ref_lags))


def test_candidates_of_a_frame_with_fewer_than_eight_peaks():
    """A frame with three NCCF peaks: the other five candidates are the
    lowest-index lags tied at -1, as in the JAX package."""
    fs, f0_floor, f0_ceil = 16000, 71.0, 800.0
    lags = np.arange(int(fs / f0_floor) + 2)
    nccf = np.full((2, len(lags)), -0.5, np.float32)
    for lag, peak in ((80, 0.9), (160, 0.7), (200, 0.4)):
        nccf[:, lag - 1:lag + 2] = (0.5 * peak, peak, 0.6 * peak)
    nccf[1] += 0.01 * np.sin(lags).astype(np.float32)
    f0, scores = f0_mod._candidates(torch.from_numpy(nccf), fs, f0_floor,
                                    f0_ceil)
    ref_f0, ref_scores = jax_f0._candidates(jnp.asarray(nccf), fs, f0_floor,
                                            f0_ceil)
    # XLA's division rounds differently by an ulp; a different lag would
    # move f0 by several percent.
    np.testing.assert_allclose(f0.numpy(), np.asarray(ref_f0), rtol=1e-6)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=0, atol=1e-6)
    # Row 0's ties are lags 0, 21, 22, 23, 24 (lag 0 clips to 800 Hz).
    np.testing.assert_allclose(f0.numpy()[0, 3:],
                               [800.0, fs / 21, fs / 22, fs / 23, fs / 24],
                               rtol=1e-6)


@pytest.mark.parametrize("T", [1, 2, 7, 300])
def test_viterbi_matches_jax(T):
    """The same candidates and scores give the same state path (the
    port's backtrace is a doubling scan of gathers)."""
    rs = np.random.RandomState(T)
    f0_cand = (80.0 + 400.0 * rs.rand(T, 8)).astype(np.float32)
    scores = rs.rand(T, 8).astype(np.float32)
    path = f0_mod._viterbi(torch.from_numpy(f0_cand),
                           torch.from_numpy(scores), 0.52, 4.0)
    ref = jax_f0._viterbi(jnp.asarray(f0_cand), jnp.asarray(scores),
                          jnp.float32(0.52), jnp.float32(4.0))
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref))


def test_entry_points_raise_without_cuda(fixtures_dir, tmp_path):
    """The extraction's entry points default to the card and raise
    without one."""
    from idiaptts_torch.data.alignment import ForcedAligner
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    from idiaptts_torch.ops.stft import mfbanks_to_amp_sp
    from idiaptts_torch.ops.world.synthesis import world_synthesis
    raw = np.zeros(800, np.float32)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    f0, sp = np.zeros(11, np.float32), np.ones((11, 513), np.float32)
    for call in (lambda: extract_f0(raw, FS),
                 lambda: cheaptrick(raw, f0, FS),
                 lambda: d4c_band_aperiodicity(raw, f0, FS),
                 lambda: world_analysis(raw, FS),
                 lambda: world_synthesis(f0, sp, sp, FS),
                 lambda: mfbanks_to_amp_sp(np.zeros((11, 20)), FS),
                 lambda: WorldFeatLabelGen(dir_labels=str(tmp_path))
                 .gen_data(os.path.join(fixtures_dir, "database", "wav"),
                           id_list=["gen-0001"]),
                 lambda: ForcedAligner(["a"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
