"""Parity of the port's vocoder ops (idiaptts_torch.ops.mcep,
ops.world.d4c, ops.world.synthesis, synth.pipeline._vocode_one) with the
JAX package's, on the fixture corpus's WORLD features."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idiaptts_tpu.ops import mcep as jax_mcep
from idiaptts_tpu.ops.world import d4c as jax_d4c
from idiaptts_tpu.ops.world import synthesis as jax_syn
from idiaptts_tpu.synth import pipeline as jax_pipeline
from idiaptts_torch.ops import mcep as torch_mcep
from idiaptts_torch.ops.world import d4c as torch_d4c
from idiaptts_torch.ops.world import synthesis as torch_syn
from idiaptts_torch.synth import pipeline as torch_pipeline

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "fixtures",
                        "WORLD")
FS, HOP, ALPHA = 16000, 80, 0.41
T = 64
# Harmonic-part waveform tolerance, relative to the waveform's peak;
# measured 7e-5 (see test_harmonic_part_mcep_matches_jax).
PHASE_TOL = 3e-4


def _features(utt="gen-0001", start=40):
    def load(kind, key):
        with np.load(os.path.join(FIXTURES, kind, utt + ".npz")) as f:
            return f[key][start:start + T].astype(np.float32)
    coded = load("mcep20", "mcep")
    lf0 = load("lf0", "lf0")[:, 0]
    vuv = load("vuv", "vuv")[:, 0] > 0.5
    bap = load("bap", "bap")
    f0 = np.where(vuv, np.exp(lf0), 0.0).astype(np.float32)
    f0_cont = np.exp(lf0).astype(np.float32)
    return coded, lf0, vuv, bap, f0, f0_cont


def _jax_draw(key, nb):
    kr, ki = jax.random.split(key)
    return np.array(jax.random.normal(kr, (T, nb))
                    + 1j * jax.random.normal(ki, (T, nb)))


@pytest.mark.parametrize("num_bins", [129, 513])
def test_mcep_to_amp_sp_matches_jax(num_bins):
    coded = _features()[0]
    ref = np.asarray(jax_mcep.mcep_to_amp_sp(jnp.asarray(coded), num_bins,
                                             ALPHA))
    out = torch_mcep.mcep_to_amp_sp(torch.from_numpy(coded), num_bins,
                                    ALPHA).numpy()
    # exp of a float32 basis matmul (20 terms) in another summation
    # order: a few float32 ulps of the log amplitude, relative after exp.
    # Measured 5e-6 relative.
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=0)
    log_ref = np.asarray(jax_mcep.mcep_to_log_amp_sp(
        jnp.asarray(coded), num_bins, ALPHA))
    np.testing.assert_allclose(
        torch_mcep.mcep_to_log_amp_sp(torch.from_numpy(coded), num_bins,
                                      ALPHA).numpy(),
        log_ref, rtol=0, atol=2e-5 * np.abs(log_ref).max())


def test_merlin_post_filter_matches_jax():
    coded = _features()[0]
    ref = np.asarray(jax_mcep.merlin_post_filter(jnp.asarray(coded),
                                                 ALPHA))
    out = torch_mcep.merlin_post_filter(torch.from_numpy(coded),
                                        ALPHA).numpy()
    # c0 correction is half the log ratio of two 513-bin energy sums.
    # Measured 5e-7.
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_bins", [129, 513])
def test_decode_aperiodicity_matches_jax(num_bins):
    bap = _features()[3]
    ref = np.asarray(jax_d4c.decode_aperiodicity(jnp.asarray(bap),
                                                 num_bins, FS))
    out = torch_d4c.decode_aperiodicity(torch.from_numpy(bap), num_bins,
                                        FS).numpy()
    # Same piecewise-linear log interpolation; linspace and the weights
    # may differ by an ulp, exp makes that relative.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-12)


def test_harmonic_part_mcep_matches_jax():
    coded, _, _, bap, f0, f0_cont = _features()
    ref = np.asarray(jax_syn._harmonic_part_mcep(
        jnp.asarray(f0), jnp.asarray(f0_cont), jnp.asarray(coded),
        jnp.asarray(bap), FS, HOP, ALPHA, 112))
    out = torch_syn._harmonic_part_mcep(
        torch.from_numpy(f0), torch.from_numpy(f0_cont),
        torch.from_numpy(coded), torch.from_numpy(bap), FS, HOP, ALPHA,
        112).numpy()
    assert out.shape == (T * HOP,)
    # PHASE_TOL: the port accumulates frame offsets in float64, the
    # reference wraps a float32 carry per frame (a random walk of float32
    # roundings), so the phases part by ~1e-7 cycles over 64 frames,
    # which harmonic h multiplies h-fold.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=PHASE_TOL * np.abs(ref).max())


def test_noise_part_with_jax_draw_matches_jax():
    coded, _, _, bap, f0, _ = _features()
    nb = 129
    amp = np.array(jax_mcep.mcep_to_amp_sp(jnp.asarray(coded), nb, ALPHA))
    ap = np.array(jax_d4c.decode_aperiodicity(jnp.asarray(bap), nb, FS))
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_syn._noise_part(
        jnp.asarray(f0), jnp.asarray(amp ** 2), jnp.asarray(ap), FS, HOP,
        key))
    out = torch_syn._noise_part(
        torch.from_numpy(f0), torch.from_numpy(amp ** 2),
        torch.from_numpy(ap), FS, HOP, z=torch.from_numpy(_jax_draw(key,
                                                                   nb))
    ).numpy()
    # Same draw, same scaling; irfft in another library (float32).
    # Measured 2e-7 of peak.
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_noise_part_draws_from_generator():
    coded, _, _, bap, f0, _ = _features()
    nb = 129
    sp = torch_mcep.mcep_to_amp_sp(torch.from_numpy(coded), nb, ALPHA) ** 2
    ap = torch_d4c.decode_aperiodicity(torch.from_numpy(bap), nb, FS)
    a, b, c = (torch_syn._noise_part(torch.from_numpy(f0), sp, ap, FS, HOP,
                                     generator=torch.Generator()
                                     .manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        torch_syn._noise_part(torch.from_numpy(f0), sp, ap, FS, HOP)


def test_vocode_batched_matches_jax_per_utterance():
    """The port writes the batch dim out; the reference vmaps one
    utterance body with one shared key.  Same draw in both."""
    feats = [_features("gen-0001"), _features("gen-0002", start=100)]
    key = jax.random.PRNGKey(0)
    refs = [np.asarray(jax_pipeline._vocode_one(
        jnp.asarray(coded), jnp.asarray(lf0), jnp.asarray(vuv),
        jnp.asarray(bap), jnp.asarray(f0_cont), key, FS, HOP, 513, ALPHA,
        112)) for coded, lf0, vuv, bap, _, f0_cont in feats]
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*feats)]
    coded, lf0, vuv, bap, _, f0_cont = stacked
    out = torch_pipeline._vocode_one(
        coded, lf0, vuv, bap, f0_cont, FS, HOP, 513, ALPHA, 112,
        z=torch.from_numpy(_jax_draw(key, 129))).numpy()
    assert out.shape == (2, T * HOP)
    for o, r in zip(out, refs):
        # Harmonic phase as above; the noise part is 1e-7 of peak.
        np.testing.assert_allclose(o, r, rtol=0,
                                   atol=PHASE_TOL * np.abs(r).max())
