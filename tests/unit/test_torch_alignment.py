"""Parity of the port's forced aligner (``idiaptts_torch.data.
alignment``) with the JAX package's on the fixture corpus.

``extract_mfcc``: the STFT runs in PyTorch, the rest is the same numpy;
the 39-dim features differ by at most 1.2e-4 over the six 16 kHz wavs
(measured on the CPU; bound 1e-3).  ``MonophoneHMMSet`` is the same
numpy code: fed the same features it trains to the same model and
writes the same labels.  Fed each package's own MFCCs, the Viterbi
training's ties decide which state of a phone pair absorbs a stretch of
digital silence (identical feature rows), so a boundary may move across
such a stretch (11 of 160 boundaries, up to 26 frames in gen-0001), and
only across it.
"""

import os

import numpy as np
import pytest
import torch

from idiaptts_tpu.data.alignment import ForcedAligner as JaxAligner
from idiaptts_tpu.data.alignment import MonophoneHMMSet as JaxHMMSet
from idiaptts_tpu.data.alignment import extract_mfcc as jax_mfcc
from idiaptts_tpu.data.phonemes import PhonemeLabelGen
from idiaptts_torch.data.alignment import (ForcedAligner, MonophoneHMMSet,
                                           extract_mfcc, main)
from idiaptts_torch.ops.audio_io import get_raw

MFCC_TOL = 1e-3
IDS = ("gen-0001", "gen-0002", "gen-0003")
FRAME_NS = 50000



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread runs it
    faster when the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def utterances(fixtures_dir):
    label_dir = os.path.join(fixtures_dir, "labels", "mono_no_align")
    return {i: PhonemeLabelGen._load_mono(os.path.join(label_dir,
                                                       i + ".lab"))
            for i in IDS}


@pytest.fixture(scope="module")
def aligners(fixtures_dir, utterances):
    phones = sorted({p for seq in utterances.values() for p in seq})
    wav_dir = os.path.join(fixtures_dir, "database", "wav")
    return (ForcedAligner(phones, device="cpu").train(wav_dir, utterances,
                                                      num_iterations=3),
            JaxAligner(phones).train(wav_dir, utterances, num_iterations=3))


@pytest.mark.parametrize("index", range(1, 7))
def test_extract_mfcc_matches_jax(fixtures_dir, index):
    raw, fs = get_raw(os.path.join(fixtures_dir, "database", "wav",
                                   "gen-000{}.wav".format(index)))
    out = extract_mfcc(raw, fs, device="cpu")
    ref = jax_mfcc(raw, fs)
    assert out.shape == ref.shape and out.shape[1] == 39
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=MFCC_TOL)


def test_hmm_set_on_the_same_features_is_identical(aligners, utterances):
    """The HMM half is numpy in both packages: the JAX aligner's
    features through the port's MonophoneHMMSet give the same model and
    the same state paths."""
    port, ref = aligners
    feats = [ref.features[i] for i in IDS]
    phones = [utterances[i] for i in IDS]
    hmms = MonophoneHMMSet(ref.phone_list, 39).train(feats, phones, 3)
    ref_hmms = JaxHMMSet(ref.phone_list, 39).train(feats, phones, 3)
    np.testing.assert_array_equal(hmms.means, ref_hmms.means)
    np.testing.assert_array_equal(hmms.variances, ref_hmms.variances)
    for f, p in zip(feats, phones):
        states, score = hmms.align_states(f, p)
        ref_states, ref_score = ref_hmms.align_states(f, p)
        np.testing.assert_array_equal(states, ref_states)
        assert score == ref_score


def _bounds(lines):
    return [(int(line.split()[0]) // FRAME_NS,
             int(line.split()[1]) // FRAME_NS, line.split()[2])
            for line in lines]


def test_forced_aligner_matches_jax(aligners, utterances):
    """The same label sequence per utterance; a boundary that moves,
    moves only across identical (digital-silence) feature rows."""
    port, ref = aligners
    moved = 0
    for id_name in IDS:
        lines, ref_lines = port.align(id_name), ref.align(id_name)
        assert [b[2] for b in _bounds(lines)] == [
            b[2] for b in _bounds(ref_lines)]
        assert len(lines) == 5 * len(utterances[id_name])
        feats = port.features[id_name][:, :13]
        for (s, e, _), (s_r, e_r, _) in zip(_bounds(lines),
                                            _bounds(ref_lines)):
            for a, b in ((s, s_r), (e, e_r)):
                lo, hi = min(a, b), max(a, b)
                if hi > lo:
                    moved += 1
                    assert np.all(feats[lo:hi] == feats[lo]), (id_name, a,
                                                               b)
    # 11 boundaries moved (each counted by both segments it bounds);
    # most did not.
    assert moved <= 44


def test_align_corpus_and_main(fixtures_dir, aligners, tmp_path):
    """align_corpus writes one label file an utterance; the command line
    entry point does the whole run."""
    port, _ = aligners
    out_dir = port.align_corpus(str(tmp_path / "aligned"))
    assert sorted(os.listdir(out_dir)) == [i + ".lab" for i in IDS]
    mono = tmp_path / "mono"
    mono.mkdir()
    for id_name in IDS[:2]:
        (mono / (id_name + ".lab")).write_text(
            "\n".join(port.utterances[id_name]) + "\n")
    main(["-w", os.path.join(fixtures_dir, "database", "wav"), "-m",
          str(mono), "-o", str(tmp_path / "cli"), "--num_iterations", "2",
          "--device", "cpu"])
    for id_name in IDS[:2]:
        with open(tmp_path / "cli" / (id_name + ".lab")) as f:
            lines = [line.split() for line in f if line.strip()]
        assert int(lines[0][0]) == 0
        assert all(a[1] == b[0] for a, b in zip(lines, lines[1:]))
