"""HMM forced state alignment (an offline data preparation tool): the
port of ``idiaptts_tpu/data/alignment.py``.

39-dim MFCC (+delta +delta-delta) features at the label frame rate,
their STFT on a ``device`` (``"cuda"`` unless the caller passes
``"cpu"``) through the port's :mod:`~idiaptts_torch.ops.stft`; 5-state
left-to-right monophone HMMs with diagonal Gaussians, a flat start,
Viterbi (segmental k-means) re-estimation and a constrained-lattice
Viterbi alignment emitting HTK-format state-aligned labels (100 ns
units).  The HMM is numpy on the host, as in the JAX package.
"""

import logging
import os

import numpy as np
import torch

from idiaptts_torch.ops import audio_io, stft as stft_ops
from idiaptts_torch.ops.dispatch import resolve_device
from idiaptts_torch.ops.interpolation import compute_deltas

logger = logging.getLogger(__name__)

_FRAME_NS = 50000  # 100 ns units per 5 ms frame
NUM_STATES = 5


def extract_mfcc(raw, fs, num_ceps=13, frame_shift_ms=5.0, n_mels=26,
                 device="cuda"):
    """39-dim MFCC + deltas + delta-deltas (numpy float32) at the label
    frame rate; the STFT runs on ``device``."""
    hop = int(fs * frame_shift_ms / 1000)
    n_fft = 512
    with torch.inference_mode():
        amp = torch.abs(stft_ops.stft(torch.as_tensor(
            np.asarray(raw, np.float32), device=resolve_device(device)),
            n_fft,
            hop)).cpu().numpy()
    fbank = stft_ops.mel_filterbank(fs, n_fft, n_mels=n_mels)
    logmel = np.log(np.maximum(amp ** 2 @ fbank.T, 1e-10))
    # DCT-II for cepstra.
    n = np.arange(n_mels)
    dct = np.cos(np.pi * np.outer(np.arange(num_ceps), (n + 0.5))
                 / n_mels)
    mfcc = logmel @ dct.T
    d1 = compute_deltas(mfcc)
    d2 = compute_deltas(d1)
    return np.concatenate([mfcc, d1, d2], axis=1).astype(np.float32)


class MonophoneHMMSet:
    """Diagonal-Gaussian 5-state left-to-right monophone HMMs."""

    def __init__(self, phone_list, feat_dim=39):
        self.phones = list(phone_list)
        self.feat_dim = feat_dim
        P = len(self.phones)
        self.means = np.zeros((P, NUM_STATES, feat_dim), np.float64)
        self.variances = np.ones((P, NUM_STATES, feat_dim), np.float64)
        self.index = {p: i for i, p in enumerate(self.phones)}

    # -- flat start (HCompV role) ----------------------------------------
    def flat_start(self, features_list):
        all_feats = np.concatenate(features_list)
        mean = all_feats.mean(0)
        var = np.maximum(all_feats.var(0), 1e-4)
        self.means[:] = mean
        self.variances[:] = var

    def _log_obs(self, feats, phone_seq):
        """(T, F) x phone sequence -> (T, P*S) state log-likelihoods
        for the states in the utterance's linear lattice."""
        state_means = np.concatenate(
            [self.means[self.index[p]] for p in phone_seq])  # (N, F)
        state_vars = np.concatenate(
            [self.variances[self.index[p]] for p in phone_seq])
        diff = feats[:, None, :] - state_means[None]
        ll = -0.5 * (np.sum(diff ** 2 / state_vars[None], axis=2)
                     + np.sum(np.log(2 * np.pi * state_vars), axis=1)
                     [None])
        return ll  # (T, N)

    @staticmethod
    def _viterbi_monotonic(ll):
        """Monotonic left-to-right alignment over the linear state
        lattice: each frame stays or advances one state."""
        T, N = ll.shape
        NEG = -1e30
        delta = np.full((T, N), NEG)
        back = np.zeros((T, N), np.int8)  # 0 = stay, 1 = advance
        delta[0, 0] = ll[0, 0]
        for t in range(1, T):
            stay = delta[t - 1]
            advance = np.concatenate([[NEG], delta[t - 1, :-1]])
            better = advance > stay
            delta[t] = np.where(better, advance, stay) + ll[t]
            back[t] = better
        # Backtrace from the final state.
        states = np.zeros(T, np.int64)
        states[-1] = N - 1
        for t in range(T - 1, 0, -1):
            states[t - 1] = states[t] - back[t, states[t]]
        return states, delta[-1, -1]

    def align_states(self, feats, phone_seq):
        """-> (T,) linear state index in the utterance lattice."""
        ll = self._log_obs(feats, phone_seq)
        states, score = self._viterbi_monotonic(ll)
        return states, score

    def _uniform_states(self, num_frames, num_phones):
        """Equal-duration initial segmentation (replaces the flat-start
        first Viterbi, which degenerates when all states are equal)."""
        total_states = num_phones * NUM_STATES
        return np.minimum((np.arange(num_frames) * total_states)
                          // max(num_frames, 1), total_states - 1)

    # -- training (HERest role, Viterbi/segmental k-means) ---------------
    def train(self, features_list, phone_seqs, num_iterations=4):
        self.flat_start(features_list)
        # Bootstrap statistics from a uniform segmentation.
        acc_sum = np.zeros_like(self.means)
        acc_sq = np.zeros_like(self.means)
        acc_count = np.zeros(self.means.shape[:2], np.float64)
        for feats, phones in zip(features_list, phone_seqs):
            states = self._uniform_states(len(feats), len(phones))
            phone_idx = states // NUM_STATES
            state_idx = states % NUM_STATES
            for t in range(len(feats)):
                p = self.index[phones[phone_idx[t]]]
                s = state_idx[t]
                acc_sum[p, s] += feats[t]
                acc_sq[p, s] += feats[t] ** 2
                acc_count[p, s] += 1
        seen = acc_count > 0
        self.means = np.where(
            seen[..., None],
            acc_sum / np.maximum(acc_count[..., None], 1), self.means)
        self.variances = np.maximum(np.where(
            seen[..., None],
            acc_sq / np.maximum(acc_count[..., None], 1)
            - self.means ** 2, self.variances), 1e-4)

        for iteration in range(num_iterations):
            acc_sum = np.zeros_like(self.means)
            acc_sq = np.zeros_like(self.means)
            acc_count = np.zeros(self.means.shape[:2], np.float64)
            total_score = 0.0
            for feats, phones in zip(features_list, phone_seqs):
                states, score = self.align_states(feats, phones)
                total_score += score / max(len(feats), 1)
                phone_idx = states // NUM_STATES
                state_idx = states % NUM_STATES
                for t in range(len(feats)):
                    p = self.index[phones[phone_idx[t]]]
                    s = state_idx[t]
                    acc_sum[p, s] += feats[t]
                    acc_sq[p, s] += feats[t] ** 2
                    acc_count[p, s] += 1
            seen = acc_count > 0
            mean = np.where(seen[..., None],
                            acc_sum / np.maximum(acc_count[..., None],
                                                 1), self.means)
            var = np.where(
                seen[..., None],
                acc_sq / np.maximum(acc_count[..., None], 1)
                - mean ** 2, self.variances)
            self.means = mean
            self.variances = np.maximum(var, 1e-4)
            logger.info("Alignment iteration %d: avg score %.2f",
                        iteration + 1,
                        total_score / max(len(features_list), 1))
        return self


class ForcedAligner:
    """Corpus-level aligner: MFCCs of each wav on ``device``, HMM training
    and alignment on the host."""

    def __init__(self, phone_list, device="cuda"):
        self.hmms = None
        self.phone_list = list(phone_list)
        self.device = resolve_device(device)

    def train(self, dir_wav, utterances, num_iterations=4,
              frame_shift_ms=5.0):
        """utterances: {id: [phone, ...]} (e.g. from mono labels)."""
        self.features = {}
        for id_name in utterances:
            raw, fs = audio_io.get_raw(os.path.join(
                dir_wav, id_name + ".wav"))
            self.features[id_name] = extract_mfcc(
                raw, fs, frame_shift_ms=frame_shift_ms, device=self.device)
        self.utterances = dict(utterances)
        self.hmms = MonophoneHMMSet(self.phone_list,
                                    next(iter(self.features.values()))
                                    .shape[1])
        self.hmms.train(list(self.features.values()),
                        list(self.utterances.values()),
                        num_iterations)
        return self

    def align(self, id_name, full_labels=None):
        """-> list of HTK state-aligned label lines.

        full_labels: optional full-context label per phone (defaults to
        the mono phone symbol)."""
        feats = self.features[id_name]
        phones = self.utterances[id_name]
        states, _ = self.hmms.align_states(feats, phones)
        labels = full_labels or phones
        lines = []
        boundaries = np.where(np.diff(states))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(states)]])
        for start, end in zip(starts, ends):
            state = states[start]
            phone_idx = state // NUM_STATES
            state_idx = state % NUM_STATES
            lines.append("{} {} {}[{}]".format(
                int(start) * _FRAME_NS, int(end) * _FRAME_NS,
                labels[phone_idx], state_idx + 2))
        return lines

    def align_corpus(self, dir_out):
        os.makedirs(dir_out, exist_ok=True)
        for id_name in self.utterances:
            lines = self.align(id_name)
            with open(os.path.join(dir_out, id_name + ".lab"),
                      "w") as f:
                f.write("\n".join(lines) + "\n")
        return dir_out


def main(argv=None):
    """Corpus forced alignment: wavs + mono phone labels -> HTK
    state-aligned labels.

    Mono label format per utterance (``<id>.lab`` in --dir_mono): one
    phone per line, optionally preceded by HTK start/end times.
    """
    import argparse
    import glob
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("-w", "--dir_wav", required=True)
    parser.add_argument("-m", "--dir_mono", required=True,
                        help="mono phone labels (<id>.lab)")
    parser.add_argument("-o", "--dir_out", required=True)
    parser.add_argument("--num_iterations", type=int, default=4)
    parser.add_argument("--id_list", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.id_list:
        with open(args.id_list) as f:
            ids = [line.strip().split("/")[-1] for line in f
                   if line.strip()]
    else:
        ids = sorted(os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(args.dir_mono,
                                                     "*.lab")))
    utterances = {}
    for id_name in ids:
        with open(os.path.join(args.dir_mono, id_name + ".lab")) as f:
            utterances[id_name] = [line.split()[-1]
                                   for line in f if line.strip()]
    phone_list = sorted({p for seq in utterances.values() for p in seq})
    logging.info("Training monophone HMMs: %d utterances, %d phones",
                 len(utterances), len(phone_list))
    aligner = ForcedAligner(phone_list, device=args.device)
    aligner.train(args.dir_wav, utterances,
                  num_iterations=args.num_iterations)
    aligner.align_corpus(args.dir_out)
    logging.info("State-aligned labels written to %s", args.dir_out)


if __name__ == "__main__":
    main()
