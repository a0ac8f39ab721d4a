"""The one general traffic generator: every mix is a data file
(``traffic/<mix>.json``) of parameters that these functions read.

Lengths follow LJSpeech-1.1's published clip durations (13,100 clips,
1.11-10.10 s, mean 6.57 s, heavy toward long clips), fitted by a Beta
distribution on [min_s, max_s] whose parameters the mix file gives.
Every seed gets the same multiset of lengths (the distribution's
quantiles at (i + 1/2) / n) and the same arrival gaps (the exponential
distribution's quantiles), each in another order; what the seed changes
is the order and the features drawn, not the amount of work.

Question features are HTS-style rows, one a 5 ms frame: binary
questions held over each phone plus numeric subphone columns (position
in the phone forward and backward, the phone's length and per-phone
values).  Training targets are normalised acoustic features, one
Gaussian vector a phone with the voicing column at +-1.
"""

import numpy as np
from scipy import special

from pb.util import sub_seed

# A phone lasts 3 to 40 frames (15-200 ms), 16 on average.
PHONE_FRAMES = (3, 40, 16.0)


def length_grid(lengths, n):
    """``n`` utterance lengths in frames: the quantiles of the mix's
    fitted duration distribution at (i + 1/2) / n, ascending."""
    u = (np.arange(n) + 0.5) / n
    x = special.betaincinv(float(lengths["a"]), float(lengths["b"]), u)
    seconds = float(lengths["min_s"]) + x * (float(lengths["max_s"])
                                             - float(lengths["min_s"]))
    return np.rint(seconds / float(lengths["frame_s"])).astype(np.int64)


def seeded_lengths(mix, seed, n=None):
    """The mix's pool of lengths in the seed's order."""
    n = int(mix["pool"] if n is None else n)
    grid = length_grid(mix["lengths"], n)
    rng = np.random.default_rng(sub_seed(seed, "length-order"))
    return grid[rng.permutation(n)]


def _phones(rng, frames):
    """Phone durations covering ``frames`` frames."""
    lo, hi, mean = PHONE_FRAMES
    count = int(frames / mean) + 8
    durs = np.clip(np.rint(rng.exponential(mean - lo, count) + lo), lo,
                   hi).astype(np.int64)
    while durs.sum() < frames:
        durs = np.concatenate([durs, durs])
    ends = np.cumsum(durs)
    n = int(np.searchsorted(ends, frames)) + 1
    durs = durs[:n].copy()
    durs[-1] -= ends[n - 1] - frames
    return durs


def questions(rng, frames, binary, numeric, density):
    """One utterance's (frames, binary + numeric) float32 question rows."""
    durs = _phones(rng, frames)
    n = len(durs)
    phone_bits = (rng.random((n, binary)) < density).astype(np.float32)
    rows = np.empty((frames, binary + numeric), np.float32)
    rows[:, :binary] = np.repeat(phone_bits, durs, axis=0)
    start = np.repeat(np.cumsum(durs) - durs, durs)
    pos = np.arange(frames) - start
    length = np.repeat(durs, durs).astype(np.float32)
    rows[:, binary] = (pos + 0.5) / length
    if numeric > 1:
        rows[:, binary + 1] = 1.0 - rows[:, binary]
    if numeric > 2:
        rows[:, binary + 2] = length / PHONE_FRAMES[1]
    if numeric > 3:
        rows[:, binary + 3:] = np.repeat(
            rng.random((n, numeric - 3)).astype(np.float32), durs, axis=0)
    return rows, durs


def targets(rng, durs, width, vuv_column):
    """Normalised acoustic targets (frames, width) float32: a Gaussian
    vector a phone, the voicing column at +-1."""
    phone = rng.standard_normal((len(durs), width)).astype(np.float32)
    if vuv_column is not None:
        phone[:, vuv_column] = np.where(phone[:, vuv_column] > 0, 1.0,
                                        -1.0)
    return np.repeat(phone, durs, axis=0)


def corpus(mix, seed, d_in, d_out=None, vuv_column=None, n=None):
    """The mix's in-memory corpus: a list of question matrices (and, with
    ``d_out``, a list of target matrices) with the seed's lengths."""
    q = mix["questions"]
    if int(q["binary"]) + int(q["numeric"]) != int(d_in):
        raise ValueError("the mix's question width {} + {} is not the "
                         "configuration's d_in {}".format(
                             q["binary"], q["numeric"], d_in))
    lengths = seeded_lengths(mix, seed, n)
    rng = np.random.default_rng(sub_seed(seed, "features"))
    qs, ts = [], []
    for frames in lengths:
        rows, durs = questions(rng, int(frames), int(q["binary"]),
                               int(q["numeric"]), float(q["density"]))
        qs.append(rows)
        if d_out is not None:
            ts.append(targets(rng, durs, int(d_out), vuv_column))
    return (qs, ts) if d_out is not None else qs


def arrivals(mix, seed, seconds):
    """Open-loop arrival offsets in seconds from the window's start,
    ascending and below ``seconds``: ``rate x seconds`` requests whose
    gaps are the exponential distribution's quantiles in the seed's
    order (a Poisson process with the work fixed across seeds)."""
    rate = float(mix["arrivals"]["rate_per_s"])
    n = max(1, int(round(rate * float(seconds))))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    gaps = gaps[rng.permutation(n)]
    offsets = np.cumsum(gaps) - gaps[0]
    return offsets * (float(seconds) / (offsets[-1] + gaps[0]))


def bucket_of(frames, bucket):
    """The padded length of an utterance of ``frames`` frames served
    alone (the pipeline's ``bucket`` multiple)."""
    return int(np.ceil(max(int(frames), 1) / bucket) * bucket)
