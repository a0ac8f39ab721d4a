"""The traffic generator: determinism by seed, the fixed amount of work
across seeds, and the LJSpeech length distribution."""

import json
import os

import numpy as np
import pytest

from pb import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


MIXES = sorted(os.path.splitext(n)[0]
               for n in os.listdir(os.path.join(BENCH, "traffic")))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_corpus(name):
    m = dict(mix(name), pool=24)
    a = traffic.corpus(m, 2 ** 33 + 1, 409, 187, 183)
    b = traffic.corpus(m, 2 ** 33 + 1, 409, 187, 183)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work(name):
    m = dict(mix(name), pool=64)
    a = traffic.seeded_lengths(m, 3)
    b = traffic.seeded_lengths(m, 2 ** 40 + 7)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    qa = traffic.corpus(m, 3, 409)
    qb = traffic.corpus(m, 4, 409)
    assert not all(np.array_equal(x, y) for x, y in zip(qa, qb))


def test_ljspeech_lengths():
    lengths = traffic.length_grid(mix("ljspeech_serve_open")["lengths"],
                                  13100)
    # 1.11-10.10 s at 5 ms a frame, mean 6.57 s, heavy toward long clips.
    assert lengths.min() >= 222 and lengths.max() <= 2020
    assert abs(lengths.mean() - 1314) < 0.01 * 1314
    assert np.median(lengths) > lengths.mean()
    assert np.mean(lengths > 1024) > 0.5


def test_questions_shape_and_values():
    rng = np.random.default_rng(0)
    rows, durs = traffic.questions(rng, 500, 400, 9, 0.08)
    assert rows.shape == (500, 409) and rows.dtype == np.float32
    assert durs.sum() == 500 and durs.min() >= 1
    assert set(np.unique(rows[:, :400])) <= {0.0, 1.0}
    assert np.all((rows[:, 400] > 0) & (rows[:, 400] < 1))
    targets = traffic.targets(rng, durs, 187, 183)
    assert targets.shape == (500, 187)
    assert set(np.unique(targets[:, 183])) <= {-1.0, 1.0}


def test_question_width_must_match():
    with pytest.raises(ValueError):
        traffic.corpus(dict(mix("ljspeech_train_b32"), pool=2), 1, 400)


@pytest.mark.parametrize("seconds", [1.0, 20.0])
def test_arrivals(seconds):
    m = {"arrivals": {"rate_per_s": 150.0}}
    a = traffic.arrivals(m, 5, seconds)
    assert len(a) == round(150 * seconds)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < seconds
    b = traffic.arrivals(m, 6, seconds)

    def gaps(x):    # every gap, the first one's at the end of the window
        return np.sort(np.append(np.diff(x), seconds - x[-1]))

    assert not np.array_equal(a, b)
    assert np.allclose(gaps(a), gaps(b))
    assert np.array_equal(a, traffic.arrivals(m, 5, seconds))


def test_sub_seed_takes_large_seeds():
    from pb.util import sub_seed
    seeds = {sub_seed(s, "x") for s in (0, 1, 2 ** 31 + 5, 2 ** 62)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 63 for s in seeds)
