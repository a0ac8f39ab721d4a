"""On the card: the control (the reference with float8 matrix products
in the program's place) and the planted faults come out not correct
under each cell's limits, at sizes a test run holds: the cells' own
configurations and traffic, fewer utterances compared, one seed.
``python3 -m pytest -m cuda port_bench/tests`` on a machine with a card;
skips elsewhere."""

import os

import pytest

import calibrate
from pb import checks
from pb import spec as spec_lib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell(name, **traffic):
    c = spec_lib.Cell(spec_lib.load(REPO), name, REPO)
    c.traffic = dict(c.traffic, **traffic)
    return c


@pytest.mark.cuda
def test_control_fails_synthesis(card):
    import torch
    c = cell("is18.serve.open", check={"sample": 6, "longest": 2})
    readings = calibrate.control_waves(torch, c, 2 ** 33 + 17, card)
    correct, _ = checks.judge(readings["control"], c.limits)
    assert not correct, readings


@pytest.mark.cuda
def test_control_and_faults_fail_training(card):
    import torch
    c = cell("is18.train")
    readings = calibrate.control_training(torch, c, 2 ** 33 + 19, card,
                                          c.driver())
    for name, numbers in readings.items():
        correct, _ = checks.judge(numbers, c.limits)
        assert not correct, (name, numbers)
