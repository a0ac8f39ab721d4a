"""The training driver loaded as the harness loads it (by path)."""

import os

from pb.spec import load_module

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load():
    return load_module(os.path.join(BENCH, "drivers", "train.py"))
