"""The benchmark's CPU tests: the harness's modules on the path, the
program's package importable (rank processes inherit the path), torch
on few threads."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, REPO, os.path.dirname(os.path.abspath(__file__))]
os.environ["PYTHONPATH"] = os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p])


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
