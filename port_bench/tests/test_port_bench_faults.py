"""Whole tiny runs on the CPU, the harness's look for a card skipped:
a sound run comes out correct, and each fault the cell can have, planted
under the timed path, makes ``correct`` come out false."""

import os

import pytest
import torch

import tinycell
from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
from idiaptts_torch.train.handler import ModularModelHandler


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycell.build(str(tmp_path_factory.mktemp("tiny")))


CELLS = ["t.tiny_serve", "t.tiny_train", "t.tiny_dp2"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload):
    out = tinycell.run(root, workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def answer_altered(monkeypatch):
    run = FusedAcousticPipeline.run

    def altered(self, *args, **kwargs):
        return run(self, *args, **kwargs) * 0.5
    monkeypatch.setattr(FusedAcousticPipeline, "run", altered)


def half_batch_left_out(monkeypatch):
    run = FusedAcousticPipeline.run

    def half(self, params, questions_b, *args, **kwargs):
        wavs = run(self, params, questions_b, *args, **kwargs)
        wavs[wavs.shape[0] // 2:] = 0.0
        return wavs
    monkeypatch.setattr(FusedAcousticPipeline, "run", half)


@pytest.mark.parametrize("fault", [answer_altered, half_batch_left_out])
def test_synthesis_faults(root, fault, monkeypatch):
    fault(monkeypatch)
    out = tinycell.run(root, "t.tiny_serve")
    assert not out["correct"], out["checks"]


def state_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *args, **kwargs):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)


def train_half_batch(monkeypatch):
    to_input = ModularModelHandler._batch_to_model_input

    def half(self, batch):
        data, lengths = to_input(self, batch)
        rows = next(iter(data.values())).shape[0] // 2
        return ({k: v[:rows] for k, v in data.items()},
                {k: v[:rows] for k, v in lengths.items()}
                if isinstance(lengths, dict) else lengths[:rows])
    monkeypatch.setattr(ModularModelHandler, "_batch_to_model_input", half)


@pytest.mark.parametrize("fault", [state_unchanged, train_half_batch])
def test_training_faults(root, fault, monkeypatch):
    fault(monkeypatch)
    out = tinycell.run(root, "t.tiny_train")
    assert not out["correct"], out["checks"]


def test_exchange_left_out(root, tmp_path, monkeypatch):
    """Each rank's process drops the gradient all-reduce."""
    (tmp_path / "sitecustomize.py").write_text(
        "import idiaptts_torch.parallel.mesh as mesh\n"
        "mesh.all_reduce_gradients = lambda *args, **kwargs: None\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ["PYTHONPATH"]]))
    out = tinycell.run(root, "t.tiny_dp2")
    assert not out["correct"], out["checks"]
