"""The reference against the port's CPU path at a tiny size: the same
weights and inputs give the same model output to the program's bf16
rounding, the same MLPG to float32 rounding and the same waveforms from
the same statics; the float8 control lies well outside the program's
gap; the training reference's steps follow the handler's."""

import numpy as np
import pytest
import torch

import tinycell
from pb import program, traffic
from pb import weights as weights_lib
from reference import synthesis
from reference.model import Model, pad

MIX = dict(tinycell.MIXES["tiny_serve"], lengths=tinycell.LENGTHS,
           questions=tinycell.QUESTIONS)


@pytest.fixture(params=["bilstm", "bigru"])
def setup(request):
    cfg = tinycell.tiny_config(request.param)
    cpu = torch.device("cpu")
    weights = weights_lib.seeded(torch, cfg, 2 ** 35 + 3, cpu)
    qs = traffic.corpus(MIX, 9, cfg["d_in"])[:4]
    x, lengths = pad(qs, 256)
    return cfg, weights, program.build_pipeline(cfg, cpu), \
        program.build_model(torch, cfg, weights, cpu), x, lengths


def normalised(cfg, out):
    norm = cfg["normalisation"]
    return (out - torch.tensor(norm["mean"])) / torch.tensor(norm["scale"])


def test_model_and_control(setup):
    cfg, weights, pipe, model, x, lengths = setup
    valid = torch.arange(x.shape[1])[None] < lengths[:, None]
    with torch.no_grad():
        prog = normalised(cfg, pipe.model_stage(model, x, lengths))
        ref = Model(cfg, weights)(x, lengths)
        fp8 = Model(cfg, weights, "fp8")(x, lengths)
    gap = (prog - ref).abs()[valid].max().item()
    control = (fp8 - ref).abs()[valid].max().item()
    top = ref.abs()[valid].max().item()
    assert gap < 2 ** -5 * top
    assert control > 3 * gap


def test_mlpg(setup):
    cfg, _, pipe, model, x, lengths = setup
    with torch.no_grad():
        out = pipe.model_stage(model, x, lengths)
        smoothed, _ = pipe.mlpg_stage(out, lengths,
                                      *pipe.factors_for(x.shape[1]))
    valid = (np.arange(x.shape[1])[None] < lengths.numpy()[:, None])
    ref = np.stack([synthesis.mlpg(o, cfg) for o in out.numpy()])
    top = np.abs(ref).max()
    assert np.abs(smoothed.numpy() - ref)[valid].max() < 1e-4 * top


def test_vocoder_from_the_same_statics(setup):
    cfg, _, pipe, model, x, lengths = setup
    with torch.no_grad():
        out = pipe.model_stage(model, x, lengths)
        smoothed, vuv = pipe.mlpg_stage(out, lengths,
                                        *pipe.factors_for(x.shape[1]))
        prog = pipe.vocoder_stage(smoothed, vuv,
                                  torch.full(vuv.shape, 150.0)).numpy()
    ref = synthesis.vocode(smoothed.numpy(), vuv, cfg,
                           torch.device("cpu")).numpy()
    assert np.abs(prog - ref).max() <= 1e-5 * np.abs(ref).max()


def test_whole_path_against_the_pipeline(setup):
    cfg, weights, pipe, model, x, lengths = setup
    qs = [x[i, :int(n)].numpy() for i, n in enumerate(lengths)]
    prog = pipe(model, qs)
    with torch.no_grad():
        ref = synthesis.synthesise(Model(cfg, weights)(x, lengths), lengths,
                                   cfg, torch.device("cpu")).numpy()
    hop = pipe.hop
    for i, w in enumerate(prog):
        r = ref[i, :len(w)]
        assert len(w) == int(lengths[i]) * hop
        assert np.linalg.norm(w - r) / np.linalg.norm(r) < 0.5


def test_training_reference_follows_the_handler():
    from drivers_train import load
    driver = load()
    cfg = tinycell.tiny_config("bilstm")
    cpu = torch.device("cpu")
    weights = weights_lib.seeded(torch, cfg, 77, cpu)
    mix = dict(tinycell.MIXES["tiny_train"], lengths=tinycell.LENGTHS,
               questions=tinycell.QUESTIONS)
    qs, ts = traffic.corpus(mix, 77, cfg["d_in"], cfg["d_out"], 3 * 4 + 3)
    handler = program.build_handler(torch, cfg, weights, cpu, 1e-3)
    feed = driver.Feed(driver.Corpus(qs, ts), len(qs), 4, 5)
    run = driver.checked_steps(handler, feed)
    steps = [p["ids"] for p in feed.pulled]
    feed.close()
    ref = driver.reference_steps(torch, cfg, weights, 1e-3, qs, ts, steps,
                                 cpu)
    gaps = driver.training_gaps(run, ref, weights)
    assert gaps["loss_gap"] < 1e-3 and gaps["grad_gap"] < 2e-2 \
        and gaps["update_gap"] < 1e-2
    control = driver.training_gaps(driver.reference_steps(
        torch, cfg, weights, 1e-3, qs, ts, steps, cpu, "fp8"), ref, weights)
    assert max(control[k] / max(gaps[k], 1e-12) for k in gaps) > 3
