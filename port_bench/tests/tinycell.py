"""A copy of the benchmark with tiny cells, for the CPU tests: the same
drivers, readers and reference, a configuration a few units wide and
mixes of short utterances.  Runs a cell's driver on the CPU (the
program's plain versions), skipping the harness's look for a card."""

import json
import os
import shutil
import time

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
D = 4                       # mel-cepstral order + 1 of the tiny model
LENGTHS = {"shape": "beta", "a": 2.0, "b": 1.3, "min_s": 0.3, "max_s": 1.2,
           "frame_s": 0.005}
QUESTIONS = {"binary": 8, "numeric": 4, "density": 0.2}
MIXES = {
    "tiny_serve": {"driver": "serve_open", "pool": 16,
                   "arrivals": {"rate_per_s": 20.0},
                   "check": {"sample": 6, "longest": 2}, "profile_s": 0.3},
    "tiny_train": {"driver": "train", "pool": 32, "batch_per_rank": 4,
                   "learning_rate": 1e-3, "profile_steps": 2},
    "tiny_dp2": {"driver": "train", "pool": 32, "batch_per_rank": 2,
                 "learning_rate": 1e-3, "profile_steps": 2,
                 "data_parallel_ranks": 2},
}
LIMITS = {"serve_open": {"frame_db_p95": 1.0},
          "train": {"loss_gap": 2e-3, "grad_gap": 3e-2, "update_gap": 2e-2}}


def tiny_config(kind="bilstm"):
    with open(os.path.join(BENCH, "configs", "interspeech18_bilstm.json")) \
            as f:
        cfg = json.load(f)
    N = int(cfg["num_coded_sps"])
    cols = (list(range(D)) + list(range(N, N + D))
            + list(range(2 * N, 2 * N + D)) + list(range(3 * N, 3 * N + 7)))
    norm = cfg["normalisation"]
    var = cfg["mlpg_variances"]
    d_out = 3 * D + 7
    cfg.update(
        name="tiny_" + kind, d_in=12, d_out=d_out, num_coded_sps=D,
        max_harmonics=16,
        model="RNNDYN-1_RELU_16-2_{}_8-1_FC_{}".format(
            "BiLSTM" if kind == "bilstm" else "BiGRU", d_out),
        layers=[{"kind": "dense", "width": 16, "count": 1, "nonlin": "relu"},
                {"kind": kind, "width": 8, "count": 2},
                {"kind": "dense", "width": d_out, "count": 1,
                 "nonlin": None}],
        normalisation={"mean": [norm["mean"][c] for c in cols],
                       "scale": [norm["scale"][c] for c in cols]},
        mlpg_variances={"sp": var["sp"][:D] + var["sp"][N:N + D]
                        + var["sp"][2 * N:2 * N + D], "lf0": var["lf0"],
                        "bap": var["bap"]})
    return cfg


def build(tmp, kind="bilstm"):
    """A checkout at ``tmp`` holding the benchmark with the tiny cells
    ``t.<mix>``; returns its root."""
    shutil.copytree(BENCH, os.path.join(tmp, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(tmp, "port_bench", "configs", "tiny.json"),
              "w") as f:
        json.dump(tiny_config(kind), f)
    for name, mix in MIXES.items():
        mix = dict(mix, lengths=LENGTHS, questions=QUESTIONS)
        with open(os.path.join(tmp, "port_bench", "traffic",
                               name + ".json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(tmp, "port_bench", "limits",
                               "t." + name + ".json"), "w") as f:
            json.dump({"limits": LIMITS[mix["driver"]]}, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "port_bench/configs/tiny.json",
                        "reduced": [], "why": "test"}]
    spec["workloads"] = [{"name": "t." + n, "config": "tiny", "traffic": n,
                          "chips": 1, "why": "test"} for n in MIXES]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return tmp


def run(root, workload, seconds=1.0, seed=2 ** 33 + 5):
    """The cell's driver on the CPU; its outcome."""
    import torch
    from pb import spec as spec_lib
    from pb.cli import Context
    cell = spec_lib.Cell(spec_lib.load(root), workload, root,
                         bench_dir=os.path.join(root, "port_bench"))
    ctx = Context(torch, cell, seed, seconds, 0, time.time(),
                  torch.device("cpu"))
    return cell.driver().run(ctx)


def finite(numbers):
    return all(np.isfinite(v) for v in numbers.values())
