"""The WaveNet training cell's driver, readers and calibration on the
CPU at a tiny size (4 layers of R = 16, G = 32, S = 16, crops of 10
frames, 4 a step): the program's plain path against the reference, the
float8 control and the half-batch fault outside the program's numbers,
and the readers on the run's record."""

import json
import os
import shutil
import time

import numpy as np
import torch

from pb import spec as spec_lib
from pb.cli import Context

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
LIMITS = {"logits_gap": 0.05, "grad_gap": 0.05, "grad_diff": 0.1,
          "update_gap": 0.1}


def _build(tmp):
    shutil.copytree(BENCH, os.path.join(tmp, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(BENCH, "configs", "r9y9_wavenet_mulaw.json")) as f:
        cfg = json.load(f)
    cfg.update(num_layers=4, num_stacks=2, residual_channels=16,
               gate_channels=32, skip_channels=16)
    with open(os.path.join(BENCH, "traffic", "wavenet_crops_b32.json")) as f:
        mix = json.load(f)
    mix.update(pool=16, batch_per_rank=4, crop_frames=10, profile_steps=2,
               check_rows_per_block=3)
    files = {"configs/tiny_wn.json": cfg, "traffic/tiny_wn.json": mix,
             "limits/t.wn.json": {"limits": LIMITS}}
    for name, data in files.items():
        with open(os.path.join(tmp, "port_bench", name), "w") as f:
            json.dump(data, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "port_bench/configs/tiny_wn.json",
                        "reduced": [], "why": "test"}]
    spec["workloads"] = [{"name": "t.wn", "config": "tiny",
                          "traffic": "tiny_wn", "chips": 1, "why": "test"}]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return spec_lib.Cell(spec_lib.load(tmp), "t.wn", tmp,
                         bench_dir=os.path.join(tmp, "port_bench"))


def test_driver_readers_and_calibration(tmp_path):
    cell = _build(str(tmp_path))
    ctx = Context(torch, cell, 2 ** 33 + 5, 1.0, 0, time.time(),
                  torch.device("cpu"))
    out = cell.driver().run(ctx)
    assert out["correct"], out["checks"]
    assert all(np.isfinite(v) for v in out["numbers"].values())
    record = dict(out["record"], config=cell.config, chips=1)
    assert record["frames"] == record["steps"] * 4 * 800
    read = lambda name: spec_lib.metric_reader(  # noqa: E731
        name, cell.bench_dir)(record)
    assert read("train_frames_per_s") > 0
    assert read("mfu.wn.train") > 0
    # CPU runs take no profiled stretch and record no program spans.
    assert read("wavenet_gate_roofline.train") is None
    assert read("wavenet.stack_ms.train") is None

    cal = spec_lib.load_module(os.path.join(cell.bench_dir,
                                            "calibrate_wavenet.py"))
    readings = cal.control_training(torch, cell, 2 ** 33 + 5,
                                    torch.device("cpu"))
    program = out["numbers"]
    assert readings["control"]["logits_gap"] > 3 * program["logits_gap"]
    assert readings["fault_half_batch"]["grad_diff"] \
        > 3 * program["grad_diff"]


class _Event:
    def __init__(self, name, duration_ns, device="DeviceType.CUDA"):
        self._name, self._ns, self._device = name, duration_ns, device

    def name(self):
        return self._name

    def duration_ns(self):
        return self._ns

    def device_type(self):
        return self._device


def test_gate_records_flag_records_whose_time_was_lost():
    driver = spec_lib.load_module(os.path.join(BENCH, "drivers",
                                               "wavenet_train.py"))
    least = {"fwd": 120e-6, "bwd": 200e-6}
    fwd = "(anonymous namespace)::wavenet_gate_fwd_kernel(idt::Vec8 const*)"
    bwd = "(anonymous namespace)::wavenet_gate_bwd_kernel(idt::Vec8 const*)"
    whole = [_Event(fwd, 350_000), _Event(bwd, 250_000),
             _Event("taps_kernel", 680_000),
             _Event(fwd, 0, device="DeviceType.CPU")]
    assert driver.gate_records(whole, least) == ({"fwd": 1, "bwd": 1}, 0)
    lost = whole + [_Event(fwd, 0), _Event(bwd, 1_000)]
    assert driver.gate_records(lost, least) == ({"fwd": 2, "bwd": 2}, 2)
    # The reader reads no share from such a stretch.
    read = spec_lib.metric_reader("wavenet_gate_roofline.train", BENCH)
    stretch = {"kernel_s": {fwd: 350e-6, bwd: 250e-6}, "kernel_events": 3,
               "gate_launches": {"fwd": 1, "bwd": 1}}
    record = {"stretch": stretch, "gate": {"rows": 32 * 8192, "G": 512}}
    assert 0 < read(record) <= 100
    assert read(dict(record, stretch=dict(stretch,
                                          untimed_gate_records=2))) is None
