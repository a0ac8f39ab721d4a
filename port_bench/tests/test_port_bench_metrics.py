"""The metric readers' arithmetic on synthetic records: the tail over
every request, rates over the whole window, roofline and mfu shares,
the idle share from a list of device intervals."""

import json
import os

import numpy as np
import pytest

from pb import readers, roofline, spec, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    return spec.metric_reader(name, BENCH)


def config(name="interspeech18_bilstm"):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_p95_over_every_request():
    latency = [0.010] * 95 + [1.0] * 5
    assert reader("serve_p95_ms")({"latency_s": latency}) == \
        pytest.approx(10.0)
    # A missing request counts with its wait: the tail sees it.
    latency = [0.010] * 94 + [1.0] * 5 + [60.0]
    assert reader("serve_p95_ms")({"latency_s": latency}) == \
        pytest.approx(1000.0)
    assert reader("serve_p95_ms")({}) is None


def test_rates_over_the_whole_window():
    record = {"frames": 60000, "window_s": 1.5, "steps": 3, "setup_s": 12.5}
    assert reader("train_frames_per_s")(record) == pytest.approx(40000.0)
    assert reader("setup_s")(record) == 12.5
    assert reader("train_frames_per_s")({"frames": 1, "window_s": 1}) \
        is None


def test_flops_per_frame_matches_the_frozen_count():
    # chip_smoke.py's fwd_flops_per_frame(409, 67) is 40.8 MFLOP a frame;
    # the FC head at 187 outputs adds 2 x 1024 x 120.
    assert roofline.flops_per_frame(config()) == 40820736 + 2 * 1024 * 120
    # The ICASSP'19 BiGRU's layers, 3 x 427 a direction.
    gru = dict(config(), layers=[
        {"kind": "dense", "width": 1024, "count": 2, "nonlin": "relu"},
        {"kind": "bigru", "width": 427, "count": 3},
        {"kind": "dense", "width": 187, "count": 1, "nonlin": None}])
    assert roofline.flops_per_frame(gru) == (
        2 * (409 * 1024 + 1024 * 1024)
        + 2 * (2 * 1024 * 3 * 427 + 2 * 427 * 3 * 427)
        + 2 * 2 * (2 * 854 * 3 * 427 + 2 * 427 * 3 * 427)
        + 2 * 854 * 187)


def test_mfu():
    cfg = config()
    record = {"config": cfg, "frames": 1_000_000, "window_s": 2.0,
              "steps": 10, "chips": 1}
    flops = roofline.flops_per_frame(cfg)
    expected = 100 * 3 * flops * 1e6 / 2.0 / 989e12
    assert reader("mfu.train")(record) == pytest.approx(expected)
    assert reader("mfu.train")(dict(record, chips=4)) == \
        pytest.approx(expected / 4)
    calls = {"config": cfg, "window_ns": (0, 10 ** 9), "calls": [
        {"start_ns": 0, "end_ns": 5 * 10 ** 8, "frames": 1000},
        {"start_ns": 6 * 10 ** 8, "end_ns": 8 * 10 ** 8, "frames": 500},
        {"start_ns": 11 * 10 ** 8, "end_ns": 12 * 10 ** 8, "frames": 900}]}
    assert reader("mfu.serve")(calls) == pytest.approx(
        100 * flops * 1500 / 0.7 / 989e12)
    assert reader("server.busy_share.serve")(calls) == pytest.approx(70.0)


def test_roofline_share():
    cfg = config()
    least = sum(roofline.lstm_bound_s(2048, 64, D, F, "bwd", 4)
                for D, F in roofline.recurrent_layers(cfg))
    unit = {"T": 2048, "rows": 32, "residual_bytes": 4,
            "kernel_s": {"bilstm_bwd": 2 * least,
                         "bilstm_recurrence_train": 0.0}}
    stretch = {"window_s": 1.0, "busy_s": 0.5, "idle_gaps": [],
               "kernel_s": {}, "units": [unit, unit]}
    record = {"config": cfg, "stretch": stretch}
    assert reader("bilstm_bwd_roofline.train")(record) == \
        pytest.approx(50.0)
    # A kernel the stretch did not launch has no share, never 0.
    assert reader("bilstm_recurrence_train_roofline.train")(record) is None
    assert roofline.recurrent_layers(cfg) == [(1024, 512)] * 3


def test_lstm_bound_is_the_frozen_formula():
    T, R, F = 1024, 64, 512
    G = 4 * F
    ops = 2.0 * T * R * F * G / 989e12
    nbytes = (T * R * G * 4 + 2 * F * G * 2 + T * R * F * 4) / 3.35e12
    assert roofline.lstm_bound_s(T, R, 1024, F, "rec") == max(ops, nbytes)


class Event:
    def __init__(self, name, kind, start, dur):
        self._n, self._k, self._s, self._d = name, kind, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_idle_share_from_intervals():
    events = [Event("k1", "CUDA", 100, 200), Event("k2", "CUDA", 250, 150),
              Event("Memcpy HtoD", "CUDA", 600, 100),
              Event("Device Synchronize", "CUDA", 0, 1000)]
    spans = trace.Spans()
    spans.add("loader_wait", 0, 90)
    spans.add("prepare", 420, 570)
    s = trace.summarise(events, 0, 1000, spans)
    # Busy: [100, 400) and [600, 700): 400 ns of 1000.
    assert s["busy_s"] == pytest.approx(400e-9)
    assert readers.idle_share({"stretch": s}) == pytest.approx(60.0)
    gaps = dict((name, sec) for name, sec in s["idle_gaps"])
    assert gaps["prepare"] == pytest.approx(200e-9)
    assert gaps["loader_wait"] == pytest.approx(100e-9)
    assert s["kernel_s"]["k1"] == pytest.approx(200e-9)
    assert "Device Synchronize" not in s["kernel_s"]


def test_a_stretch_of_copies_alone_is_not_read():
    copies = [Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 100, 300),
              Event("Memset (Device)", "CUDA", 500, 10)]
    s = trace.summarise(copies, 0, 1000)
    assert s["kernel_events"] == 0 and not trace.complete(s)
    assert readers.idle_share({"stretch": s}) is None
    s = trace.summarise(copies + [Event("k", "CUDA", 600, 100)], 0, 1000)
    assert s["kernel_events"] == 1 and trace.complete(s)
    assert readers.idle_share({"stretch": s}) == pytest.approx(59.0)


def test_units_take_the_launches_inside_them():
    events = [Event("void bilstm_bwd_kernel<2>(x)", "CUDA", 100, 50),
              Event("void bilstm_bwd_kernel<2>(x)", "CUDA", 300, 70),
              Event("void bilstm_bwd_kernel<2>(x)", "CUDA", 900, 70)]
    spans = trace.Spans()
    spans.add("step", 50, 250, T=8, rows=2)
    spans.add("step", 250, 500, T=16, rows=2)
    spans.add("step", 800, 1200, T=16, rows=2)    # not wholly inside
    s = trace.summarise(events, 0, 1000, spans, unit="step")
    assert [u["T"] for u in s["units"]] == [8, 16]
    assert [u["kernel_s"]["bilstm_bwd"] for u in s["units"]] == \
        pytest.approx([50e-9, 70e-9])


def test_merge_of_rank_stretches():
    a = {"window_s": 1.0, "busy_s": 0.9, "idle_gaps": [["x", 0.1]],
         "kernel_s": {"ncclDevKernel_AllReduce": 0.02, "k": 0.5},
         "device_events": 3, "units": []}
    b = dict(a, kernel_s={"ncclDevKernel_AllReduce": 0.05, "k": 0.5},
             busy_s=0.7)
    m = trace.merge([a, b])
    assert m["busy_s"] == pytest.approx(0.8)
    assert m["kernel_s"]["k"] == pytest.approx(0.5)


def test_readers_stay_silent_without_a_trace():
    record = {"config": config(), "window_s": 1.0, "frames": 10,
              "steps": 1, "chips": 1}
    for name in ("device.idle_share.train", "bilstm_bwd_roofline.train",
                 "loader.wait_ms.train", "model.stage_ms.serve"):
        assert reader(name)(record) is None


def test_mean_ms():
    assert readers.mean_ms({"wait_s": [0.001, 0.003]}, "wait_s", 1e3) == \
        pytest.approx(2.0)
    assert np.isclose(reader("loader.wait_ms.train")(
        {"wait_s": [0.002]}), 2.0)
