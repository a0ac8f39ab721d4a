"""The readers of the program's own spans (``pb/program_spans.py``) on
synthetic records, the idle time by span against ``pb/trace.py``'s own
gap rule, and ``trace_program.py`` driving the tiny cells on the CPU
with the program's recorder on."""

import importlib.util
import os
import random

import pytest

import tinycell
from pb import program_spans, trace
from test_port_bench_metrics import Event

MS = 1_000_000


def span(name, t0, t1, device_ms=None, parent=None, **attrs):
    return {"name": name, "t0_ns": t0, "t1_ns": t1, "id": None,
            "parent": parent, "thread": "t", "attrs": attrs,
            "device_ms": device_ms}


def serving_record():
    """Two batches in a 1 s window and one that began before it; a
    request submitted before the window counts nowhere."""
    return {"program_window_ns": [1000 * MS, 2000 * MS],
            "latency_s": [0.05] * 3,
            "program_spans": [
                span("server.batch", 900 * MS, 950 * MS, rows=1, T=256,
                     real_frames=256, requests=[[0, 890 * MS]]),
                span("server.batch", 1100 * MS, 1130 * MS, rows=4, T=256,
                     real_frames=512,
                     requests=[[1, 1090 * MS], [2, 1095 * MS],
                               [3, 990 * MS]]),
                span("server.batch", 1900 * MS, 2100 * MS, rows=2, T=512,
                     real_frames=768, requests=[[4, 1880 * MS]]),
                span("pipeline.prepare", 1101 * MS, 1103 * MS),
                span("pipeline.prepare", 1901 * MS, 1905 * MS),
                span("pipeline.vocoder", 1110 * MS, 1111 * MS, 5.0),
                span("pipeline.vocoder", 1910 * MS, 1911 * MS, 7.0),
                span("dispatch.launch", 1104 * MS, 1104 * MS + 20_000),
                span("dispatch.launch", 2500 * MS, 2500 * MS + 90_000)]}


def test_serving_readers():
    r = serving_record()
    read = program_spans.METRICS
    # Waits to the batch's start: 10, 5 and 20 ms (request 3 came
    # before the window); p95 is a sample value.
    assert read["server.wait_p95_ms.serve"](r) == pytest.approx(20.0)
    assert program_spans.served_p95_ms(r) == pytest.approx(220.0)
    assert sorted(program_spans.request_seconds(r)) == pytest.approx(
        [0.005, 0.010, 0.020])
    # Real frames over rows x T of the two batches begun in the window.
    assert read["server.real_frame_share.serve"](r) == pytest.approx(
        100.0 * (512 + 768) / (4 * 256 + 2 * 512))
    assert read["pipeline.prepare_ms.serve"](r) == pytest.approx(3.0)
    assert read["pipeline.vocoder_ms.serve"](r) == pytest.approx(6.0)
    assert read["dispatch.host_us.serve"](r) == pytest.approx(20.0)
    assert set(program_spans.read(r, "serve")) == {
        "server.wait_p95_ms.serve", "server.real_frame_share.serve",
        "pipeline.prepare_ms.serve", "pipeline.vocoder_ms.serve",
        "dispatch.host_us.serve"}
    assert program_spans.read(r, "train") == {}


def test_training_readers():
    spans = []
    for k in range(4):
        t = 1000 * MS + k * 100 * MS
        spans += [span("train.upload", t, t + 20 * MS, 20.0),
                  span("train.forward", t + 20 * MS, t + 40 * MS, 30.0),
                  span("train.backward", t + 40 * MS, t + 60 * MS, 40.0),
                  span("train.optimiser", t + 60 * MS, t + 70 * MS,
                       2.0 + k),
                  span("loader.collate", t, t + 8 * MS)]
    r = {"program_window_ns": [1000 * MS, 1400 * MS], "program_spans": spans,
         "window_s": 0.4, "steps": 4}
    got = program_spans.read(r, "train")
    assert got == pytest.approx({
        "train.upload_ms.train": 20.0, "train.forward_ms.train": 30.0,
        "train.backward_ms.train": 40.0, "train.optimiser_ms.train": 3.5,
        "loader.collate_ms.train": 8.0})
    assert program_spans.step_phases_share(r) == pytest.approx(93.5)
    # On the CPU the device times are None: no device metric.
    cpu = dict(r, program_spans=[dict(s, device_ms=None) for s in spans])
    assert program_spans.read(cpu, "train") == pytest.approx(
        {"loader.collate_ms.train": 8.0})
    assert program_spans.step_phases_share(cpu) is None


def test_readers_stay_silent_without_program_spans():
    for name, reader in program_spans.METRICS.items():
        assert reader({"window_s": 1.0, "steps": 2}) is None, name
        assert reader({"program_window_ns": [0, 1], "program_spans": [],
                       "stretch": None}) is None, name


def test_idle_by_span_labels_every_gap():
    device = [(100, 300), (250, 400), (600, 700)]
    spans = [("server.idle", 0, 90, {}), ("server.batch", 95, 900, {}),
             ("pipeline.pad", 420, 570, {}), ("pipeline_call", 96, 890, {})]
    beside = [("loader.collate", 50, 150, {}), ("loader.collate", 120, 450,
                                                {})]
    got = program_spans.idle_by_span(device, 0, 1000, spans, beside)
    assert got["clock_aligned"] is True
    # Collates ran over [50, 450): 50 ns of the first gap, 50 of the
    # second.
    assert got["idle_beside"] == pytest.approx({"loader.collate": 100e-9})
    assert got["idle_by_span"] == pytest.approx({
        "server.idle": 100e-9, "pipeline.pad": 200e-9,
        "pipeline_call": 300e-9})
    # Device events mostly outside the host window: the window is taken
    # from their extent, as trace.summarise takes it.
    late = [(10 ** 9, 10 ** 9 + 100), (10 ** 9 + 300, 10 ** 9 + 400)]
    got = program_spans.idle_by_span(late, 0, 1000, [])
    assert got["clock_aligned"] is False and got["idle_beside"] == {}
    assert got["idle_by_span"] == pytest.approx(
        {"host: outside the harness's spans": 200e-9})


def test_idle_by_span_sweep_is_the_label_rule():
    """The sweep gives each gap trace._label's label."""
    rng = random.Random(5)
    # Durations all differ: the rule's ties would go by list order.
    spans = [("s{}".format(k), a, a + d, {}) for k, (a, d) in enumerate(
        zip(rng.choices(range(10_000), k=300), rng.sample(range(1, 400),
                                                          300)))]
    device = sorted((a, a + rng.randrange(1, 30))
                    for a in rng.sample(range(0, 10_000), 200))
    got = program_spans.idle_by_span(device, 0, 10_000, spans)["idle_by_span"]
    busy = trace._union(device)
    want, prev = {}, 0
    for a, b in busy + [(10_000, 10_000)]:
        if a > prev:
            label = trace._label((prev + a) // 2, spans)
            want[label] = want.get(label, 0.0) + (a - prev) / 1e9
        prev = max(prev, b)
    assert got == pytest.approx(want)


def test_stretch_spans_extends_the_summary_after_the_window():
    events = [Event("k1", "CUDA", 100, 200), Event("k2", "CUDA", 600, 100),
              Event("Device Synchronize", "CUDA", 0, 1000)]
    spans = trace.Spans()
    spans.add("server.idle", 0, 90)
    spans.add("pipeline.pad", 420, 570)
    spans.add("loader.wait", 50_000, 60_000)       # far from the stretch
    wrapped = program_spans.StretchSpans(trace.summarise)
    s = wrapped(events, 0, 1000, spans)
    plain = trace.summarise(events, 0, 1000, spans)
    assert s == plain and "idle_by_span" not in s
    wrapped.finish([{"name": "loader.collate", "t0_ns": 0, "t1_ns": 50,
                     "attrs": {}},
                    {"name": "loader.wait", "t0_ns": 0, "t1_ns": 5000,
                     "attrs": {}}])
    assert s["clock_aligned"] is True
    assert s["idle_beside"] == pytest.approx({"loader.collate": 50e-9})
    assert s["idle_by_span"] == pytest.approx({
        "server.idle": 100e-9, "pipeline.pad": 300e-9,
        "host: outside the harness's spans": 300e-9})
    assert program_spans.idle_with_work_share({"stretch": s}) == \
        pytest.approx(60.0)
    assert program_spans.labels_named(s) is False
    assert program_spans.labels_named(
        {"idle_gaps": [["server.idle", 1.0], ["pipeline.pad", 0.5]]})


def tool():
    path = os.path.join(tinycell.BENCH, "trace_program.py")
    spec = importlib.util.spec_from_file_location("trace_program", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycell.build(str(tmp_path_factory.mktemp("bench")))


def traced_ctx(root, workload, seconds):
    import time

    import torch
    from pb import spec as spec_lib
    from pb.cli import Context
    cell = spec_lib.Cell(spec_lib.load(root), workload, root,
                         bench_dir=os.path.join(root, "port_bench"))
    return Context(torch, cell, 2 ** 33 + 7, seconds, 1, time.time(),
                   torch.device("cpu"))


def test_tool_on_the_tiny_serving_cell(root):
    from idiaptts_torch.utils import tracing
    outcome, program = tool().run(traced_ctx(root, "t.tiny_serve", 1.0))
    assert not tracing.enabled() and tracing.drain() == []
    record = outcome["record"]
    w0, w1 = record["program_window_ns"]
    assert list(record["window_ns"]) == [w0, w1]
    ids = [r[0] for s in record["program_spans"]
           if s["name"] == "server.batch" for r in s["attrs"]["requests"]]
    assert len(ids) == len(set(ids)) == outcome["attempted"]
    assert set(program["metrics"]) == {
        "server.wait_p95_ms.serve", "server.real_frame_share.serve",
        "pipeline.prepare_ms.serve"}
    assert 0 < program["metrics"]["server.real_frame_share.serve"] <= 100
    accounts = program["accounts"]
    assert 0 < accounts["served_p95_ms"] <= accounts["p95_ms"]
    assert program["idle_by_span"] is None     # no profiler on the CPU
    assert outcome["correct"]


def test_tool_on_the_tiny_training_cell(root):
    outcome, program = tool().run(traced_ctx(root, "t.tiny_train", 1.0))
    record = outcome["record"]
    steps = [s for s in record["program_spans"]
             if s["name"] == "train.step"
             and s["t0_ns"] < record["program_window_ns"][1]]
    assert len(steps) == record["steps"]
    assert set(program["metrics"]) == {"loader.collate_ms.train"}
    assert program["accounts"]["phases_share"] is None
    assert outcome["correct"]
