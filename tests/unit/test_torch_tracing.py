"""Spans inside the port (``idiaptts_torch.utils.tracing``): off, the
program records nothing and runs bit for bit as traced; on, the server,
pipeline, loader and train step record their spans under the right
parents.

The tests marked ``cuda`` run on the card only (device times, the kernel
dispatch span); this file imports no JAX, so run them there with

    python -m pytest --noconftest -m cuda tests/unit/test_torch_tracing.py
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from idiaptts_torch.data.dataset import batch_shape, collate_batch
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.synth.pipeline import FusedAcousticPipeline
from idiaptts_torch.synth.server import SynthesisServer
from idiaptts_torch.train.handler import ModularModelHandler
from idiaptts_torch.train.trainer import ModularTrainer
from idiaptts_torch.utils import tracing

D, NB, NQ = 8, 1, 12
D_OUT = 3 * (D + 1 + NB) + 1
MODEL = "RNNDYN-1_RELU_16-1_BiLSTM_8-1_FC_{}".format(D_OUT)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing held."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def parent_names(spans):
    ids = {s["id"]: s["name"] for s in spans}
    return {(s["name"], ids.get(s["parent"])) for s in spans}


# -- the recorder ------------------------------------------------------------

def test_off_records_nothing_and_hands_out_the_shared_span():
    assert not tracing.enabled()
    first = tracing.span("a", device=True, x=1)
    assert first is tracing.span("b") is tracing.NOOP
    with first as inner:
        inner.set(y=2)
    tracing.add("c", 0, 1, z=3)
    assert tracing.drain() == []


def test_on_records_names_parents_attrs_and_sink():
    seen = []
    tracing.enable(sink=lambda name, t0, t1, **attrs: seen.append(
        (name, t1 >= t0, attrs)))
    with tracing.span("outer", k=1) as outer:
        with tracing.span("inner", device=True):
            pass
        outer.set(late=2)
    tracing.disable()
    with tracing.span("after"):
        pass
    spans = tracing.drain()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    inner, outer = spans
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["attrs"] == {"k": 1, "late": 2}
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= outer["t1_ns"]
    assert inner["device_ms"] is None and outer["device_ms"] is None
    assert inner["thread"] == threading.current_thread().name
    assert seen == [("inner", True, {}), ("outer", True, {"k": 1,
                                                         "late": 2})]
    assert tracing.drain() == []


def test_added_span_adopts_what_it_encloses():
    tracing.enable()
    with tracing.span("step"):
        with tracing.span("before"):
            pass
        import time
        t0 = time.time_ns()
        with tracing.span("child"):
            with tracing.span("grandchild"):
                pass
        t1 = time.time_ns()
        tracing.add("batch", t0, t1, rows=2)
    spans = tracing.drain()
    assert parent_names(spans) == {
        ("before", "step"), ("child", "batch"), ("grandchild", "child"),
        ("batch", "step"), ("step", None)}
    assert by_name(spans, "batch")[0]["attrs"] == {"rows": 2}


def test_threads_keep_their_own_parents():
    tracing.enable()
    barrier = threading.Barrier(2)

    def work(tag):
        with tracing.span("outer." + tag):
            barrier.wait(timeout=10)
            with tracing.span("inner." + tag):
                barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(t,), name=t)
               for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = tracing.drain()
    assert parent_names(spans) == {("outer.a", None), ("outer.b", None),
                                   ("inner.a", "outer.a"),
                                   ("inner.b", "outer.b")}
    assert {s["thread"] for s in by_name(spans, "inner.a")} == {"a"}


# -- serving ------------------------------------------------------------------

def serving_setup(seed=0, count=6):
    rng = np.random.RandomState(seed)
    W = (rng.randn(NQ, D_OUT) * 0.01).astype(np.float32)
    variances = {"sp": np.abs(rng.randn(3 * D)) + 0.1,
                 "lf0": np.abs(rng.randn(3)) + 0.1,
                 "bap": np.abs(rng.randn(3 * NB)) + 0.1}
    # Two length buckets (bucket 64), so a collect makes two groups.
    questions = [rng.randn(int(n), NQ).astype(np.float32)
                 for n in rng.randint(20, 120, size=count)]
    pipeline = FusedAcousticPipeline(
        lambda p, q, lengths: q @ p["W"], variances, num_coded_sps=D,
        fs=16000, bucket=64, device="cpu")
    return pipeline, {"W": torch.from_numpy(W)}, questions


def serve(pipeline, params, questions):
    """Every request submitted at once (one collect); the waveforms."""
    server = SynthesisServer(pipeline, params, max_batch=32,
                             max_wait_ms=200.0)
    try:
        futures = [server.submit(q) for q in questions]
        return [f.result(timeout=120) for f in futures], server.stats()
    finally:
        server.shutdown()


def test_server_spans_and_identical_waveforms():
    pipeline, params, questions = serving_setup()
    off, _ = serve(pipeline, params, questions)
    assert tracing.drain() == []
    pipeline._factor_cache.clear()
    tracing.enable()
    on, stats = serve(pipeline, params, questions)
    tracing.disable()
    spans = tracing.drain()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)

    batches = by_name(spans, "server.batch")
    assert len(batches) == stats["batches"]
    ids = [r[0] for b in batches for r in b["attrs"]["requests"]]
    assert sorted(ids) == list(range(len(questions)))
    busy = sum(b["t1_ns"] - b["t0_ns"] for b in batches) / 1e9
    assert busy == pytest.approx(stats["busy_seconds"], rel=1e-9)
    for b in batches:
        a = b["attrs"]
        assert a["rows"] >= a["real_rows"] and a["rows"] & (a["rows"] - 1) \
            == 0
        assert a["T"] % 64 == 0
        assert all(t0 <= b["t0_ns"] for _, t0 in a["requests"])
        assert a["real_frames"] == sum(len(questions[i])
                                       for i, _ in a["requests"])
    assert parent_names(spans) >= {
        ("server.idle", None), ("server.collect", None),
        ("server.group", None), ("server.batch", None),
        ("server.resolve", None), ("pipeline.prepare", "server.batch"),
        ("pipeline.pad", "pipeline.prepare"),
        ("pipeline.upload", "pipeline.prepare"),
        ("pipeline.factorise", "server.batch"),
        ("pipeline.model", "server.batch"),
        ("pipeline.mlpg", "server.batch"),
        ("pipeline.vocoder", "server.batch"),
        ("pipeline.readback", "server.batch")}
    assert by_name(spans, "server.collect")[0]["attrs"]["taken"] == \
        len(questions)
    assert by_name(spans, "server.group")[0]["attrs"]["groups"] == \
        len(batches)
    assert all(s["device_ms"] is None for s in spans)
    assert {s["thread"] for s in spans} == {"SynthesisServer"}


def test_split_pipeline_spans_name_their_shard():
    pipeline, params, questions = serving_setup(1, 4)
    two = FusedAcousticPipeline(
        pipeline.model_apply, {"sp": np.ones(3 * D), "lf0": np.ones(3),
                               "bap": np.ones(3 * NB)},
        num_coded_sps=D, bucket=64, devices=["cpu", "cpu"])
    tracing.enable()
    two(params, questions)
    spans = tracing.drain()
    shards = by_name(spans, "pipeline.shard")
    assert [s["attrs"]["shard"] for s in shards] == ["cpu", "cpu"]
    assert {(n, p) for n, p in parent_names(spans)
            if n == "pipeline.model"} == {("pipeline.model",
                                           "pipeline.shard")}
    assert len(by_name(spans, "pipeline.readback")) == 1


# -- training -------------------------------------------------------------------

class Corpus:
    def __init__(self, seed=0, count=8):
        rng = np.random.RandomState(seed)
        lengths = rng.randint(30, 90, size=count)
        self.items = [{"questions": rng.randn(n, NQ).astype(np.float32),
                       "target": rng.randn(n, D_OUT).astype(np.float32),
                       "_id_list": i} for i, n in enumerate(lengths)]

    def get_id_name(self, i):
        return self.items[i], None


def handler():
    from idiaptts_torch.hparams import ExtendedHParams
    h = ModularModelHandler(device="cpu")
    cfg = convert_legacy_string(MODEL, NQ)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred",)
    h.create_model(cfg)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    h.set_optimiser(hp)
    h.set_losses([NamedLoss.Config(
        "mse", "MSELoss", ("pred", "target"), seq_mask="_seq_mask",
        reduction="mean_per_frame")])
    return h


def train(steps=2):
    """``steps`` steps of a fresh handler fed by the trainer's loader;
    (losses, parameters after)."""
    h = handler()
    corpus = Corpus()
    losses = []
    batches = ModularTrainer._batches(None, corpus, list(range(8)), 4,
                                      shuffle=True, seed=3)
    for _ in range(steps):
        loss, _ = h.process_batches(itertools.islice(batches, 1))
        losses.append(loss)
    batches.close()
    return losses, {k: v.detach().clone()
                    for k, v in h.model.state_dict().items()}


def test_train_step_spans_and_identical_training():
    off_losses, off_params = train()
    assert tracing.drain() == []
    tracing.enable()
    on_losses, on_params = train()
    tracing.disable()
    spans = tracing.drain()
    assert on_losses == off_losses
    assert off_params.keys() == on_params.keys()
    for k in off_params:
        assert torch.equal(off_params[k], on_params[k]), k

    steps = by_name(spans, "train.step")
    assert len(steps) == 2
    for step in steps:
        children = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["t0_ns"])
        # One batch a call: the fetch that reads ahead finds the end.
        assert [s["name"] for s in children] == [
            "train.upload", "train.forward", "train.backward",
            "train.optimiser", "train.fetch", "train.sync"]
        assert all(step["t0_ns"] <= c["t0_ns"] <= c["t1_ns"]
                   <= step["t1_ns"] for c in children)
        assert set(step["attrs"]) == {"B", "T", "real_frames"}
        assert step["attrs"]["B"] == 4 and step["attrs"]["T"] == 128
    assert not by_name(spans, "train.reduce")
    assert all(s["device_ms"] is None for s in spans)
    collates = by_name(spans, "loader.collate")
    assert collates and {s["thread"] for s in collates} == {"loader"}
    assert {tuple(sorted(s["attrs"])) for s in collates} == {
        ("B", "T", "real_frames")}
    # A fetch a call for its first batch (the loader's wait inside it)
    # and one inside its step that finds the batches ended.
    assert len(by_name(spans, "train.fetch")) == 4
    assert {(n, p) for n, p in parent_names(spans) if n == "loader.wait"} \
        == {("loader.wait", "train.fetch")}
    assert len(by_name(spans, "loader.wait")) == 2


def test_evaluation_is_not_traced():
    h = handler()
    tracing.enable()
    h.process_batches([collate_batch([Corpus().get_id_name(i)[0]
                                      for i in range(3)])], training=False)
    assert tracing.drain() == []


def test_batch_shape():
    batch = collate_batch([Corpus().get_id_name(i)[0] for i in range(3)])
    shape = batch_shape(batch)
    assert shape == {"B": 3, "T": batch["questions"].shape[1],
                     "real_frames": int(sum(batch["_lengths"]["questions"]))}
    assert batch_shape({}) == {}


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_spans_resolve_on_drain(dev):
    x = torch.randn(2048, 2048, device=dev)
    tracing.enable()
    with tracing.span("host"):
        with tracing.span("mm", device=dev):
            for _ in range(8):
                x = x @ x / 2048.0
        with tracing.span("current", device=True):
            x = x + 1
        with tracing.span("cpu", device=torch.device("cpu")):
            pass
    spans = {s["name"]: s for s in tracing.drain()}
    assert spans["mm"]["device_ms"] > 0
    assert spans["current"]["device_ms"] >= 0
    assert spans["host"]["device_ms"] is None
    assert spans["cpu"]["device_ms"] is None


@pytest.mark.cuda
def test_kernel_dispatch_span(dev):
    from idiaptts_torch.ops import dispatch
    from idiaptts_torch.ops.cuda_mlpg import mlpg_served
    from idiaptts_torch.ops.mlpg import mlpg_factorise
    rng = np.random.RandomState(0)
    L, T = D + 1 + NB, 64
    factors, tau = mlpg_factorise(np.abs(rng.randn(3 * L)) + 0.1, L, T,
                                  device=dev)
    cols = torch.arange(3 * L, dtype=torch.int32, device=dev)
    out = torch.randn(2, T, 3 * L, device=dev)
    before = dispatch.counts()
    tracing.enable()
    with tracing.span("pipeline.mlpg", device=dev):
        mlpg_served(out, cols, factors, tau)
    spans = tracing.drain()
    launched = {k: v - before.get(k, 0) for k, v in dispatch.counts().items()
                if v != before.get(k, 0)}
    launches = by_name(spans, "dispatch.launch")
    assert sorted(s["attrs"]["kernel"] for s in launches) == sorted(
        k for k, n in launched.items() for _ in range(n))
    assert all(s["parent"] == by_name(spans, "pipeline.mlpg")[0]["id"]
               for s in launches)
    assert by_name(spans, "pipeline.mlpg")[0]["device_ms"] > 0
