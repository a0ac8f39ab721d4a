"""The train step's batch upload, read one batch ahead
(``ModularModelHandler.process_batches``): every batch is stepped once
and in order, one call over several batches trains exactly as one call
per batch, an iterator's exception or a NaN loss still ends the call,
and the handler counts the uploads issued ahead of their step and those
whose copies had finished when their step came to wait.

The tests marked ``cuda`` run on the card only (pinned host memory, the
copy stream; batches made on the card; a copy held late on its stream;
the Interspeech'18 model at the training benchmark's size); this file
imports no JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/unit/test_torch_train_upload.py
"""

import math

import numpy as np
import pytest
import torch

from idiaptts_torch.data.dataset import collate_batch
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.rnn_dyn import convert_legacy_string
from idiaptts_torch.train.handler import ModularModelHandler
from idiaptts_torch.utils import tracing

D, NB, NQ = 8, 1, 12
D_OUT = 3 * (D + 1 + NB) + 1
# F = 16: the smallest width the card's BiLSTM kernels take.
MODEL = "RNNDYN-1_RELU_32-1_BiLSTM_16-1_FC_{}".format(D_OUT)
# Padded lengths of the five batches (no bucketing): every step a new T.
LENGTHS = ((20, 17, 9), (35, 30, 12), (50, 44, 41), (27, 8, 26),
           (64, 3, 60))


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def handler(device="cpu", model=MODEL, nq=NQ):
    h = ModularModelHandler(device=device)
    cfg = convert_legacy_string(model, nq)
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


def batches(nan_in=None, all_lengths=LENGTHS, nq=NQ, d_out=D_OUT):
    """Collated batches of utterances of ``all_lengths`` (five of
    distinct padded length by default); ``nan_in``: the index of one
    whose targets are NaN."""
    rng = np.random.RandomState(7)
    out = []
    for i, lengths in enumerate(all_lengths):
        samples = [{"questions": rng.randn(n, nq).astype(np.float32),
                    "target": rng.randn(n, d_out).astype(np.float32)}
                   for n in lengths]
        if i == nan_in:
            samples[0]["target"][:] = np.nan
        out.append(collate_batch(samples, pad_to_bucket=False))
    return out


def params(h):
    return {k: v.detach().clone() for k, v in h.model.state_dict().items()}


def assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def one_call_per_batch(data, device="cpu", **model):
    h = handler(device, **model)
    losses = [h.process_batches([b])[0] for b in data]
    return losses, params(h)


def test_each_batch_stepped_once_in_order():
    data = batches()
    h = handler()
    seen = []
    step = h._train_step

    def record(inputs, lengths, lr):
        seen.append(inputs["questions"].shape[1])
        return step(inputs, lengths, lr)

    h._train_step = record
    h.process_batches(iter(data))
    assert seen == [max(lengths) for lengths in LENGTHS]
    assert h.total_steps == len(data)


def test_one_call_trains_as_one_call_per_batch():
    data = batches()
    h = handler()
    loss, per_loss = h.process_batches(iter(data))
    losses, after = one_call_per_batch(data)
    assert loss == sum(losses) / len(losses)
    assert per_loss.keys() == {"mse"}
    assert_same_params(params(h), after)


def test_evaluation_reads_ahead_too():
    data = batches()
    h = handler()
    loss, _ = h.process_batches(iter(data), training=False)
    ref = handler()
    losses = [ref.process_batches([b], training=False)[0] for b in data]
    assert loss == sum(losses) / len(losses)
    assert h.total_steps == 0
    assert h.upload_counts() == {"ahead": len(data) - 1, "inline": 1,
                                 "ready": len(data)}


def test_iterator_error_after_three_batches():
    data = batches()

    def failing():
        yield from data[:3]
        raise RuntimeError("reader failed")

    h = handler()
    with pytest.raises(RuntimeError, match="reader failed"):
        h.process_batches(failing())
    assert h.total_steps == 3
    _, after = one_call_per_batch(data[:3])
    assert_same_params(params(h), after)


def test_nan_loss_ends_the_call_at_its_step():
    data = batches(nan_in=1)
    h = handler()
    with pytest.raises(ValueError, match="NaN"):
        h.process_batches(iter(data))
    # The third batch was fetched and staged, never stepped.
    assert h.total_steps == 2
    assert h.upload_counts() == {"ahead": 2, "inline": 1, "ready": 2}


def test_empty_iterator():
    h = handler()
    loss, per_loss = h.process_batches(iter(()))
    assert math.isnan(loss) and per_loss == {}
    assert h.upload_counts() == {"ahead": 0, "inline": 0, "ready": 0}


@pytest.mark.parametrize("n", [1, 2, 5])
def test_counter_one_inline_upload_a_call(n):
    data = batches()[:n]
    h = handler()
    h.process_batches(iter(data))
    # Nothing to copy on the CPU: every upload is ready at its step.
    assert h.upload_counts() == {"ahead": n - 1, "inline": 1, "ready": n}
    h.process_batches(iter(data))
    assert h.upload_counts() == {"ahead": 2 * (n - 1), "inline": 2,
                                 "ready": 2 * n}


def test_cpu_input_is_zero_copy():
    batch = batches()[0]
    h = handler()
    staged = h._stage(batch, ahead=False)
    (data, lengths), pending = staged
    assert pending is None
    assert data["questions"].data_ptr() == \
        batch["questions"].__array_interface__["data"][0]
    assert h._receive(staged) == ((data, lengths), True)


def stage_spans(data, device):
    """The spans of one traced call over ``data``."""
    h = handler(device)
    tracing.enable()
    h.process_batches(iter(data))
    tracing.disable()
    return h, tracing.drain()


def test_stage_and_upload_spans():
    data = batches()
    _, spans = stage_spans(data, "cpu")
    ids = {s["id"]: s for s in spans}
    steps = sorted((s for s in spans if s["name"] == "train.step"),
                   key=lambda s: s["t0_ns"])
    assert len(steps) == len(data)
    for i, step in enumerate(steps):
        children = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["t0_ns"])
        names = [s["name"] for s in children]
        last = i == len(steps) - 1
        assert names == ["train.upload", "train.forward", "train.backward",
                         "train.optimiser", "train.fetch"] \
            + ([] if last else ["train.stage"]) + ["train.sync"]
        assert children[0]["attrs"] == {"ahead": i > 0, "ready": True}
        if not last:
            attrs = children[5]["attrs"]
            assert (attrs["B"], attrs["T"]) == (len(LENGTHS[i + 1]),
                                                max(LENGTHS[i + 1]))
    fetches = [s for s in spans if s["name"] == "train.fetch"]
    assert len(fetches) == len(data) + 1
    assert sum(1 for s in fetches if s["parent"] is None) == 1
    assert all(ids[s["parent"]]["name"] == "train.step"
               for s in spans if s["name"] == "train.stage")


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_one_call_trains_as_one_call_per_batch(dev):
    data = batches()
    h, spans = stage_spans(data, dev)
    losses, after = one_call_per_batch(data, dev)
    assert h.total_steps == len(data)
    assert_same_params(params(h), after)
    uploads = sorted((s for s in spans if s["name"] == "train.upload"),
                     key=lambda s: s["t0_ns"])
    assert [s["attrs"]["ahead"] for s in uploads] == \
        [False] + [True] * (len(data) - 1)
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0
               for s in uploads)
    counts = h.upload_counts()
    assert (counts["ahead"], counts["inline"]) == (len(data) - 1, 1)
    assert [s["attrs"]["ready"] for s in uploads].count(True) == \
        counts["ready"]
    assert h._copy_stream is not None
    assert h._copy_stream != torch.cuda.current_stream(dev)


def made_on_card(data, dev):
    """``data``'s batches, each made on the card by kernels queued just
    before it is handed over, behind a long chain of matrix products: a
    copy that did not wait for the compute stream would read them
    unwritten."""
    keys = [k for k in data[0]
            if not k.startswith("_") or k.startswith("_seq_mask")]
    on_card = [{k: torch.as_tensor(b[k]).to(dev) for k in keys}
               for b in data]
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize(dev)
    for batch, arrays in zip(data, on_card):
        for _ in range(8):
            x = torch.tanh(x @ x * 1e-2)
        made = {k: v * (1.0 + 0.0 * x[0, 0]) for k, v in arrays.items()}
        made["_lengths"] = batch["_lengths"]
        yield made


@pytest.mark.cuda
def test_card_batches_made_on_the_card(dev):
    data = batches()
    h = handler(dev)
    h.process_batches(made_on_card(data, dev))
    _, after = one_call_per_batch(data, dev)
    assert h.total_steps == len(data)
    assert_same_params(params(h), after)
    made = next(made_on_card(data[:1], dev))
    (inputs, _), (_, uploaded) = h._stage(made, ahead=False)
    # Only the host's length lists are copied; the card's tensors are
    # used as they are.
    assert len(uploaded) == len(made["_lengths"])
    assert all(inputs[k] is made[k] for k in inputs)


@pytest.mark.cuda
def test_card_step_waits_for_a_late_copy(dev):
    """The copy stream held busy before the first upload: a step that
    did not wait for its copies would train on unwritten memory."""
    data = batches()
    h = handler(dev)
    h._copy_stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(h._copy_stream):
        torch.cuda._sleep(1 << 30)  # about half a second of clock cycles
    h.process_batches(iter(data))
    _, after = one_call_per_batch(data, dev)
    assert_same_params(params(h), after)


# The training benchmark's size: 32 LJSpeech-length utterances a step
# (1.11-10.1 s at 5 ms frames), 409 questions, the 187-wide head.
IS18 = dict(model="RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_187", nq=409)
IS18_LENGTHS = [list(np.random.RandomState(11 + i).randint(222, 2021, 31))
                + [2048 - 128 * i] for i in range(5)]


@pytest.mark.cuda
def test_card_read_ahead_at_the_benchmark_size(dev):
    data = batches(all_lengths=IS18_LENGTHS, nq=IS18["nq"], d_out=187)
    h = handler(dev, **IS18)
    loss, _ = h.process_batches(iter(data))
    losses, after = one_call_per_batch(data, dev, **IS18)
    assert h.total_steps == len(data)
    assert h.upload_counts()["ahead"] == len(data) - 1
    assert loss == sum(losses) / len(losses)
    assert_same_params(params(h), after)
