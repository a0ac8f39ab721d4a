"""The CUDA-graph cache of the WaveNet's block stack
(``ops/cuda_graph.py``) on the CPU: the engagement rule as a pure
function of device type, grad mode, training mode, key and cache; the
key; a replay's bookkeeping; the dispatch counters' capture accounting;
and the CPU forward, which never engages a graph.  The graphs themselves
run on the card (``test_torch_wavenet_graph_cuda.py``)."""

import contextlib
import copy
import ctypes
import gc
import types

import pytest
import torch

from idiaptts_torch.models import wavenet as wavenet_lib
from idiaptts_torch.models.wavenet import WaveNet
from idiaptts_torch.ops import cuda_graph, dispatch
from idiaptts_torch.ops.cuda_graph import CAPTURE, EAGER, REPLAY

GB = 1 << 30
STORAGE = ((1000, True), (2000, True))
MOVED = ((3000, True), (2000, True))


def _key(rows, storage=STORAGE):
    return (rows, ("cuda:0", ((2, rows // 2), torch.int64, False)), storage)


def _entry(rows, gb, pending=False):
    return types.SimpleNamespace(rows=rows, bytes=gb * GB, pending=pending)


# 262144 rows (32 x 8192) hold 29 GB; the budget is 40 GB.
HELD = {_key(262144): _entry(262144, 29)}


@pytest.mark.parametrize("case,args,expect", [
    ("hit", ("cuda", True, True, _key(262144), HELD), (REPLAY, [])),
    ("miss that captures", ("cuda", True, True, _key(65536), HELD),
     (CAPTURE, [])),
    ("miss past the budget", ("cuda", True, True, _key(131072), HELD),
     (EAGER, [])),
    ("first capture", ("cuda", True, True, _key(262144), {}), (CAPTURE, [])),
    ("moved parameters", ("cuda", True, True, _key(262144, MOVED), HELD),
     (CAPTURE, [_key(262144)])),
    ("pending backward", ("cuda", True, True, _key(262144),
                          {_key(262144): _entry(262144, 29, True)}),
     (EAGER, [])),
    ("cpu", ("cpu", True, True, _key(262144), HELD), (EAGER, [])),
    ("no grad", ("cuda", False, True, _key(262144), HELD), (EAGER, [])),
    ("evaluation", ("cuda", True, False, _key(262144), HELD), (EAGER, [])),
])
def test_action(case, args, expect):
    assert cuda_graph.action(*args, budget=40 * GB) == expect


def test_budget_zero_captures_nothing():
    assert cuda_graph.action("cuda", True, True, _key(16), {}, 0) == \
        (EAGER, [])


def test_key_follows_shape_and_storage_not_values():
    x = torch.zeros(2, 8, dtype=torch.long)
    cond = torch.zeros(2, 8, 3)
    params = [torch.nn.Parameter(torch.zeros(4)),
              torch.nn.Parameter(torch.zeros(5))]
    key = cuda_graph.key_of((x, cond), params)
    assert key[0] == 16
    with torch.no_grad():
        params[0].add_(1.0)  # Adam's update: in place
    assert cuda_graph.key_of((x, cond), params) == key
    assert cuda_graph.key_of((x, torch.zeros(2, 8, 4)), params) != key
    assert cuda_graph.key_of((x, cond.requires_grad_(True)), params) != key
    moved = [torch.nn.Parameter(params[0].detach().clone()), params[1]]
    assert cuda_graph.key_of((x, cond.detach()), moved)[2] != key[2]


def test_a_replay_stays_pending_until_its_backward_or_its_graph_dies():
    entry = cuda_graph._Capture(rows=4)
    assert not entry.pending
    token = entry.begin()
    assert entry.pending
    entry.end(token)
    assert not entry.pending
    with pytest.raises(RuntimeError):
        entry.end(token)
    entry.begin()  # its node dropped without a backward
    gc.collect()
    assert not entry.pending
    stale = entry.begin()
    entry.begin()  # replayed again: the first backward's data are gone
    with pytest.raises(RuntimeError):
        entry.end(stale)


def test_launches_inside_a_capture_count_for_each_replay(monkeypatch):
    monkeypatch.setattr(dispatch, "_kernels", list(dispatch._kernels))
    kernel = dispatch.Kernel("test_kernel", "idt_test", [ctypes.c_int])
    monkeypatch.setattr(kernel, "_fn", lambda *args: 0)
    monkeypatch.setattr(dispatch, "library", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    kernel(None, 1)
    with dispatch.capturing() as launches:
        kernel(None, 1)
        kernel(None, 1)
    assert kernel.launches == 1
    assert launches == {kernel: 2}
    kernel(None, 1)
    assert kernel.launches == 2
    dispatch.credit(launches)
    dispatch.credit(launches)
    assert dispatch.counts()["test_kernel"] == 6


def _net(seed=0):
    net = WaveNet(out_channels=256, residual_channels=16, gate_channels=32,
                  skip_channels=16, num_layers=4, num_stacks=2,
                  kernel_size=3, cond_channels=5)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net


@pytest.mark.parametrize("bf16", [False, True], ids=["plain", "bf16_path"])
def test_cpu_training_forward_runs_eager(monkeypatch, bf16):
    """Training on the CPU never engages a graph: every call counts as
    eager, and its logits are the evaluation forward's."""
    monkeypatch.setattr(wavenet_lib, "_bf16_path", lambda x: bf16)
    net = _net(1)
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (2, 40), generator=g)
    cond = torch.randn(2, 40, 5, generator=g)
    logits = net.train()(x, cond)
    logits.square().mean().backward()
    net(x, cond)
    with torch.no_grad():
        expect = net.eval()(x, cond)
    assert torch.equal(logits.detach(), expect)
    assert net.graph_counts() == {"captures": 0, "replays": 0, "eager": 3}
    assert net._graphs.entries == {}


def test_a_copy_of_the_model_starts_with_no_captures():
    net = _net()
    net._graphs.budget = 123
    net._graphs.entries["key"] = object()
    net._graphs.counts["replays"] = 5
    clone = copy.deepcopy(net)
    assert clone._graphs is not net._graphs
    assert clone._graphs.budget == 123
    assert clone._graphs.entries == {}
    assert clone.graph_counts() == {"captures": 0, "replays": 0, "eager": 0}
    assert "key" in net._graphs.entries


def test_fresh_leaves_share_storage_and_are_put_back():
    net = _net()
    named = net._stack_params
    before = [getattr(m, n) for m, n in named]
    assert len(named) == 1 + 8 * net.num_layers
    with pytest.raises(KeyError):
        with cuda_graph._fresh_leaves(named) as leaves:
            for leaf, p in zip(leaves, before):
                assert leaf is not p and leaf.is_leaf
                assert leaf.data_ptr() == p.data_ptr()
                assert leaf.requires_grad == p.requires_grad
            assert net.input_embed.embedding is leaves[0]
            raise KeyError
    assert all(getattr(m, n) is p for (m, n), p in zip(named, before))
    assert list(net.parameters())[0] is before[0]
