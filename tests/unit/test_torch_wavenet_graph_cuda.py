"""The WaveNet's block stack as CUDA graphs on the card
(``ops/cuda_graph.py``), at the r9y9 widths (24 layers in 4 stacks,
R = G = 512, S = 256, kernel 3, C = 23) with small batches, through
``ModularModelHandler.process_batches``: Adam steps graphed and eager
(the cache's budget 0) give the same losses, gradients and parameters
bit for bit, and the same kernel launches a step; the cache captures
once a shape and replays after; evaluation and ``no_grad`` forwards run
eager.  Skipped where CUDA is unavailable.  Run without the JAX
conftest:

    python -m pytest --noconftest -m cuda tests/unit/test_torch_wavenet_graph_cuda.py
"""

import numpy as np
import pytest
import torch

from idiaptts_torch.data.dataset import collate_batch
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.wavenet import WaveNet, WaveNetWrapper
from idiaptts_torch.ops import cuda_graph, dispatch

pytestmark = pytest.mark.cuda

R9Y9 = dict(out_channels=256, residual_channels=512, gate_channels=512,
            skip_channels=256, num_layers=24, num_stacks=4, kernel_size=3,
            cond_channels=23)
KERNELS = ("wavenet_gate_fwd", "wavenet_gate_bwd", "wavenet_taps",
           "wavenet_taps_bwd", "wavenet_residual", "wavenet_residual_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _handler(dev, budget=None, seed=3):
    from idiaptts_torch.train.handler import ModularModelHandler
    handler = ModularModelHandler(device=dev)
    handler.create_model(WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", **R9Y9), seed=seed)
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = 1e-3
    handler.set_optimiser(hp)
    handler.set_losses([NamedLoss.Config(
        "ce", "CrossEntropyLoss", ("pred_logits", "target_quantised"),
        seq_mask="_seq_mask", reduction="mean")])
    net = _wavenet(handler)
    net._graphs = cuda_graph.GraphCache(budget)
    return handler, net


def _wavenet(handler):
    return next(m for m in handler.model.modules() if isinstance(m, WaveNet))


def _batch(crop, seed, B=2):
    rng = np.random.default_rng(seed)
    return collate_batch([
        {"cond_features": rng.standard_normal(
            (crop, R9Y9["cond_channels"])).astype(np.float32),
         "target_quantised": rng.integers(
             0, R9Y9["out_channels"], (crop, 1)).astype(np.float32)}
        for _ in range(B)])


def _step(handler, batch):
    torch.cuda.synchronize()
    dispatch.reset_counts()
    loss = handler.process_batches([batch])[0]
    torch.cuda.synchronize()
    return loss, {k: v for k, v in dispatch.counts().items() if v}


def test_graphed_steps_equal_eager_steps(dev):
    batches = [_batch(1000, seed) for seed in range(3)]
    runs = {}
    for budget in (None, 0):
        handler, net = _handler(dev, budget)
        steps = [_step(handler, b) for b in batches]
        runs[budget] = (steps, net.graph_counts(), {
            n: (p.detach().clone(), p.grad.clone())
            for n, p in handler.model.named_parameters()})
    (graphed, counts, state), (eager, eager_counts, eager_state) = \
        runs[None], runs[0]
    assert counts == {"captures": 1, "replays": 2, "eager": 0}
    assert eager_counts == {"captures": 0, "replays": 0, "eager": 3}
    assert [loss for loss, _ in graphed] == [loss for loss, _ in eager]
    for name, (p, g) in eager_state.items():
        assert torch.equal(state[name][0], p), name
        assert torch.equal(state[name][1], g), name
    # Replayed steps count the launches the eager steps made; the
    # capturing step adds its warm-up's.
    layers = R9Y9["num_layers"]
    for (_, launches), (_, eager_launches) in zip(graphed[1:], eager[1:]):
        assert launches == eager_launches
        assert all(launches[k] == layers for k in KERNELS)
    assert all(graphed[0][1][k] == 2 * layers for k in KERNELS)


def test_a_new_shape_captures_again_and_evaluation_runs_eager(dev):
    handler, net = _handler(dev)
    _step(handler, _batch(1000, 0))
    _step(handler, _batch(1000, 1))
    _step(handler, _batch(3000, 2))
    assert net.graph_counts() == {"captures": 2, "replays": 1, "eager": 0}
    handler.process_batches([_batch(1000, 3)], training=False)
    model = handler.model.train()
    batch = _batch(3000, 4)
    with torch.no_grad():
        cond = torch.as_tensor(batch["cond_features"], device=dev)
        target = torch.as_tensor(batch["target_quantised"], device=dev)
        net(target[..., 0].long(), cond)
    assert model.training
    assert net.graph_counts() == {"captures": 2, "replays": 1, "eager": 2}


def test_two_forwards_before_their_backwards(dev):
    """The second forward at a key whose replay still waits for its
    backward runs eager, and both gradients are the eager path's."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = [torch.randint(0, 256, (2, 512), generator=g, device=dev)
         for _ in range(3)]
    cond = torch.randn(2, 512, 23, generator=g, device=dev)
    grads = {}
    for budget in (None, 0):
        net = WaveNet(**R9Y9)
        net.reset_parameters(torch.Generator().manual_seed(6))
        net = net.to(dev)
        net._graphs = cuda_graph.GraphCache(budget)
        # A first step captures; the next two forwards share a backward.
        net(x[0], cond).square().mean().backward()
        net.zero_grad(set_to_none=True)
        loss = net(x[1], cond).square().mean() + \
            net(x[2], cond).abs().mean()
        loss.backward()
        grads[budget] = ({n: p.grad.clone()
                          for n, p in net.named_parameters()},
                         net.graph_counts())
    assert grads[None][1] == {"captures": 1, "replays": 1, "eager": 1}
    for name, g in grads[0][0].items():
        assert torch.equal(grads[None][0][name], g), name


def test_capture_beside_a_live_graph(dev):
    """A capture made while an earlier forward's graph is still alive
    (a loop's last loss) gives the eager path's gradients."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(0, 256, (2, 384), generator=g, device=dev)
    cond = torch.randn(2, 384, 23, generator=g, device=dev)
    grads = {}
    for budget in (None, 0):
        net = WaveNet(**R9Y9)
        net.reset_parameters(torch.Generator().manual_seed(8))
        net = net.to(dev)
        net._graphs = cuda_graph.GraphCache(budget)
        # An evaluation-mode forward with grad: eager, its graph kept.
        kept = net.eval()(x, cond).mean()
        loss = net.train()(x, cond).square().mean()
        loss.backward()
        grads[budget] = ({n: p.grad.clone()
                          for n, p in net.named_parameters()},
                         net.graph_counts())
        del kept
    assert grads[None][1] == {"captures": 1, "replays": 0, "eager": 1}
    for name, g in grads[0][0].items():
        assert torch.equal(grads[None][0][name], g), name
