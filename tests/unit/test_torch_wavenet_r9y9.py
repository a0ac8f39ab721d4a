"""The port's WaveNet training step against the benchmark's plain
float32 reference (``port_bench/reference/wavenet.py``, loaded by path;
it imports nothing of the port), at a small size of the r9y9 layout:
8 layers in 2 stacks, kernel 3 (and kernel 2, the port's default),
R = 16, G = 32, S = 16, C = 5, B = 3 rows of 300, 263 and 189 samples,
seeded weights from the handler.

- With the port's bf16 roundings switched off, its logits, loss and
  gradients are the reference's to float32 rounding: the equations are
  the same.
- With them, each path of the port (the CPU's plain path, and the card's
  bf16 path run here on the gate's plain version) stays within the bf16
  tolerances below, measured over seeds 0-2; the reference with float8
  products (its control) reads 0.08 on the logits, outside.
- The handler's Adam update is the reference's Adam applied to the
  port's own gradient, to float32 rounding.
- The gate's plain version (the kernel's oracle) is autograd through
  the plain path's own roundings, exactly; the reference's upsampling is
  the port's ``sample_linearly``.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from idiaptts_torch.data.dataset import collate_batch
from idiaptts_torch.hparams import ExtendedHParams
from idiaptts_torch.models import wavenet as wavenet_lib
from idiaptts_torch.models.losses import NamedLoss
from idiaptts_torch.models.wavenet import WaveNetWrapper
from idiaptts_torch.ops import wavenet_gate
from idiaptts_torch.ops.interpolation import sample_linearly
from idiaptts_torch.train.handler import ModularModelHandler

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LENGTHS = (300, 263, 189)
C = 5
Q = 256
LR = 1e-3
B1 = 0.9
# bf16 against float32, measured at seeds 0-2 with kernel 3 / kernel 2:
# the worst row's ||logits - ref|| / ||ref|| reads 0.0072 / 0.0075 (the
# float8 control 0.082); the loss 4e-5 (relative); the worst leaf's
# ||g - g_ref|| / max(||g_ref||, median leaf) 0.091 / 0.096: the bf16
# roundings of the backward's products move the softmax's share of each
# gradient, summed over 752 samples (the control reads 0.27); the worst
# leaf's gap of the update's norm 0.0017 / 0.0031.
LOGITS_TOL = 2.0 ** -5
LOSS_TOL = 1e-3
GRAD_TOL = 0.15
UPDATE_NORM_TOL = 0.02
# The port without its bf16 roundings: the same float32 operations in
# another order (the concatenated taps in one product), measured 4e-7.
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def ref_wn():
    path = os.path.join(REPO, "port_bench", "reference", "wavenet.py")
    spec = importlib.util.spec_from_file_location("reference_wavenet", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(k):
    return WaveNetWrapper.Config(
        input_names=("cond",), output_names=("pred_logits",),
        target_name="target", out_channels=Q, residual_channels=16,
        gate_channels=32, skip_channels=16, num_layers=8, num_stacks=2,
        kernel_size=k, cond_channels=C)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return collate_batch([
        {"cond": rng.standard_normal((n, C)).astype(np.float32),
         "target": rng.integers(0, Q, (n, 1)).astype(np.float32)}
        for n in LENGTHS], pad_to_bucket=False)


@contextlib.contextmanager
def _path(bf16):
    """Run the network's bf16 path (``bf16``) or its plain path, wherever
    the tensors lie: on the CPU the bf16 path runs the kernels' plain
    versions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wavenet_lib, "_bf16_path", lambda x: bf16)
        yield


def _norm_gaps(prog, ref):
    """{leaf: ||prog - ref|| / max(||ref||, median leaf norm)}."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    return {k: float((prog[k] - ref[k]).norm()) / max(norms[k], median)
            for k in ref}


def _step(k, seed, bf16):
    """One handler step: (weights before, the first step's logits, loss,
    gradient from Adam's first moment, parameters after, batch)."""
    handler = ModularModelHandler(device="cpu")
    handler.create_model(_config(k), seed=seed)
    named = {n.split("wrapped.", 1)[-1]: p
             for n, p in handler.model.named_parameters()}
    before = {n: p.detach().clone() for n, p in named.items()}
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = LR
    handler.set_optimiser(hp)
    handler.set_losses([NamedLoss.Config(
        "ce", "CrossEntropyLoss", ("pred_logits", "target"),
        seq_mask="_seq_mask", reduction="mean")])
    logits = []
    hook = handler.model.register_forward_hook(
        lambda m, args, out: logits.append(out["pred_logits"].detach()))
    batch = _batch(seed)
    with _path(bf16):
        loss, _ = handler.process_batches([batch])
    hook.remove()
    state = handler.optimiser.state
    grads = {n: state[p]["exp_avg"] / (1.0 - B1) for n, p in named.items()}
    after = {n: p.detach().clone() for n, p in named.items()}
    return before, logits[0], float(loss), grads, after, batch


def _reference(ref_wn, k, weights, batch, logits=None, precision="float32"):
    cfg = _config(k)
    trainer = ref_wn.Trainer(weights, cfg.num_layers, cfg.num_stacks, Q, LR,
                             torch.device("cpu"), precision,
                             rows_per_block=2)
    targets = torch.as_tensor(batch["target"][..., 0]).long()
    loss, grads, gaps = trainer.step(targets, torch.as_tensor(batch["cond"]),
                                     torch.tensor(LENGTHS), logits=logits)
    return trainer, loss, grads, gaps


@pytest.mark.parametrize("k", [3, 2])
def test_float32_port_is_the_reference(ref_wn, monkeypatch, k):
    monkeypatch.setattr(wavenet_lib, "_bf", lambda x: x)
    weights, logits, loss, grads, _, batch = _step(k, 0, bf16=False)
    _, ref_loss, ref_grads, gaps = _reference(ref_wn, k, weights, batch,
                                              logits)
    assert max(gaps) < F32_TOL
    assert abs(loss - ref_loss) < F32_TOL * ref_loss
    assert max(_norm_gaps(grads, ref_grads).values()) < F32_TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["plain", "bf16_path"])
@pytest.mark.parametrize("k", [3, 2])
def test_port_against_the_reference(ref_wn, k, bf16):
    weights, logits, loss, grads, after, batch = _step(k, 1, bf16)
    trainer, ref_loss, ref_grads, gaps = _reference(ref_wn, k, weights,
                                                    batch, logits)
    assert max(gaps) < LOGITS_TOL
    assert abs(loss - ref_loss) < LOSS_TOL * ref_loss
    assert max(_norm_gaps(grads, ref_grads).values()) < GRAD_TOL
    update = {n: after[n] - weights[n] for n in weights}
    ref_update = {n: trainer.params[n].detach() - weights[n]
                  for n in weights}
    norms = {n: float(v.norm()) for n, v in ref_update.items()}
    median = float(np.median(list(norms.values())))
    assert max(abs(float(update[n].norm()) - norms[n])
               / max(norms[n], median) for n in weights) < UPDATE_NORM_TOL


def test_control_falls_outside(ref_wn):
    """The reference with float8 products against the float32 one reads
    far outside the logits tolerance."""
    weights, _, _, _, _, batch = _step(3, 1, bf16=False)
    fp8 = ref_wn.WaveNet(weights, 8, 2, Q, "fp8")
    targets = torch.as_tensor(batch["target"][..., 0]).long()
    cond = torch.as_tensor(batch["cond"])
    with torch.no_grad():
        control = fp8(targets, cond)
        ref = ref_wn.WaveNet(weights, 8, 2, Q)(targets, cond)
    assert max(ref_wn.row_gaps(control, ref, LENGTHS)) > 2 * LOGITS_TOL


def test_adam_update_is_the_references_on_the_ports_gradient():
    """The reference's first Adam step (bias-corrected: m_hat = g,
    v_hat = g^2) on the port's gradient; float32 rounding of the
    parameter and of g recovered from the first moment (measured
    6e-8)."""
    weights, _, _, grads, after, _ = _step(3, 2, bf16=False)
    for n, g in grads.items():
        expect = weights[n] - LR * g / (g.abs() + 1e-8)
        torch.testing.assert_close(after[n], expect, rtol=0, atol=2e-7)


def test_bf16_path_matches_plain_path():
    """Both paths of the port on the CPU: the bf16 path's products round
    where the plain path's do; the sums of its fused skip/residual
    product and of the taps' gradient round once where the plain path
    rounds each part (measured 0 on the logits, 3.7e-3 on the worst
    gradient leaf)."""
    net = WaveNetWrapper(_config(3)).wavenet
    net.reset_parameters(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, Q, (2, 200), generator=g)
    cond = torch.randn(2, 200, C, generator=g)
    target = torch.randint(0, Q, (2, 200), generator=g)
    out = {}
    for bf16 in (False, True):
        net.zero_grad()
        with _path(bf16):
            logits = net(x, cond)
        torch.nn.functional.cross_entropy(logits.reshape(-1, Q),
                                          target.reshape(-1)).backward()
        out[bf16] = (logits.detach(), {n: p.grad.clone() if p.grad is not None
                                       else torch.zeros_like(p)
                                       for n, p in net.named_parameters()})
    top = out[False][0].abs().max()
    assert (out[True][0] - out[False][0]).abs().max() <= 2.0 ** -7 * top
    assert max(_norm_gaps(out[True][1], out[False][1]).values()) < 0.03


def test_conditioning_gradient_on_both_paths():
    """A trainable model upstream of the WaveNet gets the conditioning's
    gradient on both paths: each block's share rounds to bf16 where the
    plain path rounds it, but the bf16 path adds the 8 shares in bf16
    where the plain path adds them in float32, and its products round as
    in the other gradients (measured 5.2e-3 to 5.8e-3 of the gradient's
    norm with the weights of seeds 8-10)."""
    net = WaveNetWrapper(_config(3)).wavenet
    net.reset_parameters(torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    x = torch.randint(0, Q, (2, 120), generator=g)
    base = torch.randn(2, 120, C, generator=g)
    target = torch.randint(0, Q, (2, 120), generator=g)
    grads = {}
    for bf16 in (False, True):
        cond = base.clone().requires_grad_(True)
        with _path(bf16):
            logits = net(x, cond)
        torch.nn.functional.cross_entropy(logits.reshape(-1, Q),
                                          target.reshape(-1)).backward()
        grads[bf16] = cond.grad
    assert grads[True].shape == base.shape
    assert grads[True].dtype == torch.float32
    gap = float((grads[True] - grads[False]).norm() / grads[False].norm())
    assert 0 < float(grads[False].norm())
    assert gap < 2e-2


def test_gate_plain_is_the_plain_blocks_chain():
    g = torch.Generator().manual_seed(5)
    p1, p2 = (torch.randn(7, 64, generator=g).to(torch.bfloat16)
              for _ in range(2))
    b1, b2 = (0.3 * torch.randn(64, generator=g) for _ in range(2))
    dz = torch.randn(7, 32, generator=g).to(torch.bfloat16)
    # The plain block's chain, in float32 on bf16-rounded values.
    bf = wavenet_lib._bf
    leaf1 = p1.float().requires_grad_(True)
    leaf2 = p2.float().requires_grad_(True)
    h = bf(bf(leaf1 + bf(b1)) + bf(leaf2 + bf(b2)))
    z = bf(bf(torch.tanh(h[:, :32])) * bf(torch.sigmoid(h[:, 32:])))
    z.backward(dz.float())
    hk, zk = wavenet_gate.gate(p1, p2, b1, b2)
    assert torch.equal(hk.float(), h.detach())
    assert torch.equal(zk.float(), z.detach())
    dh = wavenet_gate.gate_backward(hk, dz)
    assert torch.equal(dh.float(), leaf1.grad)
    assert torch.equal(dh.float(), leaf2.grad)


def test_reference_upsampling_is_sample_linearly(ref_wn):
    frames = np.random.default_rng(6).standard_normal((100, C))
    np.testing.assert_allclose(ref_wn.upsample(frames, 80),
                               sample_linearly(frames, 80), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["plain", "bf16_path"])
def test_stack_and_head_spans(bf16):
    from idiaptts_torch.utils import tracing
    net = WaveNetWrapper(_config(3)).wavenet
    net.reset_parameters(torch.Generator().manual_seed(7))
    x = torch.randint(0, Q, (2, 50))
    cond = torch.randn(2, 50, C)
    tracing.enable()
    try:
        with torch.no_grad(), _path(bf16):
            net(x, cond)
    finally:
        tracing.disable()
    spans = {s["name"]: s for s in tracing.drain()}
    # The CPU never replays a graph.
    assert spans["wavenet.stack"]["attrs"] == {
        "B": 2, "T": 50, "layers": 8, "path": "bf16" if bf16 else "plain",
        "graphed": False}
    assert "wavenet.head" in spans
    # The CPU has no device clock.
    assert spans["wavenet.stack"]["device_ms"] is None
