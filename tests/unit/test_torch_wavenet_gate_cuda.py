"""The WaveNet training path on the card: the gate kernel
(``csrc/wavenet_gate.cu``) and the block's taps and residual kernels
(``csrc/wavenet_block.cu``) against their plain versions, the bf16 path
against the plain path at the r9y9 widths (24 layers in 4 stacks,
R = G = 512, S = 256, kernel 3, C = 23), and the peak memory of one
training step of the benchmark's batch (32 x 8192 samples).  Skipped
where CUDA is unavailable.  Run without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/unit/test_torch_wavenet_gate_cuda.py
"""

import numpy as np
import pytest
import torch

from idiaptts_torch.models import wavenet as wavenet_lib
from idiaptts_torch.models.wavenet import WaveNet
from idiaptts_torch.ops import wavenet_block, wavenet_gate

pytestmark = pytest.mark.cuda

R9Y9 = dict(out_channels=256, residual_channels=512, gate_channels=512,
            skip_channels=256, num_layers=24, num_stacks=4, kernel_size=3,
            cond_channels=23)
# bf16 path against plain path on the card, both with bf16 roundings:
# the products' float32 sums in cuBLAS's order against the plain path's
# float32 products, and the fused skip/residual product rounding once
# where the plain path rounds each part.  A rounding flip moves a logit,
# and so the softmax's share of every gradient, summed here over only
# 4096 samples: measured 0.078 on the worst leaf on an H100, the logits
# 6.0e-3.
LOGITS_TOL = 2.0 ** -6        # max |diff| / max |logits|
GRAD_TOL = 0.15               # worst leaf ||diff|| / max(||g||, median)
# One step of 32 x 8192 samples: ~4.5 KB of bf16 saved a layer and a
# sample (28 GB over 24 layers) plus the step's transients.
STEP_PEAK_BYTES = 40e9


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gate_inputs(dev, rows, G, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    p1, p2 = (2 * torch.randn(rows, G, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    b1, b2 = (0.3 * torch.randn(G, generator=g, device=dev)
              for _ in range(2))
    dz = torch.randn(rows, G // 2, generator=g, device=dev).to(
        torch.bfloat16)
    return p1, p2, b1, b2, dz


def _ulps(a, b):
    """Largest difference in bf16 ulps of the larger magnitude."""
    a, b = a.float(), b.float()
    ulp = torch.clamp(torch.maximum(a.abs(), b.abs()), min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)
    return ((a - b).abs() / ulp).max().item()


@pytest.mark.parametrize("rows,G", [(2 * 8192, 512), (1, 16), (7, 128),
                                    (4097, 64)])
def test_gate_kernel_matches_plain(dev, rows, G):
    p1, p2, b1, b2, dz = _gate_inputs(dev, rows, G)
    before = (wavenet_gate.GATE_FWD.launches, wavenet_gate.GATE_BWD.launches)
    h, z = wavenet_gate.gate(p1, p2, b1, b2)
    dh = wavenet_gate.gate_backward(h, dz)
    torch.cuda.synchronize()
    assert (wavenet_gate.GATE_FWD.launches,
            wavenet_gate.GATE_BWD.launches) == (before[0] + 1, before[1] + 1)
    h_ref, z_ref = wavenet_gate.gate_plain(p1, p2, b1, b2)
    # The same roundings; tanhf/expf against PyTorch's CUDA tanh and
    # sigmoid may differ by a float32 ulp, which moves a bf16 rounding
    # by at most one bf16 ulp.
    assert torch.equal(h, h_ref)
    assert _ulps(z, z_ref) <= 1.0
    assert _ulps(dh, wavenet_gate.gate_backward_plain(h, dz)) <= 1.0


def test_gate_kernel_refuses_odd_widths(dev):
    p1, p2, b1, b2, _ = _gate_inputs(dev, 4, 24)
    with pytest.raises(ValueError):
        wavenet_gate.gate(p1, p2, b1, b2)


@pytest.mark.parametrize("B,T,R,k,d", [(2, 8192, 512, 3, 32),
                                       (1, 5, 8, 2, 4), (3, 100, 64, 3, 1)])
def test_taps_kernels_match_plain(dev, B, T, R, k, d):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(B, T, R, generator=g, device=dev)
    dxo = torch.randn(B, T, R, generator=g, device=dev)
    dtaps = torch.randn(B, T, k * R, generator=g, device=dev).to(
        torch.bfloat16)
    before = (wavenet_block.TAPS.launches, wavenet_block.TAPS_BWD.launches)
    got = wavenet_block.taps(x, k, d)
    dx = wavenet_block.taps_backward(dtaps, dxo, k, d)
    torch.cuda.synchronize()
    assert (wavenet_block.TAPS.launches, wavenet_block.TAPS_BWD.launches) \
        == (before[0] + 1, before[1] + 1)
    # The same float32 additions in the same order, each rounded alone.
    assert torch.equal(got, wavenet_block.taps_plain(x, k, d))
    assert torch.equal(dx, wavenet_block.taps_backward_plain(dtaps, dxo, k,
                                                             d))


@pytest.mark.parametrize("rows,S,R", [(2 * 8192, 256, 512), (3, 8, 16)])
@pytest.mark.parametrize("first", [True, False])
def test_residual_kernels_match_plain(dev, rows, S, R, first):
    g = torch.Generator(device=dev).manual_seed(5)
    p = torch.randn(rows, S + R, generator=g, device=dev).to(torch.bfloat16)
    bias = 0.1 * torch.randn(S + R, generator=g, device=dev)
    x = torch.randn(rows, R, generator=g, device=dev)
    skips = None if first else torch.randn(
        rows, S, generator=g, device=dev).to(torch.bfloat16)
    dxo = torch.randn(rows, R, generator=g, device=dev)
    dskips = torch.randn(rows, S, generator=g, device=dev).to(
        torch.bfloat16)
    before = (wavenet_block.RESIDUAL.launches,
              wavenet_block.RESIDUAL_BWD.launches)
    x_out, skips_out = wavenet_block.residual(p, bias, x, skips)
    dp = wavenet_block.residual_backward(dxo, dskips)
    torch.cuda.synchronize()
    assert (wavenet_block.RESIDUAL.launches,
            wavenet_block.RESIDUAL_BWD.launches) == (before[0] + 1,
                                                     before[1] + 1)
    ref_x, ref_skips = wavenet_block.residual_plain(p, bias, x, skips)
    assert torch.equal(x_out, ref_x)
    assert torch.equal(skips_out, ref_skips)
    assert torch.equal(dp, wavenet_block.residual_backward_plain(dxo, dskips))


def _net(dev, seed=0):
    net = WaveNet(**R9Y9)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(dev)


def _norm_gaps(prog, ref):
    norms = {k: float(v.norm()) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    return {k: float((prog[k] - ref[k]).norm()) / max(norms[k], median)
            for k in ref}


def test_bf16_path_matches_plain_path_at_r9y9_widths(dev, monkeypatch):
    net = _net(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    B, T = 2, 2048
    x = torch.randint(0, 256, (B, T), generator=g, device=dev)
    cond = torch.randn(B, T, 23, generator=g, device=dev)
    target = torch.randint(0, 256, (B, T), generator=g, device=dev)
    out = {}
    for bf16 in (False, True):
        net.zero_grad(set_to_none=True)
        # The plain path on the card, as the CPU runs it.
        monkeypatch.setattr(wavenet_lib, "_bf16_path", lambda x: bf16)
        logits = net(x, cond)
        torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                          target.reshape(-1)).backward()
        out[bf16] = (logits.detach(), {
            n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for n, p in net.named_parameters()})
    logits_err = ((out[True][0] - out[False][0]).abs().max()
                  / out[False][0].abs().max()).item()
    grad_err = max(_norm_gaps(out[True][1], out[False][1]).values())
    print("bf16 path against plain: logits {:.3e}, worst gradient leaf "
          "{:.3e}".format(logits_err, grad_err))
    assert logits_err <= LOGITS_TOL
    assert grad_err <= GRAD_TOL


def test_forward_on_the_card_takes_the_bf16_path(dev):
    net = _net(dev, seed=1)
    x = torch.randint(0, 256, (1, 64), device=dev)
    cond = torch.randn(1, 64, 23, device=dev)
    before = wavenet_gate.GATE_FWD.launches
    with torch.no_grad():
        net(x, cond)
    assert wavenet_gate.GATE_FWD.launches == before + R9Y9["num_layers"]


def test_step_peak_memory_at_the_benchmarks_batch(dev):
    net = _net(dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    B, T = 32, 8192
    x = torch.randint(0, 256, (B, T), generator=g, device=dev)
    cond = torch.randn(B, T, 23, generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    logits = net(x, cond)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                             x.reshape(-1))
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    print("one step of {} x {}: peak {:.2f} GB above the inputs and "
          "weights".format(B, T, peak / 1e9))
    assert torch.isfinite(loss)
    assert peak < STEP_PEAK_BYTES
