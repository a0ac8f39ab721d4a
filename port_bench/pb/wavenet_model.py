"""The WaveNet configuration's weights layout, its seeded weights and its
yardstick arithmetic (``configs/r9y9_wavenet_mulaw.json``).

Names and shapes follow the flax tree that the program's
``WaveNetWrapper`` mirrors, under its ``wavenet.`` prefix:

- ``input_embed.embedding`` (Q, R), drawn N(0, 1 / R);
- per block i: ``dilated.kernel`` (k, R, G), ``cond.kernel`` (C, G),
  ``skip.kernel`` (H, S), ``res.kernel`` (H, R), each with its
  ``.bias``;
- ``post1`` (S, S) and ``post2`` (S, Q) with their biases.

Each kernel is N(0, gain^2 / fan_in) (fan_in k R for the dilated
convolution), each bias N(0, bias_std^2): one N(0, 1) draw on the
device, as ``pb/weights.py`` draws the other configurations'.
"""

import math

from pb.util import sub_seed


def widths(config):
    """(layers, stacks, R, G, S, k, C, Q) of a configuration."""
    return (int(config["num_layers"]), int(config["num_stacks"]),
            int(config["residual_channels"]), int(config["gate_channels"]),
            int(config["skip_channels"]), int(config["kernel_size"]),
            int(config["cond_channels"]), int(config["out_channels"]))


def layout(config):
    """[(name, shape, fan_in, or None for a bias, or 0 for the
    embedding)] in a fixed order."""
    L, _, R, G, S, k, C, Q = widths(config)
    H = G // 2
    out = [("wavenet.input_embed.embedding", (Q, R), 0)]
    for i in range(L):
        pre = "wavenet.block_{}.".format(i)
        out += [(pre + "dilated.kernel", (k, R, G), k * R),
                (pre + "dilated.bias", (G,), None),
                (pre + "cond.kernel", (C, G), C),
                (pre + "cond.bias", (G,), None),
                (pre + "skip.kernel", (H, S), H),
                (pre + "skip.bias", (S,), None),
                (pre + "res.kernel", (H, R), H),
                (pre + "res.bias", (R,), None)]
    out += [("wavenet.post1.kernel", (S, S), S),
            ("wavenet.post1.bias", (S,), None),
            ("wavenet.post2.kernel", (S, Q), S),
            ("wavenet.post2.bias", (Q,), None)]
    return out


def count(config):
    return sum(math.prod(shape) for _, shape, _ in layout(config))


def seeded(torch, config, seed, device):
    """{name: float32 tensor on ``device``} drawn from ``--seed``."""
    spec = layout(config)
    init = config.get("weights", {})
    gain = float(init.get("gain", 1.0))
    bias_std = float(init.get("bias_std", 0.1))
    R = widths(config)[2]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(count(config), generator=gen, device=device,
                       dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        std = (bias_std if fan_in is None else
               1.0 / math.sqrt(R) if fan_in == 0 else
               gain / math.sqrt(fan_in))
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    return out


def flops_per_sample(config):
    """Forward operations a sample (multiply-adds counted twice): each
    block's dilated convolution, conditioning, skip and residual
    products, and the two output layers."""
    L, _, R, G, S, k, C, Q = widths(config)
    H = G // 2
    block = 2 * (k * R * G + C * G + H * S + H * R)
    return L * block + 2 * (S * S + S * Q)


def gate_bytes(rows, G, backward):
    """The bytes the gate needs for ``rows`` rows, each input read once
    and each output written once, in bf16: forward, the pre-activations
    (G) in and z (G / 2) out; backward, dz (G / 2) and the saved
    pre-activations (G) in, their gradient (G) out."""
    H = G // 2
    per_row = (H + 2 * G) if backward else (G + H)
    return 2 * rows * per_row
