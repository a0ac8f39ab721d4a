"""Seeded weights, made on the device in one large draw.

The benchmark makes the weights; the program and the reference both get
them.  Names and shapes follow from the configuration's ``layers`` list
alone (the flax tree names that the program's modules mirror):

- ``dense``: ``g<i>_Linear_<j>.kernel`` (in, out) and ``.bias`` (out,);
- ``bilstm``: ``g<i>_LSTM.bi<j>.Wx`` (2, in, 4F), ``.Wh`` (2, F, 4F),
  ``.b`` (2, 4F), gates [i, f, g, o];
- ``bigru``: ``g<i>_GRU.<fwd|bwd><j>.<ir|iz|in>.kernel`` (in, F) and
  ``.bias``, ``.<hr|hz|hn>.kernel`` (F, F), ``.hn.bias``.

Each kernel is N(0, gain^2 / fan_in), each bias N(0, bias_std^2).
"""

import math

from pb.util import sub_seed


def layout(config):
    """[(name, shape, fan_in or None for a bias)] in a fixed order."""
    out = []
    dim = int(config["d_in"])
    for g, layer in enumerate(config["layers"]):
        kind, width = layer["kind"], int(layer["width"])
        for j in range(int(layer.get("count", 1))):
            if kind == "dense":
                pre = "g{}_Linear_{}".format(g, j)
                out += [(pre + ".kernel", (dim, width), dim),
                        (pre + ".bias", (width,), None)]
                dim = width
            elif kind == "bilstm":
                pre = "g{}_LSTM.bi{}".format(g, j)
                out += [(pre + ".Wx", (2, dim, 4 * width), dim),
                        (pre + ".Wh", (2, width, 4 * width), width),
                        (pre + ".b", (2, 4 * width), None)]
                dim = 2 * width
            elif kind == "bigru":
                for d in ("fwd", "bwd"):
                    pre = "g{}_GRU.{}{}".format(g, d, j)
                    for gate in ("r", "z", "n"):
                        out += [(pre + ".i{}.kernel".format(gate),
                                 (dim, width), dim),
                                (pre + ".i{}.bias".format(gate), (width,),
                                 None),
                                (pre + ".h{}.kernel".format(gate),
                                 (width, width), width)]
                    out.append((pre + ".hn.bias", (width,), None))
                dim = 2 * width
            else:
                raise ValueError("unknown layer kind " + repr(kind))
    return out


def seeded(torch, config, seed, device):
    """{name: float32 tensor on ``device``} drawn from ``--seed``."""
    spec = layout(config)
    init = config.get("weights", {})
    gain = float(init.get("gain", 1.0))
    bias_std = float(init.get("bias_std", 0.1))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        std = bias_std if fan_in is None else gain / math.sqrt(fan_in)
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    return out


def count(config):
    return sum(math.prod(shape) for _, shape, _ in layout(config))
