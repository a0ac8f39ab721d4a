"""The yardstick's arithmetic: the card's peaks, each kernel's least
time (its bound) from its shapes, and the model's operations a frame.

The bounds are frozen copies of ``chip_smoke.py``'s ``bound`` and
``lstm_bound``; the operations a frame generalise its
``fwd_flops_per_frame`` (dense layers, the recurrences' x- and h-side
products per direction, the output layer) to any configuration's
``layers`` list: 40,820,736 a frame for the Interspeech'18 BiLSTM at
D_in = 409, as ``fwd_flops_per_frame(409, 67)`` gives.
"""

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops, nbytes, flop_peak=PEAK_BF16_FLOPS):
    """(seconds, what bounds it): the larger of the operations at the
    peak rate and the bytes at the memory bandwidth."""
    ops = flops / flop_peak
    mem = nbytes / PEAK_HBM_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def lstm_bound_s(T, R, D, F, what, res_bytes=4, ndir=2):
    """Least seconds of one BiLSTM kernel launch over T steps of R rows
    (ndir x Bp): the bf16 products it needs, each input read and each
    output written once.  ``what``: "proj" (bf16(x Wx) + b), "rec" (the
    inference recurrence, K3), "rec_train" (plus the gates and cells in
    ``res_bytes``-byte residuals, K4), "bwd" (dz from the residuals, the
    upstream dL/dh and Wh, K5)."""
    G = 4 * F
    if what == "proj":
        return bound_s(2.0 * T * R * D * G,
                       T * R * D * 2 + ndir * D * G * 2 + ndir * G * 4
                       + T * R * G * 4)[0]
    rec_flops = 2.0 * T * R * F * G
    wh_bytes = ndir * F * G * 2
    if what == "rec":
        return bound_s(rec_flops, T * R * G * 4 + wh_bytes
                       + T * R * F * 4)[0]
    if what == "rec_train":
        return bound_s(rec_flops, T * R * G * 4 + wh_bytes + T * R * F * 4
                       + T * R * (G + F) * res_bytes)[0]
    if what == "bwd":
        return bound_s(rec_flops, T * R * (G + 2 * F) * res_bytes
                       + wh_bytes + T * R * G * 4)[0]
    raise ValueError(what)


def flops_per_frame(config):
    """Forward model operations a frame (multiply-adds counted twice)."""
    dim = int(config["d_in"])
    total = 0
    for layer in config["layers"]:
        kind, width = layer["kind"], int(layer["width"])
        for _ in range(int(layer.get("count", 1))):
            if kind == "dense":
                total += 2 * dim * width
                dim = width
            elif kind in ("bilstm", "bigru"):
                gates = 4 if kind == "bilstm" else 3
                total += 2 * (2 * dim * gates * width
                              + 2 * width * gates * width)
                dim = 2 * width
            else:
                raise ValueError(kind)
    return total


def recurrent_layers(config):
    """[(input width, F)] of each BiLSTM layer."""
    out, dim = [], int(config["d_in"])
    for layer in config["layers"]:
        for _ in range(int(layer.get("count", 1))):
            width = int(layer["width"])
            if layer["kind"] == "bilstm":
                out.append((dim, width))
            dim = width if layer["kind"] == "dense" else 2 * width
    return out
