"""Share of the WaveNet gate kernel's roofline (csrc/wavenet_gate.cu,
forward and backward) over the traced stretch of train steps: the least
time of every gate launch the stretch counted, from the bytes the gate
needs (``pb/wavenet_model.py:gate_bytes``), over the gate kernels'
device time in the stretch.  None for a stretch whose gate records lost
their time (``drivers/wavenet_train.py:gate_records``)."""

from pb import roofline, trace, wavenet_model


def read(record):
    stretch = record.get("stretch")
    shape = record.get("gate")
    if not stretch or not shape or not trace.complete(stretch) \
            or stretch.get("untimed_gate_records", 0):
        return None
    launches = stretch.get("gate_launches") or {}
    device_s = sum(s for name, s in stretch["kernel_s"].items()
                   if "wavenet_gate_" in name)
    if device_s <= 0 or not any(launches.values()):
        return None
    least = sum(n * roofline.bound_s(0.0, wavenet_model.gate_bytes(
        shape["rows"], shape["G"], kind == "bwd"))[0]
        for kind, n in launches.items())
    return 100.0 * least / device_s
