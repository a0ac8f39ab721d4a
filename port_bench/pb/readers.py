"""The arithmetic the metric readers (``metrics/<name>.py``) share.

Each reader takes a run's record and returns its number, or None where
the record holds nothing to read it from.  Shares are in percent.
"""

import numpy as np

from pb import roofline, trace


def p95_ms(latency_s):
    """The 95th percentile of every request's latency, a sample value
    (``inverted_cdf``), in ms."""
    if not latency_s:
        return None
    return float(np.quantile(np.asarray(latency_s, np.float64), 0.95,
                             method="inverted_cdf")) * 1e3


def rate(record, amount):
    if amount not in record or not record.get("window_s"):
        return None
    return record[amount] / record["window_s"]


def mean_ms(record, key, scale=1.0):
    values = record.get(key)
    if not values:
        return None
    return float(np.mean(values)) * scale


def idle_share(record):
    stretch = record.get("stretch")
    if not stretch or not stretch["window_s"] or not trace.complete(stretch):
        return None
    return 100.0 * (1.0 - stretch["busy_s"] / stretch["window_s"])


def mfu(flops, seconds, chips=1):
    if not seconds:
        return None
    return 100.0 * flops / seconds / (roofline.PEAK_BF16_FLOPS * chips)


def lstm_roofline(record, kernel, what):
    """Share of ``kernel``'s roofline over a traced stretch: the least
    time of every launch made by the units (pipeline calls, train steps)
    wholly inside the stretch, one a BiLSTM layer at the unit's padded
    length ``T``, ``rows`` and residual bytes, over the kernel's device
    time in those units."""
    stretch = record.get("stretch")
    if not stretch:
        return None
    units = stretch.get("units", [])
    device_s = sum(u["kernel_s"][kernel] for u in units)
    if device_s <= 0:
        return None
    layers = roofline.recurrent_layers(record["config"])
    least = sum(roofline.lstm_bound_s(u["T"], 2 * u["rows"], D, F, what,
                                      u.get("residual_bytes", 4))
                for u in units for D, F in layers)
    return 100.0 * least / device_s


def calls_in_window(record):
    """The pipeline calls of a traced serving run that began inside its
    window."""
    if "window_ns" not in record:
        return []
    w0, w1 = record["window_ns"]
    return [c for c in record.get("calls", []) if w0 <= c["start_ns"] < w1]
