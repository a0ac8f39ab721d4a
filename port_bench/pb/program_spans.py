"""The program's own spans (``idiaptts_torch.utils.tracing``) read out
of a traced run: the per-layer numbers they give, the device's idle
time by the span over each gap, and whether the profiler's clock agreed
with the host's.

A record here is a traced run's record that also holds
``program_spans`` (the recorder's drained spans: dicts with ``name``,
``t0_ns``, ``t1_ns``, ``id``, ``parent``, ``thread``, ``attrs`` and
``device_ms``) and ``program_window_ns`` (the window on the same
clock).  A span counts in the window where it began inside it; a
request counts where it was submitted inside it, whenever its batch
ran.  Each reader in :data:`METRICS` returns None where the record
holds nothing to read.
"""

import numpy as np

from pb import trace
from pb.readers import p95_ms

# Spans of a thread that runs beside the one feeding the device (the
# trainer's prefetch thread): they label no gap (the feeding thread's
# span says where it stood), and the idle time they overlap is summed
# apart (``idle_beside``): that thread holds the interpreter lock in
# turns with the feeding one.
UNLABELLED = ("loader.collate",)


def named(record, name):
    """The window's spans called ``name``."""
    if "program_window_ns" not in record:
        return []
    w0, w1 = record["program_window_ns"]
    return [s for s in record.get("program_spans") or ()
            if s["name"] == name and w0 <= s["t0_ns"] < w1]


def mean_host_ms(record, name, scale=1e-6):
    spans = named(record, name)
    if not spans:
        return None
    return float(np.mean([s["t1_ns"] - s["t0_ns"] for s in spans])) * scale


def mean_device_ms(record, name):
    values = [s["device_ms"] for s in named(record, name)
              if s["device_ms"] is not None]
    return float(np.mean(values)) if values else None


def request_seconds(record, end=False):
    """Each request submitted in the window: seconds from its submit to
    the start (``end``: the end) of the ``server.batch`` that served
    it."""
    if "program_window_ns" not in record:
        return []
    w0, w1 = record["program_window_ns"]
    out = []
    for b in record.get("program_spans") or ():
        if b["name"] != "server.batch":
            continue
        edge = b["t1_ns"] if end else b["t0_ns"]
        out += [(edge - submit) / 1e9 for _, submit in b["attrs"]["requests"]
                if w0 <= submit < w1]
    return out


def wait_p95_ms(record):
    return p95_ms(request_seconds(record))


def served_p95_ms(record):
    """The 95th percentile of submit to the end of the serving batch."""
    return p95_ms(request_seconds(record, end=True))


def real_frame_share(record):
    batches = named(record, "server.batch")
    cells = sum(b["attrs"]["rows"] * b["attrs"]["T"] for b in batches)
    if not cells:
        return None
    return 100.0 * sum(b["attrs"]["real_frames"] for b in batches) / cells


def idle_with_work_share(record):
    """The stretch's idle share less the idle time under ``server.idle``
    (the dispatcher waiting for a first request)."""
    stretch = record.get("stretch")
    if not stretch or "idle_by_span" not in stretch \
            or not stretch["window_s"] or not trace.complete(stretch):
        return None
    idle = stretch["window_s"] - stretch["busy_s"]
    return 100.0 * (idle - stretch["idle_by_span"].get("server.idle", 0.0)) \
        / stretch["window_s"]


def step_phases_share(record):
    """The four train phases' mean device ms over the window's wall time
    a step, in percent."""
    phases = [mean_device_ms(record, "train." + p)
              for p in ("upload", "forward", "backward", "optimiser")]
    if None in phases or not record.get("steps"):
        return None
    return 100.0 * sum(phases) / (1e3 * record["window_s"] / record["steps"])


METRICS = {
    "server.wait_p95_ms.serve": wait_p95_ms,
    "server.real_frame_share.serve": real_frame_share,
    "pipeline.prepare_ms.serve":
        lambda r: mean_host_ms(r, "pipeline.prepare"),
    "pipeline.vocoder_ms.serve":
        lambda r: mean_device_ms(r, "pipeline.vocoder"),
    "dispatch.host_us.serve":
        lambda r: mean_host_ms(r, "dispatch.launch", 1e-3),
    "device.idle_with_work_share.serve": idle_with_work_share,
    "train.upload_ms.train": lambda r: mean_device_ms(r, "train.upload"),
    "train.forward_ms.train": lambda r: mean_device_ms(r, "train.forward"),
    "train.backward_ms.train":
        lambda r: mean_device_ms(r, "train.backward"),
    "train.optimiser_ms.train":
        lambda r: mean_device_ms(r, "train.optimiser"),
    "loader.collate_ms.train":
        lambda r: mean_host_ms(r, "loader.collate"),
}


def read(record, kind):
    """{metric: value} of :data:`METRICS` ending in ``.<kind>`` that
    find something to read."""
    out = {}
    for name, reader in METRICS.items():
        if name.endswith("." + kind):
            value = reader(record)
            if value is not None:
                out[name] = value
    return out


def device_intervals(events):
    """(start, end) ns of the device's kernels, copies and sets, as
    ``trace.summarise`` takes them."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if str(e.device_type()).endswith("CUDA")
            and not e.name().startswith(trace.SYNC_RECORDS)]


def idle_by_span(device, t0, t1, spans, beside=()):
    """``trace.summarise``'s window, gaps and gap labels (the innermost
    span over a gap's middle), over the whole stretch: {"idle_by_span":
    idle seconds summed by label, "clock_aligned": False where the
    device events fell outside the host window and the window was taken
    from their extent, "idle_beside": idle seconds that each name of
    ``beside`` overlaps}.  ``device`` holds (start, end) ns intervals,
    ``spans`` and ``beside`` (name, start, end, info) tuples."""
    aligned = True
    if device:
        inside = sum(1 for a, b in device if a >= t0 and b <= t1 + 5e7)
        if inside < 0.5 * len(device):
            aligned = False
            t0 = min(a for a, _ in device)
            t1 = max(b for _, b in device)
    busy = trace._union([(max(a, t0), min(b, t1)) for a, b in device
                         if b > t0 and a < t1])
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    # One sweep in time order: the spans begun by a gap's middle, less
    # those ended before it.
    spans = sorted(spans, key=lambda s: s[1])
    active, j, by_span = [], 0, {}
    for a, b in gaps:
        t = (a + b) // 2
        while j < len(spans) and spans[j][1] <= t:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] >= t]
        label = trace._label(t, active)[:trace.NAME_CHARS]
        by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e9
    overlap = {}
    for name in sorted({s[0] for s in beside}):
        runs = trace._union([(s[1], s[2]) for s in beside if s[0] == name])
        overlap[name] = sum(max(0, min(b, d) - max(a, c))
                            for a, b in gaps for c, d in runs) / 1e9
    return {"idle_by_span": by_span, "clock_aligned": aligned,
            "idle_beside": overlap}


class StretchSpans:
    """In place of ``trace.summarise`` (set as ``trace.summarise``): it
    hands the summary only the spans near the stretch (a long window
    holds tens of thousands) and keeps what :func:`idle_by_span` needs;
    :meth:`finish`, called after the window with the drained program
    spans, adds its keys to each summary, so the window's host pays for
    none of it."""

    def __init__(self, summarise):
        self.summarise = summarise
        self.pending = []

    def __call__(self, events, t0, t1, spans=None, unit=None):
        device = device_intervals(events)
        lo = min([t0] + [a for a, _ in device])
        hi = max([t1] + [b for _, b in device])
        near = trace.Spans()
        if spans is not None:
            near.items = [s for s in spans.items if s[2] >= lo and s[1] <= hi]
        out = self.summarise(events, t0, t1, near, unit)
        self.pending.append((out, device, t0, t1, near.items))
        return out

    def finish(self, program=()):
        beside = [(s["name"], s["t0_ns"], s["t1_ns"], s["attrs"])
                  for s in program if s["name"] in UNLABELLED]
        for out, device, t0, t1, items in self.pending:
            out.update(idle_by_span(device, t0, t1, items, beside))
        self.pending = []


def labels_named(summary):
    """Whether every one of the stretch's longest gaps is labelled by a
    program span (``layer.what``; the harness's own spans and "host:
    outside the harness's spans" have no dot)."""
    return all("." in label for label, _ in summary["idle_gaps"])
