"""Spans from the benchmark's own wrappers, and ``torch.profiler`` over a
short steady stretch of the window.

The profiler records the device only (kernels, copies and sets through
CUPTI), which keeps its cost on a host-bound loop small; it is started
once during set-up (``prime``) so that starting it in the window does not
stall the card.  A stretch's summary gives the device's busy time (the
union of the intervals in which a kernel, copy or set ran), the device
time by kernel name, the longest idle gaps, each labelled by the
innermost harness span over the gap's middle (what the host was doing),
and the hand kernels' device time within each unit span (a pipeline
call, a train step) that lies wholly inside the stretch, so that a
kernel's roofline sums the bounds of exactly the launches it timed.

Host spans and the profiler's events share one clock (nanoseconds since
the epoch); a summary whose device events fall outside its host window
is taken over the device events' own extent instead.  A stretch that
comes back with copies but no kernel (CUPTI has been seen to drop every
kernel record of a stretch on an H100) is not ``complete``: the drivers
take another later in the window, and the readers read nothing from it.
"""

import contextlib
import time

# Names of the port's hand kernels as the profiler shows them
# (demangled), as chip_smoke.py's port_kernel_ms picks them; the
# recurrence's template instances are <m-tiles, TRAIN, residual type>.
KERNELS = {
    "banded_solve": lambda n: "banded_solve_kernel" in n,
    "bilstm_proj": lambda n: "bilstm_proj_kernel" in n,
    "bilstm_recurrence": lambda n: ("bilstm_recurrence_kernel<" in n
                                    and ", true" not in n),
    "bilstm_recurrence_train": lambda n: ("bilstm_recurrence_kernel<" in n
                                          and ", true" in n),
    "bilstm_bwd": lambda n: "bilstm_bwd_kernel" in n,
}
NAME_CHARS = 160
# CUPTI's synchronisation records mark waits on the device, not work.
SYNC_RECORDS = ("Device Synchronize", "Context Sync", "Stream Sync",
                "Event Sync", "Stream Wait")
# Records of copies and sets, which every stretch holds beside kernels.
COPY_RECORDS = ("Memcpy", "Memset")
# Stretches a traced run takes at most, one after another, until one
# holds kernel records.
TRIES = 3


class Spans:
    """Host spans (name, start ns, end ns, info) from any thread."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def span(self, name, **info):
        t0 = time.time_ns()
        try:
            yield info
        finally:
            self.items.append((name, t0, time.time_ns(), info))

    def add(self, name, t0, t1, **info):
        self.items.append((name, t0, t1, info))

    def named(self, name):
        return [s for s in self.items if s[0] == name]


class Stretch:
    """torch.profiler of the device over a stretch; ``summary`` after
    ``stop``.  Start and stop it from the main thread."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.summary = None

    @property
    def running(self):
        return self.prof is not None

    @property
    def complete(self):
        """The last stretch was stopped and holds kernel records."""
        return self.summary is not None and complete(self.summary)

    def prime(self):
        """Start and stop the profiler once (set-up), so that CUPTI is
        initialised before the window."""
        self.start()
        self.torch.ones(8, device="cuda").sum()
        self.torch.cuda.synchronize()
        self.prof.stop()
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self, spans=None, unit=None):
        self.torch.cuda.synchronize()
        t1 = time.time_ns()
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.summary = summarise(events, self.t0, t1, spans, unit)
        return self.summary


def complete(summary):
    """Whether a stretch's summary holds kernel records, not only
    copies and sets."""
    return summary.get("kernel_events", 1) > 0


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(t, spans):
    inside = [s for s in spans if s[1] <= t <= s[2]]
    if inside:
        return min(inside, key=lambda s: s[2] - s[1])[0]
    return "host: outside the harness's spans"


def _units(device, spans, unit, t0, t1):
    """Each ``unit`` span wholly inside [t0, t1]: its info and the hand
    kernels' device seconds of the launches that began within it."""
    out = []
    for name, a, b, info in spans.items if spans is not None else []:
        if name != unit or a < t0 or b > t1:
            continue
        inside = [(n, s, e) for n, s, e in device if a <= s < b]
        out.append(dict(info, kernel_s={
            k: sum(e - s for n, s, e in inside if pick(n)) / 1e9
            for k, pick in KERNELS.items()}))
    return out


def summarise(events, t0, t1, spans=None, unit=None):
    """Busy and window seconds, device seconds by kernel name, the
    longest idle gaps and the ``unit`` spans' hand-kernel seconds of one
    stretch's profiler events."""
    device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in events if str(e.device_type()).endswith("CUDA")
              and not e.name().startswith(SYNC_RECORDS)]
    if device:
        inside = sum(1 for _, a, b in device if a >= t0 and b <= t1 + 5e7)
        if inside < 0.5 * len(device):
            t0 = min(a for _, a, _ in device)
            t1 = max(b for _, _, b in device)
    clipped = [(max(a, t0), min(b, t1)) for _, a, b in device
               if b > t0 and a < t1]
    busy = _union(clipped)
    by_name = {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0) + (b - a)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    span_items = list(spans.items) if spans is not None else []
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "idle_gaps": [[_label((a + b) // 2, span_items)[:NAME_CHARS],
                       (b - a) / 1e9] for a, b in longest],
        "device_events": len(device),
        "kernel_events": sum(1 for name, _, _ in device
                             if not name.startswith(COPY_RECORDS)),
        "units": _units(device, spans, unit, t0, t1),
    }


def top_ops(kernel_s, count=10):
    return [[name[:NAME_CHARS], s] for name, s in sorted(
        kernel_s.items(), key=lambda kv: -kv[1])[:count]]


def merge(summaries):
    """Several ranks' stretches as one: busy and window seconds averaged
    over the chips, device seconds by name averaged, gaps pooled with
    their rank."""
    n = len(summaries)
    kernel_s = {}
    for s in summaries:
        for k, v in s["kernel_s"].items():
            kernel_s[k] = kernel_s.get(k, 0.0) + v / n
    gaps = [["rank {}: {}".format(r, g[0]), g[1]]
            for r, s in enumerate(summaries) for g in s["idle_gaps"]]
    return {
        "window_s": sum(s["window_s"] for s in summaries) / n,
        "busy_s": sum(s["busy_s"] for s in summaries) / n,
        "kernel_s": kernel_s,
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
        "device_events": sum(s["device_events"] for s in summaries),
        "kernel_events": sum(s.get("kernel_events", 1) for s in summaries),
        "units": [u for s in summaries for u in s["units"]],
    }
