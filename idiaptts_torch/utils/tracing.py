"""Spans inside the port, kept in memory on the host clock that
``torch.profiler`` stamps its events with (``time.time_ns()``).

Off by default.  While off, :func:`span` tests one module global and
returns the shared no-op :data:`NOOP`: it reads no clock, records
nothing and never synchronises.  A measurement turns it on around the
stretch it wants and takes the spans back:

  from idiaptts_torch.utils import tracing
  tracing.enable()                 # or enable(sink=spans.add)
  with tracing.span("pipeline.model", device=self.device):
      out = self.model_stage(...)
  spans = tracing.drain()          # [{name, t0_ns, t1_ns, ...}, ...]

A span records its name, its start and end, an id, the id of the span
that was open on its thread when it began (its parent), the thread's
name and its attrs.  With ``device`` (``True`` for the current CUDA
device, or a ``torch.device``) it also records a CUDA event pair on that
device's current stream; :func:`drain` resolves the pairs to
``device_ms`` after one synchronise a device, so nothing on the traced
path waits on them.  Where the device is not a CUDA one ``device_ms`` is
None.  ``sink(name, t0_ns, t1_ns, **attrs)``, where given, is called as
each span ends.
"""

import itertools
import threading
import time

_on = False
_sink = None
_lock = threading.Lock()
_spans = []
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """Attrs known only inside the span (ignored)."""


NOOP = _Off()


def enabled():
    """Whether spans are being recorded."""
    return _on


def enable(sink=None):
    """Record spans from now on (every thread); ``sink`` is called with
    ``(name, t0_ns, t1_ns, **attrs)`` as each span ends."""
    global _on, _sink
    _sink = sink
    _on = True


def disable():
    """Record no new span; spans already open still end and count."""
    global _on, _sink
    _on = False
    _sink = None


def span(name, device=False, **attrs):
    """A context manager recording one span, or :data:`NOOP` when off."""
    if not _on:
        return NOOP
    return _Span(name, device, attrs)


def add(name, t0_ns, t1_ns, **attrs):
    """Record a span that has already ended, from the caller's own clock
    reads.  Its parent is the span open on this thread; the spans this
    thread recorded inside [t0_ns, t1_ns] under that same parent become
    its children."""
    if not _on:
        return
    stack = _stack()
    parent = stack[-1].id if stack else None
    thread = threading.current_thread().name
    new = next(_ids)
    with _lock:
        for rec in reversed(_spans):
            if rec["thread"] != thread:
                continue
            if rec["t1_ns"] < t0_ns:
                break
            if rec["parent"] == parent and rec["t0_ns"] >= t0_ns \
                    and rec["t1_ns"] <= t1_ns:
                rec["parent"] = new
    _record(name, t0_ns, t1_ns, new, parent, thread, attrs, None)


def drain():
    """Every span recorded since the last drain, as dicts (``name``,
    ``t0_ns``, ``t1_ns``, ``id``, ``parent``, ``thread``, ``attrs``,
    ``device_ms``), in the order they ended."""
    global _spans
    with _lock:
        spans, _spans = _spans, []
    pending = [s for s in spans if s["device_ms"] is not None]
    if pending:
        import torch
        for index in {s["device_ms"][2] for s in pending}:
            torch.cuda.synchronize(index)
        for s in pending:
            start, end, _ = s["device_ms"]
            s["device_ms"] = start.elapsed_time(end)
    return spans


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name, t0_ns, t1_ns, ident, parent, thread, attrs, events):
    rec = {"name": name, "t0_ns": t0_ns, "t1_ns": t1_ns, "id": ident,
           "parent": parent, "thread": thread, "attrs": attrs,
           "device_ms": events}
    with _lock:
        _spans.append(rec)
    sink = _sink
    if sink is not None:
        sink(name, t0_ns, t1_ns, **attrs)


def _cuda_stream(device):
    """The current stream of ``device``'s CUDA device, or None where
    ``device`` is not a CUDA device (or, for ``True``, CUDA is not
    initialised)."""
    import torch
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.current_stream()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "t0",
                 "events")

    def __init__(self, name, device, attrs):
        self.name = name
        self.device = device
        self.attrs = attrs
        self.events = None

    def set(self, **attrs):
        """Attrs known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.t0 = time.time_ns()
        if self.device:
            stream = _cuda_stream(self.device)
            if stream is not None:
                import torch
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                self.events = (start, stream)
        # Pushed last: a failed event record leaves no open span behind.
        stack.append(self)
        return self

    def __exit__(self, *exc):
        events = None
        if self.events is not None:
            import torch
            start, stream = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            events = (start, end, stream.device.index)
        t1 = time.time_ns()
        _stack().pop()
        _record(self.name, self.t0, t1, self.id, self.parent,
                threading.current_thread().name, self.attrs, events)
        return False
