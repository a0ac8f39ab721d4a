"""CUDA graphs of a network part's training forward and its backward,
captured once per input shape and parameter storage and replayed after.

A part whose kernels are short beside the host's cost of launching them
(the WaveNet's residual blocks: ~10 launches a block each way) runs, in
training, as two graph replays: its forward and its backward.  The
graphs replay the eager part's kernels in the same order on the same
data, so their results are the eager part's bit for bit.

- :func:`action` is the rule.  Graphs serve a forward on a CUDA device,
  with grad enabled and something that needs a gradient, in training
  mode.  The key is the inputs' shapes, dtypes and ``requires_grad``
  and the parameters' storage pointers (Adam updates them in place, so
  a key holds while they stay where they are); the captures made for
  other storage are dropped.  A new key is captured while the bytes
  held by the captures of the current storage, and those of the new
  one reckoned from their bytes a row, stay under the cache's budget;
  past it, and everywhere else, the part runs eager.  The budget is
  half the device's memory unless given: a capture holds what the eager
  part holds during its step (~29 GB of saved tensors at
  ``wavenet.train``'s batch).  A budget of 0 captures nothing.
- :class:`GraphCache` holds the captures and counts ``captures``,
  ``replays`` and ``eager`` calls.  A capture warms the part up once on
  the cache's own stream (lazy set-up, cuBLAS's workspace for that
  stream), then captures the forward and, from its outputs, the
  backward into one private memory pool: the gradients of the inputs
  that need one and of the parameters, gathered into one flat buffer.
- :class:`_Replay` is one autograd function.  Its forward copies each
  input whose storage is not the capture's own into it and replays the
  forward; its backward replays the backward and hands the gradients
  back in fresh memory, so no ``.grad`` aliases the graph's buffers.
  While a replay's backward is still to run, the next forward at its
  key runs eager; a backward whose saved tensors a later replay
  overwrote raises.

Launches inside a capture are counted for the graph
(:func:`idiaptts_torch.ops.dispatch.capturing`), and each replay adds
them to the kernels' counters, so ``dispatch.counts()`` reads as on the
eager path.
"""

import contextlib
import weakref

import torch

from idiaptts_torch.ops import dispatch

REPLAY, CAPTURE, EAGER = "replay", "capture", "eager"


def key_of(inputs, params):
    """(rows: the first input's elements, the inputs' device, shapes,
    dtypes and ``requires_grad``, the parameters' storage pointers and
    ``requires_grad``)."""
    return (inputs[0].numel(),
            (str(inputs[0].device),) + tuple(
                (tuple(t.shape), t.dtype, t.requires_grad) for t in inputs),
            tuple((p.data_ptr(), p.requires_grad) for p in params))


def action(device_type, grad_enabled, training, key, cache, budget):
    """(REPLAY, CAPTURE or EAGER, the keys of ``cache`` to drop) for a call
    at ``key`` (:func:`key_of`).  ``cache`` maps keys to captures with
    ``rows``, ``bytes`` and ``pending`` (a replay's backward still to
    run); ``budget`` is in bytes."""
    if device_type != "cuda" or not grad_enabled or not training:
        return EAGER, []
    storage = key[2]
    stale = [k for k in cache if k[2] != storage]
    if key in cache:
        return (EAGER if cache[key].pending else REPLAY), stale
    live = [e for k, e in cache.items() if k[2] == storage]
    held = sum(e.bytes for e in live)
    per_row = max((e.bytes / e.rows for e in live), default=0.0)
    if held + key[0] * per_row < budget:
        return CAPTURE, stale
    return EAGER, stale


class _Token:
    """Held by a replay's autograd node while its backward may run."""


class _Capture:
    """One key's forward and backward graphs and their static tensors."""

    def __init__(self, rows):
        self.rows = rows
        self.bytes = 0
        self._live = None

    @property
    def pending(self):
        """A replay's backward is still to run (its node is alive)."""
        return self._live is not None and self._live() is not None

    def begin(self):
        token = _Token()
        self._live = weakref.ref(token)
        return token

    def end(self, token):
        if self._live is None or self._live() is not token:
            raise RuntimeError(
                "a graphed backward whose saved tensors are gone: the "
                "forward was replayed again before it, or it ran twice")
        self._live = None


@contextlib.contextmanager
def _fresh_leaves(named):
    """Each ``(module, name)`` parameter replaced, inside the block, by a
    new leaf on its storage; yields them.  The capture's autograd graph
    then reaches no gradient accumulator that an earlier graph still
    alive (a loop's last loss) made on another stream: autograd would
    join the two streams inside the capture, which breaks it."""
    held = [(module, name, getattr(module, name)) for module, name in named]
    for module, name, p in held:
        setattr(module, name, torch.nn.Parameter(
            p.detach(), requires_grad=p.requires_grad))
    try:
        yield [getattr(module, name) for module, name, _ in held]
    finally:
        for module, name, p in held:
            setattr(module, name, p)


def _capture(fn, inputs, named, stream):
    device = inputs[0].device
    static = [t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    current = torch.cuda.current_stream(device)
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    with _fresh_leaves(named) as leaves:
        leaves = [p for p in leaves if p.requires_grad]
        wrt = [t for t in static if t.requires_grad] + leaves
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # Lazy set-up stays out of the capture.
            outs = fn(*static)
            torch.autograd.grad(outs, wrt,
                                [torch.zeros_like(o) for o in outs],
                                allow_unused=True)
            del outs
        current.wait_stream(stream)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        with dispatch.capturing() as fwd_launches, torch.cuda.graph(
                fwd, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            outs = fn(*static)
        douts = [torch.empty_like(o) for o in outs]
        with dispatch.capturing() as bwd_launches, torch.cuda.graph(
                bwd, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            grads = torch.autograd.grad(outs, wrt, douts, allow_unused=True)
            flat = torch.cat([(torch.zeros_like(t) if g is None else g)
                              .reshape(-1) for t, g in zip(wrt, grads)])
    entry = _Capture(inputs[0].numel())
    entry.fwd, entry.bwd = fwd, bwd
    entry.fwd_launches, entry.bwd_launches = fwd_launches, bwd_launches
    entry.inputs = static
    entry.outputs = [o.detach() for o in outs]
    entry.douts = douts
    entry.flat = flat
    entry.wrt = [(t.shape, t.dtype, t.numel()) for t in wrt]
    entry.needs = [t.requires_grad for t in static] + [True] * len(leaves)
    entry.bytes = torch.cuda.memory_reserved(device) - before
    return entry


class _Replay(torch.autograd.Function):
    """The captured forward and backward of one key."""

    @staticmethod
    def forward(ctx, entry, *args):
        for static, t in zip(entry.inputs, args):
            if static.data_ptr() != t.data_ptr():
                static.copy_(t)
        entry.fwd.replay()
        dispatch.credit(entry.fwd_launches)
        ctx.entry, ctx.token = entry, entry.begin()
        return tuple(o.detach() for o in entry.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *douts):
        entry = ctx.entry
        entry.end(ctx.token)
        for static, d in zip(entry.douts, douts):
            if static.data_ptr() != d.data_ptr():
                static.copy_(d)
        entry.bwd.replay()
        dispatch.credit(entry.bwd_launches)
        fresh = entry.flat.clone()
        grads, at = [], 0
        for shape, dtype, n in entry.wrt:
            grads.append(fresh[at:at + n].view(shape).to(dtype))
            at += n
        grads = iter(grads)
        return (None,) + tuple(next(grads) if needs else None
                               for needs in entry.needs)


class GraphCache:
    """A network part's captures, by key (see the module docstring)."""

    def __init__(self, budget=None):
        self.budget = budget
        self.entries = {}
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._stream = None

    def __reduce__(self):
        # A copy of the module (deepcopy, pickle) starts with none.
        return GraphCache, (self.budget,)

    def __call__(self, fn, inputs, named, training):
        """``fn(*inputs)``, a tuple of tensors computed from ``inputs``
        and the parameters ``named`` names (``(module, attribute)``
        pairs): replayed, captured or run eager by :func:`action`.
        Returns (its outputs, whether a graph ran)."""
        device = inputs[0].device
        params = [getattr(module, name) for module, name in named]
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*inputs, *params))
        engage = device.type == "cuda" and grad and training
        key = key_of(inputs, params) if engage else None
        budget = 0
        if engage:
            budget = self.budget if self.budget is not None else \
                torch.cuda.get_device_properties(device).total_memory // 2
        what, stale = action(device.type, grad, training, key, self.entries,
                             budget)
        for k in stale:
            del self.entries[k]
        if what == EAGER:
            self.counts["eager"] += 1
            return fn(*inputs), False
        if what == CAPTURE:
            if self._stream is None or self._stream.device != device:
                self._stream = torch.cuda.Stream(device)
            self.entries[key] = _capture(fn, inputs, named, self._stream)
            self.counts["captures"] += 1
        else:
            self.counts["replays"] += 1
        return _Replay.apply(self.entries[key], *inputs,
                             *[p for p in params if p.requires_grad]), True
