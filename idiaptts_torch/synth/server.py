"""Serving front door of the port: request batching over
:class:`idiaptts_torch.synth.pipeline.FusedAcousticPipeline`.

The port's copy of ``idiaptts_tpu/synth/server.py``.  One dispatch
thread collects concurrent requests, groups them per length bucket (the
pipeline pads to ``bucket`` multiples, so any mix of lengths inside one
bucket shares one batch), runs them back to back and hands each caller
its waveform; a partially filled batch launches after ``max_wait_ms``:

  server = SynthesisServer(pipeline, model, max_batch=8, max_wait_ms=5)
  wav = server.submit(question_matrix).result()   # (T * hop,) float32

``stats()`` reports batch occupancy and the realtime factor.  With
:mod:`idiaptts_torch.utils.tracing` on, the dispatch thread records its
idle wait, each collect, grouping, batch and resolve as spans; each
request carries an id and its submit time into the ``server.batch``
span that serves it.
"""

import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from idiaptts_torch.utils import tracing

logger = logging.getLogger(__name__)


class SynthesisServer:
    """Batching front door over a pipeline with the ``bucket``/``fs``/
    ``__call__(params, questions)`` surface.

    Args:
      pipeline: a ``FusedAcousticPipeline``.
      params: the model forwarded to the pipeline.
      max_batch: maximum requests fused into one batch.
      max_wait_ms: how long a non-full batch waits for company before
        launching anyway (tail-latency bound).
    """

    def __init__(self, pipeline, params, max_batch=32, max_wait_ms=5.0):
        self.pipeline = pipeline
        self.params = params
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._batches = 0
        self._requests = 0
        self._audio_seconds = 0.0
        self._busy_seconds = 0.0
        self._ids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="SynthesisServer")
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, questions):
        """Enqueue one utterance's (T, D) question matrix; returns a
        ``concurrent.futures.Future`` resolving to the (T*hop,) float32
        waveform."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        future = Future()
        self._queue.put((np.asarray(questions, np.float32), future,
                         next(self._ids), time.time_ns()))
        return future

    def synth(self, questions):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(questions).result()

    def shutdown(self, wait=True):
        self._stop.set()
        # Wake the dispatcher if it is blocked on an empty queue.
        self._queue.put(None)
        if wait:
            self._thread.join(timeout=30)
            # A submit() racing with shutdown can land on the queue after
            # the dispatcher exited; reject it so its Future resolves.
            self._drain_rejected()

    def _drain_rejected(self):
        while not self._queue.empty():
            item = self._queue.get()
            if item is not None:
                item[1].set_exception(RuntimeError("server shut down"))

    def stats(self):
        """Serving counters: batches, requests, mean occupancy, audio
        seconds produced, busy seconds (inside pipeline calls) and the
        realtime factor: audio seconds over pipeline-call seconds, not
        over wall time."""
        with self._lock:
            batches = self._batches
            requests = self._requests
            audio = self._audio_seconds
            busy = self._busy_seconds
        return {
            "batches": batches,
            "requests": requests,
            "mean_batch_occupancy": requests / batches if batches else 0.0,
            "audio_seconds": audio,
            "busy_seconds": busy,
            "x_realtime": audio / busy if busy else 0.0,
        }

    # -- dispatch side ---------------------------------------------------
    def _collect(self):
        """Block for the first request, then sweep the queue until the
        batch is full or ``max_wait`` has passed."""
        with tracing.span("server.idle"):
            first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        with tracing.span("server.collect") as span:
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            span.set(taken=len(batch))
        return batch

    def _group(self, batch):
        """[(bucket length, questions, requests)] in bucket order.
        Mixing buckets would pad every utterance to the longest.  Each
        group's questions are padded with zero rows to the next power of
        two, which bounds the set of batch shapes the pipeline sees;
        their outputs are dropped."""
        bucket = self.pipeline.bucket
        groups = {}
        for item in batch:
            key = int(np.ceil(max(len(item[0]), 1) / bucket) * bucket)
            groups.setdefault(key, []).append(item)
        out = []
        for key, group in sorted(groups.items()):
            questions = [item[0] for item in group]
            target = 1
            while target < len(group):
                target *= 2
            questions += [np.zeros_like(questions[0])] * (target - len(group))
            out.append((key, questions, group))
        return out

    def _loop(self):
        while not self._stop.is_set() or not self._queue.empty():
            batch = self._collect()
            if not batch:
                continue
            with tracing.span("server.group") as span:
                groups = self._group(batch)
                span.set(groups=len(groups))
            for T, questions, group in groups:
                futures = [item[1] for item in group]
                n = len(group)
                t0 = time.time_ns()
                try:
                    wavs = self.pipeline(self.params, questions)
                except Exception as exc:  # resolve, never deadlock
                    logger.exception("synthesis batch failed")
                    for future in futures:
                        future.set_exception(exc)
                    continue
                t1 = time.time_ns()
                if tracing.enabled():
                    tracing.add(
                        "server.batch", t0, t1, rows=len(questions),
                        real_rows=n, T=T,
                        real_frames=sum(len(item[0]) for item in group),
                        requests=[[item[2], item[3]] for item in group])
                fs = self.pipeline.fs
                with self._lock:
                    self._batches += 1
                    self._requests += n
                    self._busy_seconds += (t1 - t0) / 1e9
                    self._audio_seconds += sum(
                        len(w) for w in wavs[:n]) / float(fs)
                with tracing.span("server.resolve", n=n):
                    for future, wav in zip(futures, wavs[:n]):
                        future.set_result(wav)
        # Drain: reject anything still queued after shutdown.
        self._drain_rejected()
