"""Serving front door of the port: request batching over
:class:`idiaptts_torch.synth.pipeline.FusedAcousticPipeline`.

The port's copy of ``idiaptts_tpu/synth/server.py``.  One dispatch
thread collects concurrent requests, groups them per length bucket (the
pipeline pads to ``bucket`` multiples, so any mix of lengths inside one
bucket shares one batch), runs them back to back and hands each caller
its waveform; a partially filled batch launches after ``max_wait_ms``:

  server = SynthesisServer(pipeline, model, max_batch=8, max_wait_ms=5)
  wav = server.submit(question_matrix).result()   # (T * hop,) float32

``stats()`` reports batch occupancy and the realtime factor.
"""

import logging
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

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
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit(self, questions):
        """Enqueue one utterance's (T, D) question matrix; returns a
        ``concurrent.futures.Future`` resolving to the (T*hop,) float32
        waveform."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        future = Future()
        self._queue.put((np.asarray(questions, np.float32), future))
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
        seconds produced, busy seconds and the realtime factor."""
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
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.time() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _loop(self):
        while not self._stop.is_set() or not self._queue.empty():
            batch = self._collect()
            if not batch:
                continue
            # Group by padded-length bucket: mixing buckets would pad
            # every utterance to the longest.
            bucket = self.pipeline.bucket
            groups = {}
            for q, f in batch:
                key = int(np.ceil(max(len(q), 1) / bucket) * bucket)
                groups.setdefault(key, []).append((q, f))
            for _, group in sorted(groups.items()):
                questions = [q for q, _ in group]
                futures = [f for _, f in group]
                # Pad the batch to the next power of two, which bounds the
                # set of batch shapes the pipeline sees; padding rows are
                # zeros and their outputs are dropped.
                n = len(questions)
                target = 1
                while target < n:
                    target *= 2
                for _ in range(target - n):
                    questions.append(np.zeros_like(questions[0]))
                t0 = time.time()
                try:
                    wavs = self.pipeline(self.params, questions)
                except Exception as exc:  # resolve, never deadlock
                    logger.exception("synthesis batch failed")
                    for future in futures:
                        future.set_exception(exc)
                    continue
                busy = time.time() - t0
                fs = self.pipeline.fs
                with self._lock:
                    self._batches += 1
                    self._requests += len(group)
                    self._busy_seconds += busy
                    self._audio_seconds += sum(
                        len(w) for w in wavs[:n]) / float(fs)
                for future, wav in zip(futures, wavs[:n]):
                    future.set_result(wav)
        # Drain: reject anything still queued after shutdown.
        self._drain_rejected()
