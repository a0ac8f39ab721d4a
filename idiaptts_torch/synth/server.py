"""Serving front door of the port.

``idiaptts_tpu.synth.server.SynthesisServer`` is plain Python threads and
numpy, with no JAX; it batches concurrent requests per length bucket
over any pipeline with the ``bucket``/``fs``/``__call__(params,
questions)`` surface, which
:class:`idiaptts_torch.synth.pipeline.FusedAcousticPipeline` keeps.  So
the port reuses it by import rather than by copy:

  server = SynthesisServer(pipeline, model, max_batch=8, max_wait_ms=5)
  wav = server.submit(question_matrix).result()   # (T * hop,) float32
"""

from idiaptts_tpu.synth.server import SynthesisServer

__all__ = ["SynthesisServer"]
