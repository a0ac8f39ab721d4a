"""The benchmark's own wrappers around the calls into the pipeline's
stages (traced runs only): a host span around ``prepare``,
``model_stage``, ``mlpg_stage`` and ``vocoder_stage`` each, and CUDA
events around the model stage.  Spans label the device's idle gaps;
the events give the model stage's device milliseconds a call."""


class StageTimer:
    def __init__(self, torch, pipeline, spans, device):
        self.torch = torch
        self.events = []
        cuda = device.type == "cuda"
        for name in ("prepare", "model_stage", "mlpg_stage",
                     "vocoder_stage"):
            setattr(pipeline, name, self._wrap(
                getattr(pipeline, name), name, spans,
                cuda and name == "model_stage"))

    def _wrap(self, inner, name, spans, events):
        torch = self.torch

        def call(*args, **kwargs):
            with spans.span(name):
                if not events:
                    return inner(*args, **kwargs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*args, **kwargs)
                end.record()
                self.events.append((start, end))
                return out
        return call

    def model_ms(self):
        """Device milliseconds of each model stage so far."""
        if self.events:
            self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]
