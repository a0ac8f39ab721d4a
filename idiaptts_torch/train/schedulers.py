"""Learning-rate schedulers: the port's copy of
``idiaptts_tpu/train/schedulers.py`` (Constant, Plateau, Exponential,
ExtendedExponential with warmup, decay_steps and min_lr, and Noam;
``create_scheduler`` by name).

Schedulers are host-side state machines producing a scalar lr that the
model handler writes into the optimiser before each step.
"""

import numpy as np


class Scheduler:
    """Base: ``lr(step)`` for per-iteration schedules, ``on_epoch`` /
    ``on_metric`` hooks for epoch-driven ones."""

    def __init__(self, base_lr):
        self.base_lr = base_lr
        self.current_lr = base_lr

    def lr(self, step):
        return self.current_lr

    def on_epoch(self, epoch):
        pass

    def on_metric(self, metric):
        pass

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, state):
        self.__dict__.update(state)


class ConstantScheduler(Scheduler):
    pass


class ExponentialScheduler(Scheduler):
    """lr = base * gamma^t where t counts epochs or scheduler steps."""

    def __init__(self, base_lr, gamma=0.99):
        super().__init__(base_lr)
        self.gamma = gamma
        self.t = 0

    def on_epoch(self, epoch):
        self.t = epoch
        self.current_lr = self.base_lr * self.gamma ** self.t


class ExtendedExponentialScheduler(Scheduler):
    """Exponential decay with warmup, decay_steps scaling and a floor:
    lr(t) = max(min_lr, base * gamma^((t - warmup) / decay_steps)) for
    t > warmup_steps, else base."""

    def __init__(self, base_lr, gamma=0.99, warmup_steps=0,
                 decay_steps=1, min_lr=0.0):
        super().__init__(base_lr)
        self.gamma = gamma
        self.warmup_steps = warmup_steps
        self.decay_steps = max(decay_steps, 1)
        self.min_lr = min_lr

    def lr(self, step):
        if step <= self.warmup_steps:
            self.current_lr = self.base_lr
        else:
            exponent = (step - self.warmup_steps) / self.decay_steps
            self.current_lr = max(self.min_lr,
                                  self.base_lr * self.gamma ** exponent)
        return self.current_lr


class NoamScheduler(Scheduler):
    """lr = base * warmup^0.5 * min(t^-0.5, t * warmup^-1.5)
    (the Tacotron/Transformer schedule used by the WaveNet trainer)."""

    def __init__(self, base_lr, warmup_steps=4000):
        super().__init__(base_lr)
        self.warmup_steps = max(warmup_steps, 1)

    def lr(self, step):
        t = max(step, 1)
        scale = self.warmup_steps ** 0.5 * min(
            t ** -0.5, t * self.warmup_steps ** -1.5)
        self.current_lr = self.base_lr * scale
        return self.current_lr


class PlateauScheduler(Scheduler):
    """Reduce-on-plateau driven by the validation loss."""

    def __init__(self, base_lr, factor=0.5, patience=5, threshold=1e-4,
                 min_lr=0.0, verbose=False):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = np.inf
        self.num_bad = 0

    def on_metric(self, metric):
        if metric < self.best - self.threshold:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.min_lr,
                                      self.current_lr * self.factor)
                self.num_bad = 0


def create_scheduler(scheduler_type, base_lr, scheduler_args=None):
    """Factory by name."""
    args = dict(scheduler_args or {})
    if scheduler_type in (None, "default", "None", "Constant"):
        return ConstantScheduler(base_lr)
    if scheduler_type == "Plateau":
        return PlateauScheduler(base_lr, **args)
    if scheduler_type == "Exponential":
        return ExponentialScheduler(base_lr, **args)
    if scheduler_type == "ExtendedExponential":
        return ExtendedExponentialScheduler(base_lr, **args)
    if scheduler_type == "Noam":
        return NoamScheduler(base_lr, **args)
    raise NotImplementedError("Unknown scheduler " + str(scheduler_type))
