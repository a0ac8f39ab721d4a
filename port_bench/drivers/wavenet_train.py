"""Training the WaveNet vocoder: ``ModularModelHandler.process_batches``
(the masked cross-entropy of the teacher-forced logits, Adam) fed as the
trainer feeds it, by ``ModularTrainer._batches`` (its prefetch thread and
``collate_batch``) over an in-memory corpus, reshuffled each epoch.

The corpus is a pool of LJSpeech-length utterances, each with its
normalised WORLD conditioning at the frame rate and its µ-law waveform.
A fetch (``Corpus.get_id_name``, on the loader's thread) crops the
mix's ``crop_frames`` at an offset drawn from the seed, the utterance
and how often it was fetched before, upsamples the conditioning to the
sample rate with the port's ``sample_linearly`` and returns the crop's
µ-law targets, as ``WaveNetVocoderTrainer``'s readers give them.

Set-up builds the model through ``WaveNetWrapper.Config`` and the
handler's front doors with the benchmark's weights, and drives it
through its first three steps with the window's own call and feed; those
steps are also the warm-up.  The window then trains whole steps while
its time is not up; its rate is the real samples of every step over the
window's wall time (``frames``: 16 kHz samples here).  After the window
the reference (``reference/wavenet.py``) repeats the first three steps
on the same crops, upsampled by its own interpolation, in blocks of
rows, and ``pb.checks``' numbers compare them, with ``logits_gap``: the
worst row's ||logits - ref|| / ||ref|| over its real samples, of the
first step's logits before any update.

With ``--trace 1`` the program's own spans are recorded from the end of
set-up (``program_spans``, ``program_window_ns``) and a profiled stretch
counts the gate kernel's launches.

A program without the card's bf16 WaveNet path (no
``idiaptts_torch.ops.wavenet_gate``) cannot hold the cell's batch on one
card: the run stops at once with a non-zero exit.
"""

import json
import os
import time

import numpy as np

from pb import checks, program_spans, roofline, traffic, util
from pb import spec as spec_lib
from pb import trace
from pb import wavenet_model as model_lib
from pb.trace import TRIES, Stretch

# The gate kernel's launches as the profiler names them.
GATE_KERNELS = {"fwd": "wavenet_gate_fwd_kernel",
                "bwd": "wavenet_gate_bwd_kernel"}


def require_program():
    """Stop at once unless the program has the bf16 path's gate."""
    try:
        from idiaptts_torch.ops import wavenet_gate  # noqa: F401
    except ImportError as exc:
        raise SystemExit("no result: the program has no bf16 WaveNet path "
                         "({}); it cannot train this cell's batch on one "
                         "card".format(exc))


def mulaw_classes(x, mu):
    """µ-law classes 0..mu of a waveform in [-1, 1]."""
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.floor((y + 1.0) / 2.0 * mu + 0.5).astype(np.uint8)


class Corpus:
    """The dataset interface the trainer's batcher reads: crops by id."""

    def __init__(self, config, mix, seed):
        self.seed = int(seed)
        self.up = int(config["upsample"])
        self.crop = int(mix["crop_frames"])
        C = int(config["cond_channels"])
        mu = int(config["mu"])
        vuv = int(config["num_coded_sps"]) + 1
        rng = np.random.default_rng(util.sub_seed(seed, "features"))
        self.feats, self.audio = [], []
        for frames in traffic.seeded_lengths(mix, seed):
            durs = traffic._phones(rng, int(frames))
            self.feats.append(traffic.targets(rng, durs, C, vuv))
            wav = np.clip(rng.laplace(0.0, 0.05, int(frames) * self.up),
                          -1.0, 1.0)
            self.audio.append(mulaw_classes(wav, mu))
        self.fetched = {}

    def offset(self, i, n):
        """The frame offset of utterance ``i``'s crop at its ``n``-th
        fetch."""
        rng = np.random.default_rng(util.sub_seed(
            self.seed, "crop:{}:{}".format(i, n)))
        return int(rng.integers(0, len(self.feats[i]) - self.crop + 1))

    def crop_of(self, i, n):
        """(frames (crop, C), targets (crop x up,)) of a fetch."""
        o = self.offset(i, n)
        return (self.feats[i][o:o + self.crop],
                self.audio[i][o * self.up:(o + self.crop) * self.up])

    def get_id_name(self, i):
        from idiaptts_torch.ops.interpolation import sample_linearly
        n = self.fetched.get(i, 0)
        self.fetched[i] = n + 1
        frames, target = self.crop_of(i, n)
        return {"cond_features": sample_linearly(frames, self.up),
                "target_quantised": target.astype(np.float32)[:, None],
                "_id_list": (i, n)}, None


class Feed:
    """Epochs of the trainer's batches, one after another; records each
    batch's real samples, crops and the host's wait for it."""

    def __init__(self, dataset, batch_size, seed, spans=None):
        self.dataset = dataset
        self.ids = list(range(len(dataset.feats)))
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.gen = None
        self.pulled = []
        self.on_pull = None
        self.spans = spans
        self._handed = None

    def _next(self):
        from pb import program
        while True:
            if self.gen is None:
                self.gen = program.trainer_batches(
                    self.dataset, self.ids, self.batch_size,
                    self.seed + self.epoch)
            try:
                return next(self.gen)
            except StopIteration:
                self.gen = None
                self.epoch += 1

    def pull(self):
        start_ns = time.time_ns()
        if self.spans is not None and self._handed is not None:
            self.spans.add("step", self._handed, start_ns,
                           T=self.pulled[-1]["T"])
        if self.on_pull is not None:
            self.on_pull(len(self.pulled))
        t0 = time.perf_counter()
        batch = self._next()
        wait = time.perf_counter() - t0
        self._handed = time.time_ns()
        if self.spans is not None:
            self.spans.add("loader_wait", start_ns, self._handed)
        lengths = batch["_lengths"]["target_quantised"]
        self.pulled.append({"wait_s": wait, "frames": int(sum(lengths)),
                            "B": len(lengths),
                            "T": int(batch["target_quantised"].shape[1]),
                            "crops": list(batch["_id_list"])})
        return batch

    def take(self, n):
        for _ in range(n):
            yield self.pull()

    def until(self, stop):
        while not stop():
            yield self.pull()
        self._handed = None

    def close(self):
        if self.gen is not None:
            self.gen.close()
            self.gen = None


def gate_records(events, least_s):
    """({kind: gate launches}, untimed) of a stretch's profiler events:
    ``untimed`` counts the gate records shorter than ``least_s[kind]``,
    the least time of their bytes, which no launch can beat: a record
    whose time was lost.  CUPTI has handed over such a stretch on the
    card, a block of every kernel's records with their time gone (192
    gate launches of each kind in 29% of their device time, one idle gap
    of 1.03 s inside the steps)."""
    launches = {kind: 0 for kind in GATE_KERNELS}
    untimed = 0
    for e in events:
        if not str(e.device_type()).endswith("CUDA"):
            continue
        for kind, pattern in GATE_KERNELS.items():
            if pattern in e.name():
                launches[kind] += 1
                untimed += e.duration_ns() < least_s[kind] * 1e9
    return launches, untimed


class GateStretch(Stretch):
    """A profiled stretch whose summary also counts the gate kernel's
    launches (``gate_launches``) and its records whose time was lost
    (``untimed_gate_records``, :func:`gate_records`).  A stretch with
    such records is not complete, so the window takes another."""

    def __init__(self, torch, rows, G):
        super().__init__(torch)
        self.least_s = {kind: roofline.bound_s(0.0, model_lib.gate_bytes(
            rows, G, kind == "bwd"))[0] for kind in GATE_KERNELS}

    @property
    def complete(self):
        return super().complete and \
            self.summary["untimed_gate_records"] == 0

    def stop(self, spans=None, unit=None):
        self.torch.cuda.synchronize()
        t1 = time.time_ns()
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.summary = trace.summarise(events, self.t0, t1, spans, unit)
        launches, untimed = gate_records(events, self.least_s)
        self.summary["gate_launches"] = launches
        self.summary["untimed_gate_records"] = untimed
        if untimed:
            util.log("the stretch lost the time of {} gate records".format(
                untimed))
        return self.summary


def model_config(config):
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    L, stacks, R, G, S, k, C, Q = model_lib.widths(config)
    return WaveNetWrapper.Config(
        input_names=("cond_features",), output_names=("pred_logits",),
        target_name="target_quantised", out_channels=Q,
        residual_channels=R, gate_channels=G, skip_channels=S,
        num_layers=L, num_stacks=stacks, kernel_size=k, cond_channels=C)


def build_handler(torch, config, weights, device, learning_rate, phase):
    """A ``ModularModelHandler`` with the configuration's WaveNet, the
    benchmark's weights, Adam and the masked cross-entropy, as
    ``WaveNetVocoderTrainer.init`` sets them."""
    from idiaptts_torch.hparams import ExtendedHParams
    from idiaptts_torch.models.losses import NamedLoss
    from idiaptts_torch.train.handler import ModularModelHandler
    from pb import program
    handler = ModularModelHandler(device=device)
    handler.create_model(model_config(config))
    program.load_weights(torch, handler.model, weights)
    phase("model")
    hp = ExtendedHParams.create_hparams()
    hp.learning_rate = float(learning_rate)
    handler.set_optimiser(hp)
    phase("optimiser")
    handler.set_losses([NamedLoss.Config(
        "ce", "CrossEntropyLoss", ("pred_logits", "target_quantised"),
        seq_mask="_seq_mask", reduction="mean")])
    return handler


def _named(handler):
    return {k.split("wrapped.", 1)[-1]: p
            for k, p in handler.model.named_parameters()}


def checked_steps(handler, feed, steps=3):
    """The first ``steps`` steps through the window's call and feed;
    returns (losses, first gradients from Adam's first moment, the
    parameters after the steps, the first step's logits)."""
    params = _named(handler)
    b1 = handler.optimiser.param_groups[0]["betas"][0]
    logits = []

    def keep(module, args, out):
        if not logits:
            logits.append(out["pred_logits"].detach().clone())

    hook = handler.model.register_forward_hook(keep)
    losses, first = [], None
    try:
        for s in range(steps):
            loss, _ = handler.process_batches(feed.take(1))
            losses.append(float(loss))
            if s == 0:
                hook.remove()
                state = handler.optimiser.state
                first = {k: state[p]["exp_avg"].detach().clone() / (1.0 - b1)
                         for k, p in params.items()}
    finally:
        hook.remove()
    after = {k: p.detach().clone() for k, p in params.items()}
    return losses, first, after, logits[0]


def reference_batch(torch, corpus, crops):
    """(targets (B, T) long, cond (B, T, C), lengths (B,)) of a batch's
    crops, upsampled by the reference's own interpolation."""
    from reference.wavenet import upsample
    pairs = [corpus.crop_of(i, n) for i, n in crops]
    T = max(len(t) for _, t in pairs)
    C = pairs[0][0].shape[1]
    targets = np.zeros((len(pairs), T), np.int64)
    cond = np.zeros((len(pairs), T, C), np.float32)
    for r, (frames, target) in enumerate(pairs):
        targets[r, :len(target)] = target
        cond[r, :len(target)] = upsample(frames, corpus.up)
    lengths = torch.tensor([len(t) for _, t in pairs])
    return torch.from_numpy(targets), torch.from_numpy(cond), lengths


def reference_steps(torch, config, weights, lr, corpus, steps, device,
                    precision="float32", keep=None, logits=None,
                    rows_per_block=4):
    """The reference's steps on the given crops: ((losses, first
    gradients, parameters after), the first step's row gaps against
    ``logits``)."""
    from reference.wavenet import Trainer
    L, stacks, _, _, _, _, _, Q = model_lib.widths(config)
    ref = Trainer(weights, L, stacks, Q, lr, device, precision,
                  rows_per_block)
    losses, first, gaps = [], None, []
    for s, crops in enumerate(steps):
        targets, cond, lengths = reference_batch(torch, corpus, crops)
        loss, grads, row_gaps = ref.step(
            targets, cond, lengths, keep,
            logits if s == 0 else None)
        losses.append(loss)
        if s == 0:
            first = {k: g.detach() for k, g in grads.items()}
            gaps = row_gaps
        del grads
    return (losses, first, {k: v.detach() for k, v in ref.params.items()}), \
        gaps


def train_driver():
    """``drivers/train.py`` (its ``training_gaps``)."""
    return spec_lib.load_module(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "train.py"))


def run(ctx):
    require_program()
    torch, cfg, mix = ctx.torch, ctx.cell.config, ctx.cell.traffic
    device = ctx.device
    from pb import program
    if device.type == "cuda":
        program.kernel_library()
    ctx.phase("library")
    weights = model_lib.seeded(torch, cfg, ctx.seed, device)
    ctx.phase("weights")
    lr = float(mix["learning_rate"])
    handler = build_handler(torch, cfg, weights, device, lr, ctx.phase)
    corpus = Corpus(cfg, mix, ctx.seed)
    ctx.phase("corpus")
    feed = Feed(corpus, int(mix["batch_per_rank"]),
                util.sub_seed(ctx.seed, "shuffle") % (1 << 31),
                ctx.spans if ctx.trace else None)
    losses, first, after, logits = checked_steps(handler, feed)
    checked = [p["crops"] for p in feed.pulled]
    shape = {"rows": feed.pulled[0]["B"] * feed.pulled[0]["T"],
             "G": int(cfg["gate_channels"])}
    ctx.phase("checked steps")

    from idiaptts_torch.ops import dispatch
    from idiaptts_torch.utils import tracing
    cuda = device.type == "cuda"
    stretch = GateStretch(torch, shape["rows"], shape["G"]) \
        if ctx.trace and cuda else None
    if stretch is not None:
        stretch.prime()
    if ctx.trace:
        # Program spans label the stretch's idle gaps, as
        # trace_program.py has them label them.
        tracing.enable(sink=lambda name, t0, t1, **attrs: None
                       if name in program_spans.UNLABELLED
                       else ctx.spans.add(name, t0, t1, **attrs))
    launches_before = dispatch.counts()
    profile_steps = int(mix["profile_steps"])
    started = []

    def on_pull(index):
        # Between steps: the previous one has been queued on the device.
        if stretch is None or stretch.complete:
            return
        if stretch.running:
            if index - started[-1] >= profile_steps:
                stretch.stop(ctx.spans)
                if not stretch.complete:
                    util.log("the stretch held no kernel record")
        elif len(started) < TRIES and time.perf_counter() - t0 >= \
                (0.3 + 0.2 * len(started)) * ctx.seconds:
            started.append(index)
            stretch.start()

    window_first = len(feed.pulled)
    feed.on_pull = on_pull
    t0 = time.perf_counter()
    t0_epoch = time.time()
    handler.process_batches(feed.until(
        lambda: time.perf_counter() - t0 >= ctx.seconds))
    window_s = time.perf_counter() - t0
    if stretch is not None and stretch.running:
        stretch.stop(ctx.spans)
    feed.on_pull = None
    feed.close()
    spans = None
    if ctx.trace:
        tracing.disable()
        spans = tracing.drain()
    launches = {k: v - launches_before.get(k, 0)
                for k, v in dispatch.counts().items()
                if v - launches_before.get(k, 0)}
    steps = feed.pulled[window_first:]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    record = {
        "setup_s": t0_epoch - ctx.start, "window_s": window_s,
        "steps": len(steps), "frames": sum(s["frames"] for s in steps),
        "wait_s": [s["wait_s"] for s in steps],
        "stretch": stretch.summary if stretch is not None else None,
        "gate": shape, "launches": launches}
    if spans is not None:
        w0 = int(t0_epoch * 1e9)
        record["program_window_ns"] = [w0, w0 + int(window_s * 1e9)]
        record["program_spans"] = [s for s in spans if s["t0_ns"] >= w0]
        counts = {}
        for s in record["program_spans"]:
            counts[s["name"]] = counts.get(s["name"], 0) + 1
        util.log("program spans in the window: " + json.dumps(counts))
    util.log("{} steps in {:.3f} s, {} real samples; launches {}".format(
        len(steps), window_s, record["frames"], json.dumps(launches)))
    del handler
    if cuda:
        torch.cuda.empty_cache()
    ref, gaps = reference_steps(
        torch, cfg, weights, lr, corpus, checked, device, logits=logits,
        rows_per_block=int(mix["check_rows_per_block"]))
    del logits
    numbers = train_driver().training_gaps((losses, first, after), ref,
                                           weights)
    numbers["logits_gap"] = max(gaps)
    util.log("numbers: " + json.dumps(numbers))
    correct, judged = checks.judge(numbers, ctx.cell.limits)
    return {"correct": correct, "attempted": len(steps), "failed": 0,
            "memory_peak_bytes": peak, "record": record, "checks": judged,
            "numbers": numbers}
