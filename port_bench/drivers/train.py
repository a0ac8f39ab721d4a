"""Training: ``ModularModelHandler.process_batches`` (masked per-frame
MSE, Adam) fed as the trainer feeds it, by ``ModularTrainer._batches``
(its prefetch thread and ``collate_batch``) over an in-memory corpus,
reshuffled each epoch.

Set-up builds one handler with the benchmark's weights and drives it
through its first three steps with the window's own call and feed; those
steps are also the warm-up.  The window then trains whole steps while
its time is not up; its rate is the real (unpadded) frames of every step
over the window's wall time.  After the window the reference repeats the
first three steps on the same utterances and the numbers of
``pb.checks`` compare them.

Data parallelism (``data_parallel_ranks`` in the mix): the run starts
one process a card (``port_bench/rank.py``), each joins the NCCL group
and trains under the handler's data-parallel step, as the trainer under
torchrun does: every rank builds the same global batches and trains its
rows of each.  The ranks agree on the end of the window through a
host-side gloo group, one flag a step.  The parent gathers the ranks'
records into one result; rank 0 checks correctness.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from pb import checks, program, traffic, util
from pb import weights as weights_lib
from pb.trace import TRIES, Stretch

RANK_TIMEOUT_S = 330.0


class Corpus:
    """The dataset interface the trainer's batcher reads: samples by id."""

    def __init__(self, questions, targets):
        self.questions = questions
        self.targets = targets

    def get_id_name(self, i):
        return {"questions": self.questions[i], "target": self.targets[i],
                "_id_list": i}, None


class Feed:
    """Epochs of the trainer's batches, one after another; records each
    batch's real frames, utterance ids and the host's wait for it.  With
    ``spans``, a "loader_wait" span a pull and a "step" span from one
    pull to the next, with the step's padded length and ``step_info``."""

    def __init__(self, dataset, count, batch_size, seed, spans=None):
        self.dataset = dataset
        self.ids = list(range(count))
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.gen = None
        self.pulled = []
        self.on_pull = None
        self.spans = spans
        self.step_info = {}
        self._handed = None

    def _next(self):
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
                           T=self.pulled[-1]["T"], **self.step_info)
        if self.on_pull is not None:
            self.on_pull(len(self.pulled))
        t0 = time.perf_counter()
        batch = self._next()
        wait = time.perf_counter() - t0
        self._handed = time.time_ns()
        if self.spans is not None:
            self.spans.add("loader_wait", start_ns, self._handed)
        lengths = batch["_lengths"]["questions"]
        self.pulled.append({"wait_s": wait, "frames": int(sum(lengths)),
                            "B": len(lengths),
                            "T": int(batch["questions"].shape[1]),
                            "ids": list(batch["_id_list"])})
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


def _named(handler):
    return {k.split("wrapped.", 1)[-1]: p
            for k, p in handler.model.named_parameters()}


def checked_steps(handler, feed, steps=3):
    """The first ``steps`` steps through the window's call and feed;
    returns (losses, first gradients from Adam's first moment, the
    parameters after the steps)."""
    params = _named(handler)
    b1 = handler.optimiser.param_groups[0]["betas"][0]
    losses, first = [], None
    for s in range(steps):
        loss, _ = handler.process_batches(feed.take(1))
        losses.append(float(loss))
        if s == 0:
            state = handler.optimiser.state
            first = {k: state[p]["exp_avg"].detach().clone() / (1.0 - b1)
                     for k, p in params.items()}
    after = {k: p.detach().clone() for k, p in params.items()}
    return losses, first, after


def reference_steps(torch, config, weights, lr, qs, ts, steps, device,
                    precision="float32", part=None):
    """The reference's steps on the given utterance ids: (losses, first
    gradients, parameters after)."""
    from reference.train import Trainer
    ref = Trainer(config, weights, lr, device, precision)
    losses, first = [], None
    for s, ids in enumerate(steps):
        loss, grads = ref.step([qs[i] for i in ids], [ts[i] for i in ids],
                               part)
        losses.append(loss)
        if s == 0:
            first = {k: g.detach() for k, g in grads.items()}
    return losses, first, {k: v.detach() for k, v in ref.params.items()}


def training_gaps(run, ref, weights):
    """``pb.checks``'s training numbers of one run's (losses, first
    gradients, parameters after) against the reference's."""
    losses, first, after = run
    ref_losses, ref_first, ref_after = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    loss1_gap = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    grad_gap, grad_leaf, _ = checks.leaf_gaps(first, ref_first, ref_first)
    update_gap, update_leaf, left_out = checks.leaf_gaps(
        {k: after[k] - weights[k] for k in ref_after},
        {k: ref_after[k] - weights[k] for k in ref_after}, ref_first)
    util.log("losses {} against the reference's {} | worst gradient leaf "
             "{} | worst update leaf {} | leaves left out {}".format(
                 losses, ref_losses, grad_leaf, update_leaf, left_out))
    return {"loss_gap": loss_gap, "loss1_gap": loss1_gap,
            "grad_gap": grad_gap, "update_gap": update_gap,
            "grad_diff": checks.leaf_difference(first, ref_first)}


def train_rank(ctx, rank=0, world=1, url=None):
    """One rank's run (the whole run when ``world`` is 1); a JSON-able
    outcome."""
    torch, cfg, mix = ctx.torch, ctx.cell.config, ctx.cell.traffic
    device = ctx.device
    flags = None
    if world > 1:
        import torch.distributed as dist
        if device.type == "cuda":
            torch.cuda.set_device(device)
        program.join_group(torch, url, world, rank, device)
        flags = dist.new_group(backend="gloo")
    if device.type == "cuda":
        program.kernel_library()
    ctx.phase("group and library")
    weights = weights_lib.seeded(torch, cfg, ctx.seed, device)
    ctx.phase("weights")
    lr = float(mix["learning_rate"])
    handler = program.build_handler(torch, cfg, weights, device, lr,
                                    ctx.phase)
    if world > 1:
        handler.setup_mesh(world)
    # The targets' voicing column: cmp order, 3 x D mcep, 3 lf0, vuv.
    qs, ts = traffic.corpus(mix, ctx.seed, cfg["d_in"], cfg["d_out"],
                            int(cfg["num_coded_sps"]) * 3 + 3)
    ctx.phase("corpus")
    batch = int(mix["batch_per_rank"]) * world
    feed = Feed(Corpus(qs, ts), len(qs), batch,
                util.sub_seed(ctx.seed, "shuffle") % (1 << 31),
                ctx.spans if ctx.trace else None)
    losses, first, after = checked_steps(handler, feed)
    checked = [p["ids"] for p in feed.pulled]
    ctx.phase("checked steps")
    rows = batch // world
    feed.step_info = {"rows": rows, "residual_bytes":
                      2 if handler.residuals_bf16_for(rows) else 4}

    stretch = Stretch(torch) if ctx.trace and device.type == "cuda" \
        else None
    if stretch is not None:
        stretch.prime()
    profile_steps = int(mix["profile_steps"])
    started = []

    def on_pull(index):
        # Between steps: the previous one has finished on the device.
        if stretch is None or stretch.complete:
            return
        if stretch.running:
            if index - started[-1] >= profile_steps:
                stretch.stop(ctx.spans, unit="step")
                if not stretch.complete:
                    util.log("the stretch held no kernel record")
        elif len(started) < TRIES and time.perf_counter() - t0 >= \
                (0.3 + 0.2 * len(started)) * ctx.seconds:
            started.append(index)
            stretch.start()

    def stop():
        local = time.perf_counter() - t0 >= ctx.seconds
        if flags is None:
            return local
        flag = torch.tensor([int(local)])
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MAX,
                                     group=flags)
        return bool(flag.item())

    if flags is not None:
        torch.distributed.barrier(group=flags)
    window_first = len(feed.pulled)
    feed.on_pull = on_pull
    t0 = time.perf_counter()
    t0_epoch = time.time()
    handler.process_batches(feed.until(stop))
    window_s = time.perf_counter() - t0
    if stretch is not None and stretch.running:
        stretch.stop(ctx.spans, unit="step")
    feed.on_pull = None
    feed.close()
    steps = feed.pulled[window_first:]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    outcome = {
        "t0_epoch": t0_epoch, "window_s": window_s, "steps": len(steps),
        "frames": sum(s["frames"] for s in steps),
        "wait_s": [s["wait_s"] for s in steps], "peak": peak,
        "stretch": stretch.summary if stretch is not None else None}
    util.log("rank {}: {} steps in {:.3f} s, {} real frames".format(
        rank, len(steps), window_s, outcome["frames"]))
    del handler
    if world > 1:
        torch.distributed.destroy_process_group()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        ref = reference_steps(torch, cfg, weights, lr, qs, ts, checked,
                              device)
        outcome["numbers"] = training_gaps((losses, first, after), ref,
                                           weights)
        util.log("numbers: " + json.dumps(outcome["numbers"]))
    return outcome


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(ctx, world):
    """Run ``world`` ranks of this cell, one card a rank; their
    outcomes in rank order.  Every process is waited for, or killed at
    the time limit."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    url = "tcp://localhost:{}".format(_free_port())
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, "rank{}.json".format(r))
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "rank.py"), json.dumps({
                "workload": ctx.cell.name, "seed": ctx.seed,
                "seconds": ctx.seconds, "trace": int(ctx.trace),
                "start": ctx.start, "rank": r, "world": world, "url": url,
                "device": ctx.device.type, "out": outs[r]})])
            for r in range(world)]
        deadline = time.perf_counter() + RANK_TIMEOUT_S
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("rank(s) {} exited {}".format(
                failed, [procs[r].returncode for r in failed]))
        outcomes = []
        for path in outs:
            with open(path) as f:
                outcomes.append(json.load(f))
    return outcomes


def run(ctx):
    from pb.trace import merge
    world = int(ctx.cell.traffic.get("data_parallel_ranks", 1))
    if world == 1:
        ranks = [train_rank(ctx)]
    else:
        if ctx.device.type == "cuda":
            # One build (the first run in a checkout) before the ranks
            # load it; loading the library starts no CUDA context.
            program.kernel_library()
        ranks = spawn_ranks(ctx, world)
    lead = ranks[0]
    summaries = [r["stretch"] for r in ranks if r["stretch"] is not None]
    record = {
        "setup_s": max(r["t0_epoch"] for r in ranks) - ctx.start,
        "window_s": lead["window_s"], "frames": lead["frames"],
        "steps": lead["steps"], "wait_s": lead["wait_s"],
        "stretch": (summaries[0] if len(summaries) == 1 else
                    merge(summaries) if summaries else None),
        "rank_stretches": summaries}
    correct, judged = checks.judge(lead["numbers"], ctx.cell.limits)
    return {"correct": correct, "attempted": lead["steps"], "failed": 0,
            "memory_peak_bytes": max(r["peak"] for r in ranks),
            "record": record, "checks": judged, "numbers": lead["numbers"]}
