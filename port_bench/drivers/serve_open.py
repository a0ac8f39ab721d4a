"""Open-loop serving: one sentence a request, submitted to
``SynthesisServer`` (class defaults) over ``FusedAcousticPipeline`` on
a fixed Poisson schedule.

Set-up makes the weights and the pool of question matrices from the
seed and warms every shape the window can send the pipeline: each
length bucket of the pool at each power-of-two group size up to the
server's ``max_batch``.  The window submits every request due in it at
its time, whatever the server is doing; a request's latency runs from
when it was due to when its waveform was handed back.  The requests to
check, the longest among them, are drawn from the seed before the
window; every other waveform is let go as soon as it is served, as a
service hands it to its caller, so that the process does not grow by
the window's audio.  After the window closes the harness waits (at
most a minute) for every request, then compares the sample with the
reference.

A traced run wraps the pipeline the server calls (a host span a call
and a stage, CUDA events around the model stage) and profiles the device
over a stretch of the window from the main thread.
"""

import threading
import time

import numpy as np

from pb import checks, program, trace, traffic, util, waves
from pb.instrument import StageTimer
from pb import weights as weights_lib

WAIT_AFTER_S = 60.0


class TracedPipeline:
    """The pipeline as the server sees it, each call a host span with its
    padded batch and length and its real frames."""

    def __init__(self, pipeline, spans):
        self._pipeline = pipeline
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._pipeline, name)

    def __call__(self, params, questions):
        t0 = time.time_ns()
        out = self._pipeline(params, questions)
        t1 = time.time_ns()
        T = traffic.bucket_of(max(len(q) for q in questions),
                              self._pipeline.bucket)
        self._spans.add("pipeline_call", t0, t1, rows=len(questions), T=T,
                        frames=int(sum(len(q) for q in questions
                                       if np.any(q))))
        return out


def open_loop(server, requests, due, close, keep, profile=None):
    """Submit ``requests[i]`` at perf-counter time ``due[i]`` whatever the
    server is doing, then wait (at most ``WAIT_AFTER_S`` past ``close``)
    for each; shuts the server down.  The future of a request not in
    ``keep`` is let go once it is served.  ``profile`` (start times,
    seconds, stretch, spans) profiles the device from this thread
    meanwhile, from each start time in turn until a stretch is
    complete.  Returns (futures, ``None`` where let go; whether each
    request was served; latency seconds from due to done, or to the end
    of the wait for a request that failed or never came; generator
    lateness seconds)."""
    submitted = np.full(len(due), np.nan)
    done = np.full(len(due), np.nan)
    served = np.zeros(len(due), bool)
    futures = [None] * len(due)

    def finish(i):
        def callback(future):
            done[i] = time.perf_counter()
            served[i] = future.exception() is None
            if i not in keep:
                futures[i] = None
        return callback

    def client():
        for i, when in enumerate(due):
            delay = when - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            submitted[i] = time.perf_counter()
            future = server.submit(requests[i])
            futures[i] = future
            future.add_done_callback(finish(i))

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    if profile is not None:
        starts, seconds, stretch, spans = profile
        for start in starts:
            time.sleep(max(0.0, start - time.perf_counter()))
            stretch.start()
            time.sleep(seconds)
            stretch.stop(spans, unit="pipeline_call")
            if stretch.complete:
                break
            util.log("the stretch held no kernel record; profiling again")
    thread.join()
    deadline = close + WAIT_AFTER_S
    for f in list(futures):
        if f is None:
            continue
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 - a failed request counts missing
            pass
    waited = time.perf_counter()
    # The dispatcher runs each callback before it ends, so once it has
    # been joined ``served`` and ``done`` hold every request it answered.
    server.shutdown()
    latency_s = np.where(served, done - due, waited - due)
    lateness = submitted - due
    util.log("window: {} requests, {} failed or unfinished; generator "
             "lateness median {:.3f} ms, max {:.3f} ms; latency median "
             "{:.1f} ms, p95 {:.1f} ms".format(
                 len(due), int(np.sum(~served)),
                 float(np.median(lateness)) * 1e3,
                 float(np.max(lateness)) * 1e3,
                 float(np.median(latency_s)) * 1e3,
                 float(np.quantile(latency_s, 0.95)) * 1e3))
    return futures, served, latency_s, lateness


def warm(pipeline, model, pool, max_batch):
    """Every (bucket, power-of-two batch) shape the window can send."""
    by_bucket = {}
    for q in pool:
        by_bucket.setdefault(traffic.bucket_of(len(q), pipeline.bucket),
                             q)
    sizes = [1]
    while sizes[-1] < max_batch:
        sizes.append(sizes[-1] * 2)
    for T in sorted(by_bucket, reverse=True):
        for B in reversed(sizes):
            pipeline(model, [by_bucket[T]] * B)
    return len(by_bucket) * len(sizes)


def checked(pool_index, pool, mix, seed):
    """Indices of the requests to compare: the first request of each of
    the longest utterances sent, then others drawn from the seed."""
    spec = mix["check"]
    first = {}
    for i, k in enumerate(pool_index):
        first.setdefault(k, i)
    ids = sorted(first, key=lambda k: (-len(pool[k]), k))
    chosen = [first[k] for k in ids[:int(spec["longest"])]]
    taken = set(chosen)
    rest = [i for i in range(len(pool_index)) if i not in taken]
    extra = min(int(spec["sample"]) - len(chosen), len(rest))
    if extra > 0:
        rng = np.random.default_rng(util.sub_seed(seed, "check"))
        chosen += [rest[k] for k in rng.choice(len(rest), extra,
                                               replace=False)]
    return chosen


def run(ctx):
    torch, cfg, mix = ctx.torch, ctx.cell.config, ctx.cell.traffic
    device = ctx.device
    if device.type == "cuda":
        program.kernel_library()
    ctx.phase("library")
    weights = weights_lib.seeded(torch, cfg, ctx.seed, device)
    model = program.build_model(torch, cfg, weights, device)
    ctx.phase("model")
    pipeline = program.build_pipeline(cfg, device)
    pool = traffic.corpus(mix, ctx.seed, cfg["d_in"])
    offsets = traffic.arrivals(mix, ctx.seed, ctx.seconds)
    pool_index = [k % len(pool) for k in range(len(offsets))]
    chosen = checked(pool_index, pool, mix, ctx.seed)
    ctx.phase("pool")
    server = program.build_server(pipeline, model)
    shapes = warm(pipeline, model, pool, server.max_batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ctx.phase("warm-up")
    util.log("set-up: {} requests due in {} s ({} req/s), {} warm-up "
             "shapes".format(len(offsets), ctx.seconds,
                             mix["arrivals"]["rate_per_s"], shapes))

    stretch = timer = None
    if ctx.trace:
        timer = StageTimer(torch, pipeline, ctx.spans, device)
        server.pipeline = TracedPipeline(pipeline, ctx.spans)
        if device.type == "cuda":
            stretch = trace.Stretch(torch)
            stretch.prime()
    lead = 0.05
    t0 = time.perf_counter() + lead
    setup_s = time.time() + lead - ctx.start
    window_ns = (time.time_ns() + int(lead * 1e9),
                 time.time_ns() + int((lead + ctx.seconds) * 1e9))
    due = t0 + offsets
    profile = None
    if stretch is not None:
        starts = [t0 + (0.3 + 0.2 * k) * ctx.seconds
                  for k in range(trace.TRIES)]
        profile = (starts, float(mix["profile_s"]), stretch, ctx.spans)
    futures, served, latency_s, _ = open_loop(
        server, [pool[i] for i in pool_index], due, t0 + ctx.seconds,
        set(chosen), profile)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    record = {"setup_s": setup_s, "latency_s": latency_s.tolist(),
              "window_s": ctx.seconds, "window_ns": window_ns}
    if timer is not None:
        record["calls"] = [dict(info, start_ns=a, end_ns=b)
                           for _, a, b, info in
                           ctx.spans.named("pipeline_call")]
        record["model_ms"] = timer.model_ms()
        record["stretch"] = stretch.summary if stretch is not None else None

    completed = int(np.sum(served))
    bucket = pipeline.bucket
    triples = [(pool[pool_index[i]], futures[i].result(),
                traffic.bucket_of(len(pool[pool_index[i]]), bucket))
               for i in chosen if served[i]]
    futures = None
    del model, pipeline, server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = waves.compare(torch, cfg, weights, triples, device)
    util.log("compared {} requests: {}".format(len(triples), numbers))
    correct, judged = checks.judge(numbers, ctx.cell.limits)
    return {"correct": correct and completed == len(due),
            "attempted": len(due), "failed": len(due) - completed,
            "memory_peak_bytes": peak, "record": record, "checks": judged,
            "numbers": numbers}
