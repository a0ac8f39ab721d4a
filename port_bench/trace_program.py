#!/usr/bin/env python3
"""One traced run of a cell with the program's own spans recorded.

  python3 port_bench/trace_program.py --workload <cell> --seed <n>
      --seconds <s> [--spans-out <file.json.gz>]

The run of ``run.py --trace 1``, and besides: the program's recorder
(``idiaptts_torch.utils.tracing``) is on from the end of set-up to the
end of the run, every span it records also goes to the harness's span
list (so the stretch's idle gaps are labelled by the innermost program
span over them; the loader thread's collate spans label none), and the
last line of standard output is the run's result line with one more
key, ``program``:

- ``metrics``: the per-layer numbers of ``pb/program_spans.py`` for the
  cell's kind (serving or training);
- ``idle_by_span``, ``idle_beside`` and ``clock_aligned`` of the
  stretch (``pb/program_spans.py``);
- ``labels_named``: whether each of the ten longest gaps names a
  program span;
- ``accounts``: serving, the 95th percentile of submit to the end of
  the serving batch beside the run's own p95 (due to done); training,
  the four phases' device ms a step as a share of the window's wall
  time a step;
- ``end_to_end``: the cell's end-to-end metrics read from this traced
  run's record.

``run.py --trace 1`` on the same seed is the same run with the recorder
off.  The benchmark's own runs never run this.
"""
import time

START = time.time()

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# The set-up phase each driver ends just before its window's own
# preparations (wrapping, priming the profiler) and the window.
LAST_SETUP_PHASE = {"serve_open": "warm-up", "train": "checked steps"}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans-out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from pb import cli, util
    from pb import spec as spec_lib
    util.prepare_environment(ROOT)
    power = util.PowerLimit()
    cell = spec_lib.Cell(spec_lib.load(ROOT), args.workload, ROOT)
    import torch
    util.require_cards(torch, cell.chips)
    if cell.chips != 1:
        raise SystemExit("one-card cells only: the recorder runs in this "
                         "process")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = cli.Context(torch, cell, args.seed, args.seconds, 1, START,
                      torch.device("cuda", 0))
    ctx.phase("import and card")
    outcome, program = run(ctx)
    record = outcome["record"]
    if args.spans_out:
        with gzip.open(args.spans_out, "wt") as f:
            json.dump({"window_ns": record["program_window_ns"],
                       "spans": record["program_spans"]}, f)
    util.log("set-up phases (s since start): " + ", ".join(
        "{} {:.2f}".format(n, t) for n, t in ctx.phases))
    util.log("card: {} | torch {} | cell {} seed {} {} s, program spans "
             "on".format(power.text(), torch.__version__, cell.name,
                         args.seed, args.seconds))
    result = cli.result_line(torch, cell, outcome, True)
    program["end_to_end"] = {k: v["value"] for k, v in cli.read_metrics(
        cell, dict(record, config=cell.config, traffic=cell.traffic,
                   chips=cell.chips), False).items()}
    result["program"] = program
    util.emit(result, outcome["checks"])
    return 0


def run(ctx):
    """The cell's run (``drivers/<name>.py``) with the recorder on from
    the end of set-up; (its outcome, whose record holds
    ``program_spans`` and ``program_window_ns``; the ``program`` object
    of the result)."""
    from pb import program_spans, readers, trace
    from idiaptts_torch.utils import tracing
    driver = ctx.cell.traffic["driver"]
    end_of_setup = ctx.phase

    def label(name, t0, t1, **attrs):
        if name not in program_spans.UNLABELLED:
            ctx.spans.add(name, t0, t1, **attrs)

    def phase(name):
        end_of_setup(name)
        if name == LAST_SETUP_PHASE[driver]:
            tracing.enable(sink=label)

    ctx.phase = phase
    stretches = program_spans.StretchSpans(trace.summarise)
    trace.summarise = stretches
    try:
        outcome = ctx.cell.driver().run(ctx)
    finally:
        tracing.disable()
        trace.summarise = stretches.summarise
        ctx.phase = end_of_setup
    spans = tracing.drain()
    stretches.finish(spans)

    record = outcome["record"]
    if "window_ns" in record:
        w0, w1 = record["window_ns"]
    else:
        w0 = int((ctx.start + record["setup_s"]) * 1e9)
        w1 = w0 + int(record["window_s"] * 1e9)
    record["program_window_ns"] = [w0, w1]
    record["program_spans"] = [s for s in spans if s["t0_ns"] >= w0]
    kind = "serve" if driver == "serve_open" else "train"
    stretch = record.get("stretch") or {}
    program = {
        "metrics": program_spans.read(record, kind),
        "idle_by_span": stretch.get("idle_by_span"),
        "idle_beside": stretch.get("idle_beside"),
        "clock_aligned": stretch.get("clock_aligned"),
        "labels_named": bool(stretch) and program_spans.labels_named(
            stretch),
        "spans": len(record["program_spans"])}
    if kind == "serve":
        program["accounts"] = {
            "served_p95_ms": program_spans.served_p95_ms(record),
            "p95_ms": readers.p95_ms(record["latency_s"])}
    else:
        program["accounts"] = {
            "phases_share": program_spans.step_phases_share(record),
            "step_ms": 1e3 * record["window_s"] / record["steps"]}
    return outcome, program


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
