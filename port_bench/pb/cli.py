"""One run of one cell: parse the arguments, find the cell, run its
driver, read its metrics, judge its correctness, print the result.

  python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and window
seconds and a breakdown.  A run that finds fewer cards than its cell
asks for, or that ends with ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``idiaptts_tpu`` loaded, prints no result and exits non-zero.
"""

import argparse

from pb import spec as spec_lib
from pb import util


class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the harness's span recorder."""

    def __init__(self, torch, cell, seed, seconds, trace, start, device):
        from pb.trace import Spans
        self.torch = torch
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.start = start
        self.device = device
        self.spans = Spans()
        self.phases = []

    def phase(self, name):
        """Note the end of a set-up phase (seconds since the process
        started), printed on standard error with the result."""
        import time
        self.phases.append((name, time.time() - self.start))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(cell, record, trace):
    """{name: {value, unit}} of the metrics this run reports; a reader
    that finds nothing to read returns None and its metric is left
    out."""
    out = {}
    for m in cell.metrics(trace):
        value = spec_lib.metric_reader(m["name"], cell.bench_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(torch, cell, outcome, trace):
    """The result object without its checks."""
    from pb import trace as trace_lib
    record = dict(outcome["record"], config=cell.config,
                  traffic=cell.traffic, chips=cell.chips)
    result = {"correct": outcome["correct"],
              "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]),
              "metrics": read_metrics(cell, record, trace),
              "device": util.device_record(torch, cell.chips,
                                           outcome["memory_peak_bytes"])}
    stretch = record.get("stretch")
    if trace and stretch is not None:
        result["device"]["busy_s"] = stretch["busy_s"]
        result["device"]["window_s"] = stretch["window_s"]
        result["breakdown"] = {
            "device_ops": trace_lib.top_ops(stretch["kernel_s"]),
            "idle_gaps": stretch["idle_gaps"]}
    return result


def main(argv, start, root):
    args = parse(argv)
    power = util.PowerLimit()
    try:
        return run(args, start, root, power)
    finally:
        power.text()


def run(args, start, root, power):
    util.prepare_environment(root)
    cell = spec_lib.Cell(spec_lib.load(root), args.workload, root)
    import torch
    try:
        util.require_cards(torch, cell.chips)
    except util.NoCard as exc:
        util.log("no result: " + str(exc))
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(torch, cell, args.seed, args.seconds, args.trace, start,
                  torch.device("cuda", 0))
    ctx.phase("import and card")
    outcome = cell.driver().run(ctx)
    util.log("set-up phases (s since start): " + ", ".join(
        "{} {:.2f}".format(n, t) for n, t in ctx.phases))
    util.log("card: {} | cards {} | torch {} | cell {} seed {} {} s trace "
             "{}".format(power.text(), torch.cuda.device_count(),
                         torch.__version__, cell.name, args.seed,
                         args.seconds, args.trace))
    found = util.forbidden_loaded()
    if found:
        util.log("no result: the process holds {}".format(", ".join(found)))
        return 4
    result = result_line(torch, cell, outcome, args.trace)
    util.emit(result, outcome["checks"])
    return 0
