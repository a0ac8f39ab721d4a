#!/usr/bin/env python3
"""The serving cell's knee: one set-up, then an open-loop window at each
of a list of rates.

  python3 port_bench/sweep.py --workload is18.serve.open --seed <n>
      --seconds <s> --rates 50,100,150,...

For each rate one JSON line: requests, how many finished before the
window closed, the median and 95th percentile latency, and the
generator's lateness.  The highest rate whose requests all finish by the
window's close with a 95th percentile that does not grow with the window
is the knee; the cell's mix file holds 0.8 of it as an absolute rate.
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from pb import spec as spec_lib
    from pb import util
    util.prepare_environment(ROOT)
    import numpy as np
    import torch
    from pb import program, traffic
    from pb import weights as weights_lib
    util.require_cards(torch, 1)
    cell = spec_lib.Cell(spec_lib.load(ROOT), args.workload, ROOT)
    driver = cell.driver()
    cfg, mix = cell.config, cell.traffic
    device = torch.device("cuda", 0)
    util.log("card: " + util.PowerLimit().text())
    program.kernel_library()
    weights = weights_lib.seeded(torch, cfg, args.seed, device)
    model = program.build_model(torch, cfg, weights, device)
    pipeline = program.build_pipeline(cfg, device)
    pool = traffic.corpus(mix, args.seed, cfg["d_in"])
    server = program.build_server(pipeline, model)
    driver.warm(pipeline, model, pool, server.max_batch)
    server.shutdown()
    for rate in [float(r) for r in args.rates.split(",")]:
        offsets = traffic.arrivals({"arrivals": {"rate_per_s": rate}},
                                   args.seed, args.seconds)
        requests = [pool[k % len(pool)] for k in range(len(offsets))]
        server = program.build_server(pipeline, model)
        stats = server.stats
        t0 = time.perf_counter() + 0.05
        due = t0 + offsets
        close = t0 + args.seconds
        _, _, latency, lateness = driver.open_loop(
            server, requests, due, close, set())
        finished_by_close = float(np.mean(due + latency <= close + 1e-3))
        half = len(due) // 2
        print(json.dumps({
            "rate_per_s": rate, "requests": len(due),
            "finished_by_close": finished_by_close,
            "p50_ms": float(np.median(latency)) * 1e3,
            "p95_ms": float(np.quantile(latency, 0.95)) * 1e3,
            "p95_first_half_ms": float(np.quantile(latency[:half], 0.95))
            * 1e3,
            "p95_second_half_ms": float(np.quantile(latency[half:], 0.95))
            * 1e3,
            "lateness_max_ms": float(np.max(lateness)) * 1e3,
            "server": stats()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(sys.argv[1:]))
