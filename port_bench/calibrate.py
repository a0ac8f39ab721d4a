#!/usr/bin/env python3
"""The readings the correctness limits are set from, in one process.

  python3 port_bench/calibrate.py --workload <cell> --seconds <s>
      [--program-seeds a,b,...] [--control-seeds c,d,...]

For each program seed: one run of the cell's driver (short window, the
cell's own sizes and load) and the numbers its check compares.  For each
control seed: the same numbers with the reference in the program's
place, computed with its matrix products in float8 (the control), and,
for a training cell, with the faults planted in the reference (half of
each batch left out with the mean over the rest; under data parallelism,
a rank's gradient without the exchange).  One JSON line a reading.
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_waves(torch, cell, seed, device):
    """Waveform gaps of the float8 reference against the float32 one on
    the cell's own sample: the pool's longest utterances and others from
    the seed, each padded to its own bucket as the server pads it."""
    import numpy as np
    from pb import traffic, util, waves
    from pb import weights as weights_lib
    cfg, mix = cell.config, cell.traffic
    weights = weights_lib.seeded(torch, cfg, seed, device)
    pool = traffic.corpus(mix, seed, cfg["d_in"])
    bucket = int(cfg["bucket"])
    padded = {i: traffic.bucket_of(len(q), bucket)
              for i, q in enumerate(pool)}
    ids = sorted(padded, key=lambda i: -len(pool[i]))
    spec = mix["check"]
    rng = np.random.default_rng(util.sub_seed(seed, "check"))
    rest = ids[int(spec["longest"]):]
    chosen = ids[:int(spec["longest"])] + [
        rest[k] for k in rng.choice(len(rest), int(spec["sample"])
                                    - int(spec["longest"]), replace=False)]
    triples = []
    for T in sorted({padded[i] for i in chosen}):
        group = [i for i in chosen if padded[i] == T]
        wavs = waves.reference_waveforms(torch, cfg, weights,
                                         [pool[i] for i in group], T,
                                         device, "fp8")
        triples += [(pool[i], w, T) for i, w in zip(group, wavs)]
    return {"control": waves.compare(torch, cfg, weights, triples, device)}


def control_training(torch, cell, seed, device, driver):
    """Training numbers of the float8 reference and of the planted
    faults against the float32 reference, on the cell's own batches."""
    from pb import traffic, util
    from pb import weights as weights_lib
    cfg, mix = cell.config, cell.traffic
    world = int(mix.get("data_parallel_ranks", 1))
    weights = weights_lib.seeded(torch, cfg, seed, device)
    qs, ts = traffic.corpus(mix, seed, cfg["d_in"], cfg["d_out"],
                            int(cfg["num_coded_sps"]) * 3 + 3)
    batch = int(mix["batch_per_rank"]) * world
    feed = driver.Feed(driver.Corpus(qs, ts), len(qs), batch,
                       util.sub_seed(seed, "shuffle") % (1 << 31))
    steps = [next(feed.take(1))["_id_list"] for _ in range(3)]
    feed.close()
    lr = float(mix["learning_rate"])
    ref = driver.reference_steps(torch, cfg, weights, lr, qs, ts, steps,
                                 device)
    out = {}
    variants = {"control": ("fp8", None),
                "fault_half_batch": ("float32", ("half", batch // 2))}
    if world > 1:
        variants["fault_no_exchange"] = ("float32",
                                         ("rows", batch // world))
    for name, (precision, part) in variants.items():
        run = driver.reference_steps(torch, cfg, weights, lr, qs, ts, steps,
                                     device, precision, part)
        out[name] = driver.training_gaps(run, ref, weights)
        del run
        torch.cuda.empty_cache()
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    from pb import spec as spec_lib
    from pb import util
    util.prepare_environment(ROOT)
    import torch
    from pb.cli import Context
    util.require_cards(torch, 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec_lib.Cell(spec_lib.load(ROOT), args.workload, ROOT)
    util.log("card: " + util.PowerLimit().text())
    driver = cell.driver()
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.program_seeds.split(",") if s]:
        ctx = Context(torch, cell, seed, args.seconds, 0, time.time(),
                      device)
        outcome = driver.run(ctx)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": outcome["numbers"],
                          "correct": outcome["correct"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        if cell.traffic["driver"] == "train":
            readings = control_training(torch, cell, seed, device, driver)
        else:
            readings = control_waves(torch, cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(sys.argv[1:]))
