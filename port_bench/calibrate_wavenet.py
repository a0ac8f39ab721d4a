#!/usr/bin/env python3
"""The readings the WaveNet training cell's limits are set from, in one
process (``calibrate.py`` does the same for the acoustic models' cells).

  python3 port_bench/calibrate_wavenet.py --workload wavenet.train
      --seconds <s> [--program-seeds a,b,...] [--control-seeds c,d,...]

For each program seed: one run of the cell's driver (short window, the
cell's own sizes) and the numbers its check compares.  For each control
seed, on the cell's own first three batches: the reference with its
matrix products in float8 (the control) against the float32 reference,
its first step's logits included, and the fault planted in the
reference, half of each batch left out with the mean over the rest.
One JSON line a reading.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_logits(torch, cfg, weights, corpus, crops, device, rows):
    """The float8 reference's logits of a batch, in blocks of rows."""
    from pb import wavenet_model
    from reference.wavenet import WaveNet
    L, stacks, _, _, _, _, _, Q = wavenet_model.widths(cfg)
    driver = load_driver()
    targets, cond, _ = driver.reference_batch(torch, corpus, crops)
    params = {k: v.detach() for k, v in weights.items()}
    net = WaveNet(params, L, stacks, Q, "fp8")
    with torch.no_grad():
        return torch.cat([net(targets[r:r + rows].to(device),
                              cond[r:r + rows].to(device))
                          for r in range(0, targets.shape[0], rows)])


def load_driver():
    from pb.spec import load_module
    return load_module(os.path.join(HERE, "drivers", "wavenet_train.py"))


def control_training(torch, cell, seed, device):
    """The control's and the fault's numbers against the float32
    reference on the cell's first three batches."""
    from pb import util, wavenet_model
    driver = load_driver()
    cfg, mix = cell.config, cell.traffic
    weights = wavenet_model.seeded(torch, cfg, seed, device)
    corpus = driver.Corpus(cfg, mix, seed)
    batch = int(mix["batch_per_rank"])
    feed = driver.Feed(corpus, batch,
                       util.sub_seed(seed, "shuffle") % (1 << 31))
    steps = [next(feed.take(1))["_id_list"] for _ in range(3)]
    feed.close()
    lr = float(mix["learning_rate"])
    rows = int(mix["check_rows_per_block"])
    fp8 = control_logits(torch, cfg, weights, corpus, steps[0], device,
                         rows)
    ref, gaps = driver.reference_steps(torch, cfg, weights, lr, corpus,
                                       steps, device, logits=fp8,
                                       rows_per_block=rows)
    del fp8
    gap_of = driver.train_driver().training_gaps
    out = {}
    for name, precision, keep in (("control", "fp8", None),
                                  ("fault_half_batch", "float32",
                                   batch // 2)):
        run, _ = driver.reference_steps(torch, cfg, weights, lr, corpus,
                                        steps, device, precision, keep,
                                        rows_per_block=rows)
        out[name] = gap_of(run, ref, weights)
        del run
        torch.cuda.empty_cache()
    out["control"]["logits_gap"] = max(gaps)
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
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.program_seeds.split(",") if s]:
        ctx = Context(torch, cell, seed, args.seconds, 0, time.time(),
                      device)
        outcome = cell.driver().run(ctx)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": outcome["numbers"],
                          "correct": outcome["correct"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        readings = control_training(torch, cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(sys.argv[1:]))
