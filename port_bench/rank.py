#!/usr/bin/env python3
"""One rank of a data-parallel cell, started by ``run.py`` (one process
a card): ``rank.py '<json>'`` with the cell, the run's arguments, the
rank, the world, the group's address and the file its outcome goes to.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(config):
    from pb import spec as spec_lib
    from pb import util
    util.prepare_environment(ROOT)
    import torch
    from pb.cli import Context
    from pb.spec import load_module
    cell = spec_lib.Cell(spec_lib.load(ROOT), config["workload"], ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu") if config.get("device") == "cpu" \
        else torch.device("cuda", config["rank"])
    ctx = Context(torch, cell, config["seed"], config["seconds"],
                  config["trace"], config["start"], device)
    driver = load_module(os.path.join(HERE, "drivers", "train.py"))
    ctx.phase("import and card")
    outcome = driver.train_rank(ctx, config["rank"], config["world"],
                                config["url"])
    util.log("rank {} set-up phases (s since the run started): {}".format(
        config["rank"], ", ".join("{} {:.2f}".format(n, t)
                                  for n, t in ctx.phases)))
    with open(config["out"], "w") as f:
        json.dump(outcome, f)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main(json.loads(sys.argv[1])))
