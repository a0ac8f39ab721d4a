"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them, or to one metric, sits in
a file of its own under ``port_bench/``:

- ``configs`` entries give their file (``configs/<config>.json``);
- ``traffic/<traffic>.json`` holds a mix's parameters and names the
  driver (``drivers/<driver>.py``) that runs it;
- ``metrics/<metric>.py`` reads one metric from a run's record;
- ``limits/<workload>.json`` holds the limits of the numbers the cell's
  correctness check compares.

So a later change adds a configuration, a mix, a metric or a cell as
new files and new entries, and edits none.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, spec, name, root, bench_dir=BENCH_DIR):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError("no workload {!r} in BENCHMARK.json (has: {})"
                           .format(name, ", ".join(sorted(entries))))
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.root = root
        self.bench_dir = bench_dir
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = read_json(os.path.join(
            bench_dir, "traffic", self.traffic_name + ".json"))
        self.limits = read_json(os.path.join(bench_dir, "limits",
                                             name + ".json"))
        self.end_to_end = applicable(spec["end_to_end"], name)
        self.per_layer = applicable(spec["per_layer"], name)
        self.run_seconds = int(spec["run_seconds"])

    def driver(self):
        """The module that runs this cell's traffic."""
        return load_module(os.path.join(
            self.bench_dir, "drivers", self.traffic["driver"] + ".py"))

    def metrics(self, trace):
        """The metric entries this run reports: the per-layer ones of a
        traced run, else the end-to-end ones."""
        return self.per_layer if trace else self.end_to_end


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load(root):
    return read_json(os.path.join(root, "BENCHMARK.json"))


def applicable(metrics, workload):
    """The metric entries without a ``workloads`` key or listing
    ``workload``."""
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def load_module(path):
    """Import a file of the benchmark by path (its name may hold dots)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    name = "port_bench_" + os.path.splitext(os.path.basename(path))[0] \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name, bench_dir=BENCH_DIR):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    return load_module(os.path.join(bench_dir, "metrics",
                                    name + ".py")).read
