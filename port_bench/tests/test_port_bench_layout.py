"""What the benchmark's layout promises: a configuration, a traffic mix
and a per-layer metric added as new files and entries, with no edit to
a file that is there; nothing imports JAX or the JAX package; the
reference imports nothing of the program; the spec keeps the contract's
shape."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

import tinycell
from pb import spec as spec_lib
from pb.cli import read_metrics

BENCH = tinycell.BENCH
REPO = tinycell.REPO
JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "idiaptts_tpu"}


def imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not imported_top_levels(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "idiaptts_torch" not in imported_top_levels(path)
    assert not imported_top_levels(path) & {"pb", "drivers"}


def test_whole_names_are_compared():
    from pb.util import forbidden_loaded
    assert forbidden_loaded({"idiaptts_torch.ops": 1, "jaxtyping": 1,
                             "flaxen": 1}) == []
    assert forbidden_loaded({"jax.numpy": 1, "idiaptts_tpu": 1}) == \
        ["idiaptts_tpu", "jax"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter leaves none of the JAX
    stack in ``sys.modules``."""
    root = tinycell.build(str(tmp_path))
    code = ("import sys; sys.path[:0] = [{!r}, {!r}, {!r}]\n"
            "import tinycell\nfrom pb.util import forbidden_loaded\n"
            "tinycell.run({!r}, 't.tiny_serve', 0.5)\n"
            "print('LOADED', forbidden_loaded())\n").format(
                os.path.join(BENCH, "tests"), BENCH, REPO, root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert "LOADED []" in out


def test_discovery_of_new_files_only(tmp_path):
    root = tinycell.build(str(tmp_path))
    bench = os.path.join(root, "port_bench")
    before = {p: open(p, "rb").read() for p in sources()}
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_wide"
    cfg["layers"][0]["width"] = 24
    cfg["model"] = cfg["model"].replace("RELU_16", "RELU_24")
    with open(os.path.join(bench, "configs", "tiny_wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_train.json")) as f:
        mix = json.load(f)
    mix["batch_per_rank"] = 2
    with open(os.path.join(bench, "traffic", "tiny_train_b2.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "steps_run.train.py"),
              "w") as f:
        f.write("def read(record):\n"
                "    return record.get('steps') or None\n")
    with open(os.path.join(bench, "limits", "t.wide.json"), "w") as f:
        json.dump({"limits": tinycell.LIMITS["train"]}, f)
    spec = spec_lib.load(root)
    spec["configs"].append({"name": "tiny_wide", "source": "test",
                            "file": "port_bench/configs/tiny_wide.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "t.wide", "config": "tiny_wide",
                              "traffic": "tiny_train_b2", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_run.train", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "train_frames_per_s",
                              "workloads": ["t.wide"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    out = tinycell.run(root, "t.wide", 0.5)
    cell = spec_lib.Cell(spec_lib.load(root), "t.wide", root, bench)
    assert cell.config["layers"][0]["width"] == 24
    metrics = read_metrics(cell, dict(out["record"], config=cell.config,
                                      chips=1), trace=True)
    assert metrics["steps_run.train"]["value"] == out["record"]["steps"]
    assert tinycell.finite(out["numbers"])
    assert before == {p: open(p, "rb").read() for p in sources()}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_spec_shape():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    end = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in end
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in end
        cells = m.get("workloads", [x["name"] for x in spec["workloads"]])
        for w in cells:
            e2e = [e for e in spec["end_to_end"]
                   if w in e.get("workloads", [w])]
            assert m["moves"] in {e["name"] for e in e2e}
