"""The harness finds every cell, configuration, driver, traffic generator
and metric reader by name, and BENCHMARK.json keeps to its contract's
shape; a new cell, configuration and metric are new files only."""

import json
import os
import re
import shutil

import pytest

from benchmark import core

SPEC = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    c = core.find_cell(cell)
    assert c.config and c.workload
    core.driver(c.workload["driver"])
    core.traffic(c.workload["generator"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.metric_reader(m["name"]))
    assert set(c.workload["limits"])


def test_entries_keep_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        body = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert set(body["reduced"]) == set(c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            moved = next(x for x in SPEC["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells)


def test_configs_equal_the_shipped_yaml():
    """Each configuration file holds its YAML as shipped, but for the
    keys its ``reduced`` names."""
    yaml = pytest.importorskip("yaml")
    files = {"mnist": "mnist_config.yml",
             "camelyon_e2e": "camelyon_e2e_config.yml"}
    for c in SPEC["configs"]:
        body = core.load_json(os.path.join(core.ROOT, c["file"]))
        with open(os.path.join(core.ROOT, "config", files[c["name"]])) as f:
            shipped = yaml.safe_load(f)
        conf = body["config"]
        for k in c["reduced"]:
            assert conf.get(k) != shipped.get(k)
        assert {k: v for k, v in conf.items() if k not in c["reduced"]} \
            == {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in shipped.items() if k not in c["reduced"]}


def test_a_new_cell_config_and_metric_are_new_files(tmp_path):
    """A copy of the tree gains a configuration, a cell and a metric by
    new files and entries alone, and the harness finds all three."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(core.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads(json.dumps(SPEC))
    body = core.load_json(os.path.join(core.ROOT,
                                       "benchmark/configs/mnist.json"))
    (root / "benchmark/configs/mnist_small.json").write_text(json.dumps(
        dict(body, reduced=["N"], config=dict(body["config"], N=400))))
    spec["configs"].append({"name": "mnist_small", "source": "x",
                            "file": "benchmark/configs/mnist_small.json",
                            "reduced": ["N"], "why": "a dummy"})
    wl = core.load_json(os.path.join(core.ROOT,
                                     "benchmark/workloads/mnist.serve.json"))
    (root / "benchmark/workloads/mnist_small.serve.json").write_text(
        json.dumps(wl))
    spec["workloads"].append({"name": "mnist_small.serve",
                              "config": "mnist_small", "traffic": "serve",
                              "chips": 1, "why": "a dummy"})
    (root / "benchmark/metrics/requests_done.py").write_text(
        "def read(rec):\n    return float(rec.steps) or None\n")
    spec["per_layer"].append({"name": "requests_done", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving entry",
                              "moves": "serve_p95_ms",
                              "workloads": ["mnist_small.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = core.find_cell("mnist_small.serve", str(root))
    assert cell.config["N"] == 400
    assert [m["name"] for m in cell.per_layer][-1] == "requests_done"
    read = core.metric_reader("requests_done", str(root))
    assert read(core.Record("c", {}, {}, steps=3)) == 3.0
    assert core.driver(cell.workload["driver"], str(root)).run


def test_no_card_no_result():
    """Without a CUDA card a run fails and prints no result line."""
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mnist.serve", "--seed", str(2 ** 31 + 1),
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
