"""What every run shares: finding a cell, its configuration, its traffic
file, its driver and its metric readers by name; the run's record; the
card's description; the check that no JAX module was loaded.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

  benchmark/workloads/<cell>.json   the cell's driver, traffic and limits
  benchmark/configs/<config>.json   the configuration (the ``file`` entry)
  benchmark/drivers/<driver>.py     ``run(ctx) -> Outcome``
  benchmark/traffic/<generator>.py  a traffic generator
  benchmark/metrics/<metric>.py     ``read(record) -> float | None``;
                                    ``<base>.<part>`` falls back to
                                    ``<base>.py`` (``mfu.train``,
                                    ``mfu.serve`` -> ``mfu.py``)

so a later cell, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ips_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file path; file names may hold dots."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such file: {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: str               # the checkout the cell's files are in
    name: str
    spec: dict              # the cell's entry in BENCHMARK.json
    workload: dict          # benchmark/workloads/<cell>.json
    config_name: str
    config: dict            # the configuration literal
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = configs[entry["config"]]
    return Cell(
        root=root, name=name, spec=entry,
        workload=load_json(os.path.join(root, "benchmark", "workloads",
                                        f"{name}.json")),
        config_name=cfg["name"],
        config=load_json(os.path.join(root, cfg["file"]))["config"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def driver(kind: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmark", "drivers",
                                    f"{kind}.py"), f"benchmark_driver_{kind}")


def traffic(generator: str):
    return importlib.import_module(f"benchmark.traffic.{generator}")


def metric_reader(name: str, root: str = ROOT
                  ) -> Callable[["Record"], Optional[float]]:
    """``read`` of ``metrics/<name>.py``, or of ``metrics/<base>.py``
    where that is missing and the name is ``<base>.<part>``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(root, "benchmark", "metrics",
                            f"{name.rsplit('.', 1)[0]}.py")
    mod = load_module(path, "benchmark_metric_" + name.replace(".", "_"))
    return mod.read


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    cell: str
    config: dict
    workload: dict
    setup_s: float = 0.0
    window_s: float = 0.0          # the timed window, host clock
    steps: int = 0                 # optimizer steps in the window
    patches: int = 0               # valid patches those steps selected over
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: Any = None              # trace.Trace of the traced window
    flops_per_unit: float = 0.0    # model FLOPs a step or a request


@dataclasses.dataclass
class Outcome:
    """A driver's result: the record, the verdict, the work attempted and
    failed, and the compared numbers {name: (value, limit)}."""
    record: Record
    correct: bool
    attempted: int
    failed: int
    checks: Dict[str, tuple]


def host_state() -> Dict[str, float]:
    """The process's CPU seconds and the machine's stolen seconds
    (``/proc/stat``), now; a reading that cannot be made is left out."""
    t = os.times()
    out = {"cpu_s": t.user + t.system}
    try:
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) \
                / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return out


def log_host(before: Dict[str, float], after: Dict[str, float],
             wall_s: float, extra: str) -> None:
    """One stderr line on what the host did over a window of ``wall_s``
    seconds: the CPUs the process may use, its CPU time and the
    machine's stolen time, then ``extra``."""
    parts = [f"{len(os.sched_getaffinity(0))} CPUs allowed",
             f"window {wall_s:.3f} s"]
    for k, what in (("cpu_s", "process CPU"), ("steal_s", "machine steal")):
        if k in before and k in after:
            parts.append(f"{what} {after[k] - before[k]:.3f} s")
    log("host: " + "; ".join(parts + [extra]))


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
