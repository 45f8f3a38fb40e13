"""The benchmark of ips_tpu_torch, the PyTorch and CUDA port of IPS.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process sees and
prints, as the last line of standard output, one JSON object: whether
the timed path's output matched the plain reference (``correct``), the
work attempted and failed, the cell's end-to-end metrics (``--trace 0``)
or its per-layer metrics from a profiled window (``--trace 1``), the
device, and, last, every compared number beside its limit (also the last
lines of standard error). Without a CUDA card it fails and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    run's start on the host clock and a temporary directory."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 workdir, break_program=None, after_check=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.workdir = workdir
        # tests swap the program's pieces for broken ones here, and the
        # calibration reads the reference's inputs there
        self.break_program = break_program or (lambda obj: None)
        self.after_check = after_check or (lambda **kw: None)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout, so a
    checkout's first run fills them and later runs hit."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "benchmark", ".cache", sub)


def _card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        limit = "not read"
    print(f"card: {name}; devices {torch.cuda.device_count()}; "
          f"name, power limit: {limit}", file=sys.stderr, flush=True)
    return {"platform": "gpu", "kind": name}


def measure(cell, seed, seconds, trace, device, workdir,
            break_program=None, after_check=None, t_start=None) -> dict:
    """Run the cell and return the result line's object (no device
    entry)."""
    from benchmark import core
    ctx = Context(cell, seed, seconds, trace, device,
                  T_START if t_start is None else t_start, workdir,
                  break_program, after_check)
    out = core.driver(cell.workload["driver"], cell.root).run(ctx)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = core.metric_reader(m["name"], cell.root)(out.record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(out.correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "record": out.record}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    _cache_dirs()
    from benchmark import core
    cell = core.find_cell(a.workload)
    import torch
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"this cell needs {chips} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                 " (no result)")
        return 2
    device = _card(torch)
    with tempfile.TemporaryDirectory(prefix="ips_bench_") as workdir:
        res = measure(cell, a.seed, a.seconds, bool(a.trace),
                      torch.device("cuda", 0), workdir)
    rec = res.pop("record")
    device.update(count=chips, memory_peak_bytes=int(rec.peak_bytes))
    if a.trace:
        if rec.trace is None:
            core.log("no whole profile in any try: no per-layer result")
            return 3
        device.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
    found = core.forbidden_loaded()
    if found:
        core.log(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    checks = res.pop("checks")
    line = {**res, "device": device}
    if a.trace:
        line["breakdown"] = {"device_ops": rec.trace.device_ops(),
                             "idle_gaps": rec.trace.idle_gaps()}
    line["checks"] = checks
    for k, c in checks.items():
        core.log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
