"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

  sound      the program as the configuration states it, per seed
  fp8        the control: the reference computed with fp8 products (e4m3
             forward, e5m2 gradients) put in the program's place
  int8       the program with its own lower-precision path switched on
             (``select_dtype: int8``)
  fault      each fault of ``benchmark/faults.py`` that the cell can
             have: half_batch (training), scores_ignored (training that
             selects by streaming), answer (serving)

    python3 benchmark/calibrate.py --cell mnist.train --seeds 12 \
        --controls 3 --out calibration/mnist.train.jsonl

Each reading is a JSON line: cell, kind, seed, the compared numbers and
the run's set-up seconds. A state left unchanged by the optimizer reads
1 on the change and needs no run. The benchmark's own runs never run
this.
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_SEED = 2_147_483_648


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=BASE_SEED)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="window of each run (serving needs requests)")
    p.add_argument("--kinds", default="sound,fp8,int8,fault")
    p.add_argument("--faults", default="",
                   help="comma-separated names of the faults to plant "
                        "(all the cell can have when empty)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the cell at the CPU tests' size")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import torch

    import run
    from benchmark import check, core, faults
    from benchmark.reference import ips as R

    R.fp32_only()
    dev = torch.device(a.device)
    if a.tiny:
        from benchmark.tests import tiny
        cell = tiny.cell(a.cell)
    else:
        cell = core.find_cell(a.cell)
    kind = cell.workload["driver"]
    kinds = a.kinds.split(",")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)

    def emit(what, seed, numbers, res=None, got=None):
        line = {"cell": a.cell, "kind": what, "seed": seed,
                "numbers": (got or {}).get("all") or numbers}
        for k in ("leaves", "kept_diff"):
            if got and k in got:
                line[k] = got[k]
        if res is not None:
            line["setup_s"] = res["record"].setup_s
            line["correct"] = res["correct"]
        core.log(json.dumps(line))
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")

    def fp8_control(**kw):
        init = kw["init"]
        if kind == "train":
            args = (kw["conf"], kw["data"], kw["steps"],
                    cell.workload["start_epoch"], kw["steps_per_epoch"],
                    init, dev)
            ctrl = check.reference_train(*args, lowp=True)
            # the fp32 reference judges and follows the control's choice
            # where it follows the program's
            ref = (check.reference_train(*args, follow=ctrl["kept"])
                   if "sel_lift" in kw["ref"] else kw["ref"])
            return check.train_numbers(ctrl, ref, init)
        low = R.RefIPS(kw["conf"], {k: torch.from_numpy(v).to(dev)
                                    for k, v in init.items()}, lowp=True)
        out = []
        for b in kw["checked"]:
            x = torch.from_numpy(kw["traffic"].batches[b]).to(dev)
            c = check.reference_serve(kw["conf"], low, x)
            out.append(check.serve_numbers(kw["conf"], kw["ref"], x,
                                           c["kept"], c["probs"]))
        return check.worst(out)

    def one(seed, c=cell, break_program=None, control=False):
        got = {}
        seen = []

        def watch(obj):
            """Keeps the program's kept indices of the compared steps
            (a look at the cause of a gap; the benchmark never does)."""
            if break_program is not None:
                break_program(obj)
            if kind != "train":
                return
            n = cell.workload["compared_steps"] * c.config["B"] \
                // c.config["B_seq"]
            for name in ("_select_impl", "select_streaming"):
                inner = getattr(obj, name)

                def wrapped(*a, _inner=inner, **kw):
                    res = _inner(*a, **kw)
                    if len(seen) < n:
                        seen.append(res[2].cpu().numpy())
                    return res
                setattr(obj, name, wrapped)

        def after(**kw):
            if kind == "train":
                got["all"] = check.train_numbers(kw["prog"], kw["ref"],
                                                 kw["init"])
                got["leaves"] = check.worst_leaves(kw["prog"], kw["ref"],
                                                   kw["init"])
                got["kept_diff"] = [
                    int(sum(len(set(p.tolist()) ^ set(r.tolist())) // 2
                            for p, r in zip(pk, rk)))
                    for pk, rk in zip(seen, kw["ref"].get("kept", []))]
            if control:
                got["fp8"] = fp8_control(**kw)

        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="ips_cal_") as d:
            res = run.measure(c, seed, a.seconds, False, dev, d,
                              break_program=watch, after_check=after,
                              t_start=t)
        torch.cuda.empty_cache()
        return res, got

    for i in range(a.seeds):
        seed = a.first + 7919 * i
        control = "fp8" in kinds and i < a.controls
        if "sound" in kinds or control:
            res, got = one(seed, control=control)
            emit("sound", seed, {k: v["value"]
                                 for k, v in res["checks"].items()}, res,
                 got)
            if control:
                emit("fp8", seed, got["fp8"])
        if i < a.controls and "fp32prog" in kinds:
            # a witness: the program itself in float32 at the cell's size
            c32 = copy.deepcopy(cell)
            c32.config.update(compute_dtype="float32", input_dtype="float32")
            res, got = one(seed, c32)
            emit("fp32prog", seed, {k: v["value"]
                                    for k, v in res["checks"].items()}, res,
                 got)
        if i < a.controls and "int8" in kinds:
            c8 = copy.deepcopy(cell)
            c8.config["select_dtype"] = "int8"
            res, got = one(seed, c8)
            emit("int8", seed, {k: v["value"]
                                for k, v in res["checks"].items()}, res,
                 got)
        if i < a.controls and "fault" in kinds:
            planted = dict(faults.BY_DRIVER[kind])
            if kind == "train" and cell.config.get("eager") is False:
                planted.update(faults.STREAMING)
            for name, plant in planted.items():
                if a.faults and name not in a.faults.split(","):
                    continue
                undo = []
                res, got = one(seed, break_program=lambda o, p=plant:
                               undo.append(p(o)))
                for u in undo:
                    u()
                emit(name, seed, {k: v["value"]
                                  for k, v in res["checks"].items()}, res,
                     got)
    print(json.dumps({"cell": a.cell, "done": True}))


if __name__ == "__main__":
    main()
