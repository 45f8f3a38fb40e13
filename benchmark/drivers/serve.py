"""Serving cells: one caller on the program's ``infer.Predictor.predict``
in a closed loop, numpy in and numpy out, each request timed host to
host.

Set-up makes the request batches and the weights from the seed, builds
the Predictor, loads the weights through the program's weight bridge and
sends ``warmup_requests`` requests. The window sends requests for
``--seconds``; a traced run sends ``trace_requests`` of them in each of
its passes (``benchmark/trace.py``). Once the
window has closed, a sample of the finished requests drawn from the seed
is held to the reference.
"""

from __future__ import annotations

import gc
import time
from typing import List, Tuple

import numpy as np

from benchmark import check, core, flops, weights
from benchmark.reference import ips as R
from benchmark.trace import span, traced


def run(ctx) -> core.Outcome:
    import torch
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel
    from ips_tpu_torch.utils.device import fp32_matmuls
    from ips_tpu_torch.weights import load_flat

    fp32_matmuls()
    cell, w, dev = ctx.cell, ctx.cell.workload, ctx.device
    cuda = dev.type == "cuda"
    conf_d = dict(cell.config, seed=ctx.seed)
    marks = [("start", time.perf_counter())]
    traffic = core.traffic(w["generator"]).make(w["traffic"], ctx.seed,
                                                ctx.workdir, conf_d)
    marks.append(("traffic", time.perf_counter()))
    conf = config_from_dict(conf_d)
    init = {k: v.cpu().numpy()
            for k, v in weights.draw(conf_d, ctx.seed, dev).items()}
    predictor = Predictor(conf, device=dev)
    load_flat(predictor.trainer.model, init)
    ctx.break_program(predictor)
    marks.append(("weights and build", time.perf_counter()))
    for _ in range(w["warmup_requests"]):
        predictor.predict(traffic.batches[traffic.next_batch()])
    if cuda:
        torch.cuda.synchronize(dev)
    rec = core.Record(cell.name, conf_d, w)
    rec.setup_s = time.perf_counter() - ctx.t_start
    marks.append(("warm-up requests", time.perf_counter()))
    core.log("set-up: process start to driver %.2f s; " % (
        marks[0][1] - ctx.t_start) + "; ".join(
        f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(marks, marks[1:])))
    served: List[Tuple[int, dict]] = []
    failed = sent = 0

    def requests(stop) -> int:
        nonlocal failed, sent
        n = 0
        while not stop(n):
            with span("request_input"):
                b = traffic.next_batch()
                x = traffic.batches[b]
            t = time.perf_counter()
            try:
                with span("predict"):
                    out = predictor.predict(x)
            except RuntimeError as e:      # a refused request still counts
                core.log(f"request failed: {e}")
                failed += 1
                out = None
            rec.latencies_s.append(time.perf_counter() - t)
            if out is not None:
                served.append((b, out))
            n += 1
            sent += 1
        return n

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if not ctx.trace:
        host = core.host_state()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        attempted = requests(lambda n: time.perf_counter() >= deadline)
        rec.window_s = time.perf_counter() - t0
        lat = sorted(rec.latencies_s)
        q = (np.percentile(lat, [25, 50, 75, 95]) * 1e3 if lat
             else [float("nan")] * 4)
        core.log_host(host, core.host_state(), rec.window_s,
                      "ms a request q1 %.2f median %.2f q3 %.2f p95 %.2f "
                      "(min %.2f, max %.2f)" % (
                          *q, 1e3 * lat[0] if lat else float("nan"),
                          1e3 * lat[-1] if lat else float("nan")))
    else:
        k = w["trace_requests"]

        def work() -> int:
            rec.latencies_s.clear()
            return requests(lambda n: n >= k)

        # every pass's answers stay among the served ones that the check
        # draws from; the latencies are the traced window's
        rec.trace = traced(work, lambda: requests(lambda n: n >= 2),
                           lambda: score_kernel.logits.launches, core.log)
        attempted = sent
    rec.steps = attempted
    rec.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    B = traffic.batches[0].shape[0]
    rec.flops_per_unit = flops.request_flops(conf_d, [conf.N] * B, conf.N)
    core.log(f"requests: {attempted} attempted, {failed} failed, "
             f"{len(served)} served")

    del predictor
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 3])
    pick = rng.choice(len(served), min(w["checked_requests"], len(served)),
                      replace=False)
    params = {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
    ref = R.RefIPS(conf_d, params)
    readings = []
    for i in sorted(pick):
        b, out = served[i]
        patches = torch.from_numpy(traffic.batches[b]).to(dev)
        readings.append(check.serve_numbers(
            conf_d, ref, patches, out["selected_idx"],
            {t["name"]: out[t["name"]] for t in ref.tasks}))
        del patches
    numbers = check.worst(readings) or {k: float("nan")
                                        for k in w["limits"]}
    ok, checks = check.verdict(numbers, w["limits"])
    ctx.after_check(ref=ref, init=init, traffic=traffic, conf=conf_d,
                    checked=[served[i][0] for i in sorted(pick)])
    return core.Outcome(rec, ok and failed == 0, attempted, failed, checks)
