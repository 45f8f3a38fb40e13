"""Training cells: the program's training driver, epoch after epoch.

Set-up makes the cell's traffic and the weights from the seed, builds one
trainer, loads the weights through the program's weight bridge, builds
the program's loader over the program's dataset, and drives the first
epoch through ``train/loop.train_one_epoch``: that warms every shape of
the cell and gives the optimizer steps that the reference follows (an
optimizer hook keeps the first moment after step one and the parameters
after the last compared step; a logger keeps each step's losses and
predictions). The timed window then runs further epochs through the same
call on the same trainer and loader, cut at a dispatch boundary once
``--seconds`` have passed. A traced run profiles a fixed number of
dispatches instead.

The feed that the benchmark hands ``train_one_epoch`` wraps the
program's loader: it times each ``next()`` (the loader wait), counts
the valid patches of every batch and stops at a dispatch boundary.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Dict, List

import numpy as np

from benchmark import check, core, flops, weights
from benchmark.trace import span, traced


class _Rows:
    """The program's dataset with each item's row number added, so that
    the reference learns which images made each batch."""

    def __init__(self, ds):
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        item = dict(self._ds[i])
        item["bench_row"] = np.int64(i)
        return item

    def __getattr__(self, name):
        return getattr(self._ds, name)


class _Feed:
    """Iterates the program's loader for one epoch. Every ``cut_every``
    batches (a dispatch, or the whole epoch) it asks ``stop`` with the
    dispatches (``every`` batches) the window has run; a stop before the
    epoch's end is a cut."""

    def __init__(self, loader, every: int, n_slots: int):
        self.loader, self.every, self.n_slots = loader, every, n_slots
        self.cut_every = every
        self.stop: Callable[[int], bool] = lambda g: False
        self.waits: List[float] = []
        self.rows: List[List[int]] = []
        self.batches = 0          # in the current window
        self.patches = 0
        self.cut = False

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        n = 0
        try:
            while True:
                if n % self.cut_every == 0 and self.stop(self.batches
                                                         // self.every):
                    self.cut = n < len(self.loader)
                    return
                with span("loader_wait", self.waits):
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                self.rows.append([int(r) for r in b["bench_row"]])
                self.patches += (int(np.count_nonzero(b["mask"]))
                                 if "mask" in b else
                                 len(b["bench_row"]) * self.n_slots)
                self.batches += 1
                n += 1
                yield b
        finally:
            it.close()


def _trained(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Copies of the trained leaves (on the CPU the bridge's arrays share
    the parameters' memory)."""
    return {k: np.array(v) for k, v in flat.items() if k.startswith("params/")}


def _flat_of(model, value, to_flat) -> Dict[str, np.ndarray]:
    """The model's trained leaves with each parameter replaced by
    ``value(parameter)``, under the flat reference names."""
    import torch
    params = list(model.parameters())
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.copy_(value(p))
    try:
        return _trained(to_flat(model))
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)


def _per_dispatch(marks: List, every: int) -> str:
    """The quartiles of the host time a dispatch (``every`` loader
    batches) took between the window's cuts."""
    per = [(t1 - t0) * 1e3 * every / (b1 - b0)
           for (b0, t0), (b1, t1) in zip(marks, marks[1:]) if b1 > b0]
    if len(per) < 2:
        return "dispatches too few for quartiles"
    q = statistics.quantiles(per, n=4)
    return (f"{len(per)} cuts, ms a dispatch q1 {q[0]:.2f} median "
            f"{q[1]:.2f} q3 {q[2]:.2f} (min {min(per):.2f}, "
            f"max {max(per):.2f})")


def run(ctx) -> core.Outcome:
    import torch
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.main import build_loaders, build_trainer
    from ips_tpu_torch.ops import score_kernel
    from ips_tpu_torch.train.loop import train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.utils.device import fp32_matmuls
    from ips_tpu_torch.weights import load_flat, to_flat

    fp32_matmuls()
    cell, w, dev = ctx.cell, ctx.cell.workload, ctx.device
    cuda = dev.type == "cuda"
    n_cmp = w["compared_steps"]
    conf_d = dict(cell.config, seed=ctx.seed)
    marks = [("start", time.perf_counter())]
    data = core.traffic(w["generator"]).make(w["traffic"], ctx.seed,
                                             ctx.workdir, conf_d)
    marks.append(("traffic", time.perf_counter()))
    conf_d.update(data.conf_updates)
    conf = config_from_dict(conf_d)
    init = {k: v.cpu().numpy()
            for k, v in weights.draw(conf_d, ctx.seed, dev).items()}
    trainer = build_trainer(conf, dev)
    load_flat(trainer.model, init)
    dataset = _Rows(data.dataset(conf))
    loader = build_loaders(conf, dataset, dataset)[0]
    steps_per_epoch = len(loader)
    marks.append(("weights and build", time.perf_counter()))
    r = conf.B // conf.B_seq
    n_slots = conf.N or max(data.ladder)
    feed = _Feed(loader, conf.steps_per_dispatch * r, n_slots)

    class Steps(MetricsLogger):
        """Keeps the first steps' losses and predictions."""

        def __init__(self, tasks):
            super().__init__(tasks)
            self.seen: List = []

        def update(self, losses, preds, labels, weights=None):
            if len(self.seen) < n_cmp:
                self.seen.append((sum(losses.values()) / len(losses),
                                  {k: np.array(v) for k, v in
                                   preds.items()}))
            super().update(losses, preds, labels, weights=weights)

    kept: Dict = {"n": 0}
    beta1 = trainer.opt.param_groups[0]["betas"][0]

    def after_step(opt, args, kwargs):
        kept["n"] += 1
        if kept["n"] == 1:
            kept["grad1"] = _flat_of(
                trainer.model,
                lambda p: opt.state[p]["exp_avg"] / (1.0 - beta1), to_flat)
        if kept["n"] == n_cmp:
            kept["params3"] = _trained(to_flat(trainer.model))

    hook = trainer.opt.register_step_post_hook(after_step)
    # the kept indices of the compared steps, where the loop selects
    # through the trainer's public streaming selection: the reference
    # judges them by its own saliency of every valid patch
    # (``sel_lift_gap``) and trains on them; a fused step keeps them
    # inside and the reference selects on its own
    chosen: List[np.ndarray] = []
    streaming = trainer.select_streaming

    def watched(*a, **kw):
        res = streaming(*a, **kw)
        if len(chosen) < n_cmp * r:
            chosen.append(res[2].cpu().numpy())
        return res

    trainer.select_streaming = watched
    ctx.break_program(trainer)
    epoch = w["start_epoch"]
    logger = Steps(conf.task_list)
    with span("train_one_epoch"):
        train_one_epoch(trainer, feed, epoch, logger, conf)
    hook.remove()
    trainer.select_streaming = streaming
    # an optimizer that never stepped leaves no moments and no change:
    # read what it has, so that the check fails rather than the run
    if "grad1" not in kept:
        kept["grad1"] = _flat_of(
            trainer.model, lambda p: trainer.opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)) / (1.0 - beta1), to_flat)
    kept.setdefault("params3", _trained(to_flat(trainer.model)))
    first_rows = feed.rows[:n_cmp * r]
    if cuda:
        torch.cuda.synchronize(dev)
    rec = core.Record(cell.name, conf_d, w)
    rec.setup_s = time.perf_counter() - ctx.t_start
    marks.append(("first epoch", time.perf_counter()))
    core.log("set-up: process start to driver %.2f s; " % (
        marks[0][1] - ctx.t_start) + "; ".join(
        f"{n} {b - a:.2f} s" for (_, a), (n, b) in zip(marks, marks[1:])))

    dispatches: List = []       # (loader batches, host clock) at each cut

    def window(stop: Callable[[int], bool]) -> int:
        """Epochs until ``stop`` cuts one; returns the optimizer steps."""
        nonlocal epoch
        feed.batches, feed.patches, feed.waits = 0, 0, []
        dispatches.clear()

        def timed_stop(g: int) -> bool:
            if not dispatches or dispatches[-1][0] != feed.batches:
                dispatches.append((feed.batches, time.perf_counter()))
            return stop(g)

        feed.stop = timed_stop
        while not timed_stop(feed.batches // feed.every):
            epoch += 1
            feed.cut = False
            with span("train_one_epoch"):
                train_one_epoch(trainer, feed, epoch,
                                MetricsLogger(conf.task_list), conf)
            if feed.cut:
                break
        return feed.batches // r

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if not ctx.trace:
        # a cell whose steps differ in work is cut at epoch ends only, so
        # that every window holds whole epochs of the one set of sizes
        if w["window_cut"] == "epoch":
            feed.cut_every = len(loader)
        host = core.host_state()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        rec.steps = window(lambda g: time.perf_counter() >= deadline)
        if cuda:
            torch.cuda.synchronize(dev)
        rec.window_s = time.perf_counter() - t0
        rec.patches = feed.patches
        attempted = rec.steps
        core.log_host(host, core.host_state(), rec.window_s,
                      f"loader wait {sum(feed.waits):.3f} s; "
                      + _per_dispatch(dispatches, feed.every))
    else:
        groups = w["trace_dispatches"]
        counted: Dict[str, int] = {}

        def traced_window() -> int:
            n = window(lambda g: g >= groups)
            counted.update(steps=n, patches=feed.patches)
            return n

        rec.trace = traced(traced_window, lambda: window(lambda g: g >= 1),
                           lambda: score_kernel.logits.launches, core.log)
        attempted = rec.steps = counted["steps"]
        rec.patches = counted["patches"]
    rec.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    per_row = rec.patches / max(attempted * conf.B, 1)
    rec.flops_per_unit = flops.train_step_flops(conf_d, [per_row] * conf.B,
                                                n_slots)

    prog = {"losses": [s[0] for s in logger.seen],
            "preds": [s[1] for s in logger.seen],
            "grad1": kept.get("grad1"), "params3": kept.get("params3")}
    del trainer, loader, feed, dataset, logger
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if len(first_rows) < n_cmp * r:
        raise RuntimeError(f"set-up ran {len(first_rows)} loader batches; "
                           f"the check compares {n_cmp * r}")
    steps = [first_rows[k * r:(k + 1) * r] for k in range(n_cmp)]
    follow = chosen if len(chosen) == n_cmp * r else None
    ref = check.reference_train(conf_d, data, steps, w["start_epoch"],
                                steps_per_epoch, init, dev, follow=follow)
    ok, checks = check.verdict(check.train_numbers(prog, ref, init),
                               w["limits"])
    ctx.after_check(prog=prog, ref=ref, init=init, data=data, steps=steps,
                    conf=conf_d, steps_per_epoch=steps_per_epoch)
    return core.Outcome(rec, ok, attempted, 0, checks)
