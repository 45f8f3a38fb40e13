"""Which initial draws learn megapixel MNIST, with the data and step
streams held fixed.

    python -m ips_tpu_torch.scripts.init_study --width reduced --device cpu \\
        --store DIR [--port-seeds 0-7] [--init-dir D --init-seeds 0-7]
        [--stream-seed 0] [--stop-after E] [--stop-when-learned]
        [--threads 2] [--out f.jsonl]
    python -m ips_tpu_torch.scripts.init_study --width full --store DIR ...
    python -m ips_tpu_torch.scripts.init_study --tally f.jsonl [g.jsonl ...]

Trains the flagship MNIST config (chip_smoke.py's ``MNIST_CONFIG``) from
a list of initial draws with ``train.loop.train_one_epoch`` and
``evaluate`` (``train_draw``, which ``mnist_learning.py`` runs too). A
draw is the port's (``--port-seeds``: ``IPSTrainer`` drawing from
``torch.Generator().manual_seed(s)``) or a flat reference-named ``.npz``
(``--init-dir``: ``<name>_<s>.npz`` for each of ``--init-seeds``, name
``jax`` by default, read by ``weights.load_flat``). Whatever the draw,
the patch shuffle, the dropout and the loader order come from
``--stream-seed`` (the config's ``seed``; 0 by default), and each draw
gets fresh loaders, so every draw sees the same batches.

Widths:

* ``full``: the shipped config on the shipped store (5000 + 1000 images
  at 1500x1500), on the card; the store is checked against the smoke
  script's digest of the JAX package's.
* ``reduced``: 200x200 images, N = 16 patches of 50x50, M = I = 4 and
  one step a dispatch (``REDUCED``), every other config field the
  shipped one's (B = 16, bf16, patch shuffle and dropout on), on a store
  the port's generator writes at dataset seed 0 from the sklearn digits
  with the shipped noise density (``REDUCED_STORE``: one noise sprite,
  50 at 1500x1500 scaled by the area). Its counts and cut epoch are
  frozen by the calibration below (``CALIBRATED``).

Calibration (frozen before the port's arms were counted): the JAX
package trained from its own draws at seeds 0-3 at reduced width, on
the CPU, raising the train images from 1000 + 200 or the cut epoch from
15 until at least 3 of the 4 learned. At 1000 + 200 images and 15
epochs none did (seeds 0 and 3 fit the train set, majority 0.55 and
0.51, and stayed under 0.38 on the test set); at 2000 + 200 and 15
epochs seeds 0, 2 and 3 did (first epochs 7, 8, 6): ``CALIBRATED``.

The lr schedule is always the shipped 40-epoch one with 4 warm-up
epochs (``RUN``): a run cut after ``--stop-after E`` epochs sees in each
epoch the lr that epoch sees in the 40-epoch run. Each epoch of each
draw appends one JSON line to ``--out`` as it ends (the draw, the
epoch, the lr, each task's train and test loss and metric); after each
draw one summary line is printed and appended: ``learned`` (test
majority accuracy >= 0.5 at or before the last epoch) and
``first_epoch`` (the first such epoch, or null). ``--stop-when-learned``
ends a draw at that epoch. Several processes may share one ``--store``
directory: the first writes it under a lock, the others wait and read
it. ``tests/torch_init_study_jax.py`` runs the JAX package on the CPU
over the same draws and writes the ``.npz`` draws of both packages.
``--tally`` prints, from such lines, each arm's learned draws and first
epochs, how many draws the two packages gave one fate, and Fisher's
exact test of the two generators' learn counts beside the least gap in
learned draws that the test could reject at these sizes. The study's
lines and the card runs' command lines are in
``ips_tpu_torch/results/init_study/``.
"""

from __future__ import annotations

import argparse
import fcntl
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# what the JAX package's 40-epoch run logged beside the shipped config
RUN = {"n_epoch": 40, "n_epoch_warmup": 4}
# the reduced width: 200x200 images cut into 4 x 4 patches of 50x50, one
# step a dispatch (XLA's CPU backend runs the JAX package's K-step scan
# ~10x slower a step than its single step; K changes no update)
REDUCED = {"N": 16, "M": 4, "I": 4, "steps_per_dispatch": 1}
REDUCED_STORE = {"width": 200, "height": 200, "n_noise": 1, "seed": 0,
                 "digit_source": "sklearn"}
# the calibration's frozen settings (the docstring above; PERF.md)
CALIBRATED = {"n_train": 2000, "n_test": 200, "stop_after": 15}
# a draw has learned once its test majority accuracy reaches this
LEARNED_AT = 0.5
LEARNED_KEY = "test_majority_accuracy"
# the level of the study's Fisher tests
ALPHA = 0.05


def chip_smoke():
    """chip_smoke.py at the root of the checkout, as a module (the
    shipped config, store counts and digest)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def parse_seeds(spec: str) -> List[int]:
    """``"0-7"``, ``"0,3,5"`` or ``"0-2,6"`` -> the seeds in order."""
    seeds: List[int] = []
    for part in filter(None, spec.split(",")):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def study_config(smoke, width: str, data_dir: str, stream_seed: int,
                 deterministic: bool = False, fp32: bool = False) -> dict:
    """The config as a dict: the shipped MNIST one with the 40-epoch
    schedule, cut to ``width``. ``deterministic`` (patch shuffle and
    dropout off) and ``fp32`` (compute and inputs in fp32) are for
    holding the two packages step by step against each other from one
    draw; no counted run sets them."""
    c = dict(smoke.MNIST_CONFIG, data_dir=data_dir, seed=stream_seed, **RUN)
    if width == "reduced":
        c.update(REDUCED)
    if deterministic:
        c.update(shuffle=False, dropout=0.0, attn_dropout=0.0)
    if fp32:
        c.update(compute_dtype="float32", input_dtype="float32")
    return c


def store_args(smoke, width: str, n_train: int = CALIBRATED["n_train"],
               n_test: int = CALIBRATED["n_test"]) -> dict:
    """``SplitWriters`` keywords of the width's store (the counts are the
    reduced width's; the full width's are the shipped ones)."""
    if width == "full":
        return {"n_train": smoke.SHIPPED_TRAIN_IMAGES,
                "n_test": smoke.SHIPPED_TEST_IMAGES}
    return dict(REDUCED_STORE, n_train=n_train, n_test=n_test)


def ensure_store(store: str, kw: dict) -> Optional[Dict[str, float]]:
    """Write the store ``kw`` describes into ``store`` (the two splits in
    two spawned processes) unless an earlier process has; returns each
    split's seconds, or None if it was there. A store written with other
    arguments raises."""
    from ips_tpu_torch.data.mnist import SplitWriters
    os.makedirs(store, exist_ok=True)
    done = os.path.join(store, "written.json")
    with open(os.path.join(store, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(done):
            with open(done) as f:
                had = json.load(f)
            if had != kw:
                raise ValueError(f"{store} holds the store {had}, not {kw}")
            return None
        writers = SplitWriters(store, **kw)
        try:
            seconds = writers.wait()
        finally:
            writers.close()
        with open(done, "w") as f:
            json.dump(kw, f)
        return seconds


def open_store(smoke, width: str, conf, n_train: int = CALIBRATED["n_train"],
               n_test: int = CALIBRATED["n_test"]) -> tuple:
    """The port's (train, test) datasets of ``conf.data_dir``, written
    there first unless it holds them; prints their counts and seconds.
    At full width the store must be the JAX package's shipped one (the
    smoke script's digest of its first samples)."""
    from ips_tpu_torch import main as driver
    t0 = time.perf_counter()
    seconds = ensure_store(conf.data_dir,
                           store_args(smoke, width, n_train, n_test))
    train, test = driver.build_datasets(conf, "mnist")
    digest_equal = smoke.store_digest(train._data, test._data) \
        == smoke.SHIPPED_DIGEST
    print(json.dumps({"width": width, "train_images": len(train),
                      "test_images": len(test), "generate_seconds": seconds,
                      "store_seconds": time.perf_counter() - t0,
                      "digest_equal": digest_equal}), flush=True)
    if width == "full" and not digest_equal:
        raise AssertionError("the store differs from the JAX package's")
    return train, test


def draw_list(port_seeds: str, init_dir: str, init_seeds: str,
              init_name: str) -> List[Tuple[dict, Optional[str]]]:
    """(meta, path) per draw: the port's generator draws (path None) and
    then the ``.npz`` draws."""
    draws = [({"draw": "port", "seed": s, "from": "generator"}, None)
             for s in parse_seeds(port_seeds)]
    for s in parse_seeds(init_seeds):
        name = f"{init_name}_{s}.npz"
        draws.append(({"draw": init_name, "seed": s, "from": name},
                      os.path.join(init_dir, name)))
    return draws


def epoch_row(conf, epoch: int, lr: float, log_train, log_test) -> dict:
    """One epoch's line: the lr and each task's train and test loss and
    metric, from the loggers' last ``compute_metric``."""
    row = {"epoch": epoch, "lr": lr}
    for split, log in (("train", log_train), ("test", log_test)):
        for t in conf.task_list:
            row[f"{split}_{t.name}_loss"] = log.losses_epoch[t.name][-1]
            row[f"{split}_{t.name}_{t.metric}"] = log.metrics[t.name][-1]
    return row


def summarize(rows: Sequence[dict], meta: dict, task_keys: Sequence[str]
              ) -> dict:
    """The draw's summary line: whether and when it learned, and its last
    epoch's test metrics."""
    first = next((r["epoch"] for r in rows if r[LEARNED_KEY] >= LEARNED_AT),
                 None)
    out = dict(meta, summary=True, learned=first is not None,
               first_epoch=first, epochs=len(rows),
               finite=bool(np.isfinite([v for r in rows for k, v in r.items()
                                        if k.endswith("_loss")]).all()))
    for k in task_keys:
        out[f"test_{k}"] = rows[-1][f"test_{k}"] if rows else None
    return out


def emit(line: dict, out: str) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


def train_draw(trainer, loaders: Callable[[], tuple], conf, meta: dict, *,
               train_one_epoch, evaluate, logger_cls, stop_after: int,
               stop_when_learned: bool = False, out: str = "",
               sync: Callable[[], None] = lambda: None) -> dict:
    """Trains ``trainer`` for up to ``stop_after`` epochs on fresh
    loaders, emitting a line an epoch and then the summary, which it
    returns. The loop functions are passed in, so that the JAX package's
    run the same way."""
    np.random.seed(conf.seed)
    train_loader, test_loader = loaders()
    log_train = logger_cls(conf.task_list)
    log_test = logger_cls(conf.task_list)
    rows: List[dict] = []
    for epoch in range(stop_after):
        t0 = time.perf_counter()
        lr = train_one_epoch(trainer, train_loader, epoch, log_train, conf)
        sync()
        seconds = time.perf_counter() - t0
        evaluate(trainer, test_loader, log_test, conf)
        log_train.compute_metric()
        log_test.compute_metric()
        row = dict(meta, **epoch_row(conf, epoch, lr, log_train, log_test),
                   train_seconds=seconds)
        rows.append(row)
        emit(row, out)
        if stop_when_learned and row[LEARNED_KEY] >= LEARNED_AT:
            break
    summary = summarize(rows, meta, [f"{t.name}_{t.metric}"
                                     for t in conf.task_list])
    emit(summary, out)
    return summary


def train_port(conf, device, train, test, draws, stop_after: int, *,
               stop_when_learned: bool = False, out: str = "",
               width: str = "full") -> List[dict]:
    """The port trained from each (meta, path) of ``draws`` in turn
    (path None: ``IPSTrainer``'s draw at ``meta["seed"]``); the
    summaries."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch import weights
    from ips_tpu_torch.train.loop import evaluate, train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    from ips_tpu_torch.train.steps import IPSTrainer
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    summaries = []
    for meta, path in draws:
        if path is None:
            trainer = IPSTrainer(conf, device=device, generator=torch
                                 .Generator().manual_seed(meta["seed"]))
        else:
            trainer = IPSTrainer(conf, device=device)
            weights.load_flat(trainer.model, path)
        meta = dict(meta, trainer="port", width=width,
                    stream_seed=conf.seed)
        summaries.append(train_draw(
            trainer, lambda: driver.build_loaders(conf, train, test), conf,
            meta, train_one_epoch=train_one_epoch, evaluate=evaluate,
            logger_cls=MetricsLogger, stop_after=stop_after,
            stop_when_learned=stop_when_learned, out=out, sync=sync))
    return summaries


def fisher_p(a: int, n1: int, c: int, n2: int) -> float:
    """Two-sided p of Fisher's exact test: ``a`` of ``n1`` against ``c``
    of ``n2``."""
    import scipy.stats
    return float(scipy.stats.fisher_exact([[a, n1 - a], [c, n2 - c]])
                 .pvalue)


def least_gap(n: int, alpha: float = ALPHA) -> Optional[int]:
    """The least difference in learned draws, ``|a - c|`` over every a
    and c of ``n`` draws a side, that Fisher's exact test rejects at
    ``alpha``; None if no table of that size reaches it."""
    gaps = [abs(a - c) for a in range(n + 1) for c in range(n + 1)
            if fisher_p(a, n, c, n) < alpha]
    return min(gaps, default=None)


def tally(paths: Sequence[str]) -> dict:
    """The study's counts from the summary lines of ``paths`` (the last
    line of a draw wins): per arm (trainer, draw generator, width), the
    draws that learned and their first epochs; per width, how many draws
    the two trainers gave one fate; Fisher's exact test of each trainer's
    learn counts of the two generators, and, where both arms hold as
    many draws, the least gap it could reject at that size."""
    last = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("summary"):
                    last[(r["trainer"], r["draw"], r["width"],
                          r["stream_seed"], r["seed"])] = r
    arms: Dict[str, dict] = {}
    for (trainer, draw, width, stream, seed), r in sorted(last.items()):
        arm = arms.setdefault(f"{trainer}<-{draw} {width} s{stream}", {
            "trainer": trainer, "draw": draw, "width": width,
            "stream_seed": stream, "fates": {}})
        arm["fates"][seed] = r["first_epoch"]
    for arm in arms.values():
        fates = arm["fates"]
        arm["n"] = len(fates)
        arm["learned"] = sum(e is not None for e in fates.values())
    out = {"arms": arms, "agree": {}, "fisher": {}}
    for key, arm in arms.items():
        if arm["trainer"] != "port":
            continue
        other = arms.get(key.replace("port<-", "jax<-", 1))
        if other is not None:
            seeds = sorted(set(arm["fates"]) & set(other["fates"]))
            out["agree"][f"{key} vs jax trainer"] = {
                "seeds": len(seeds),
                "same_fate": sum((arm["fates"][s] is None)
                                 == (other["fates"][s] is None)
                                 for s in seeds)}
    for key, arm in arms.items():
        if arm["draw"] != "port":
            continue
        other = arms.get(key.replace("<-port", "<-jax", 1))
        if other is not None:
            a, c = arm["learned"], other["learned"]
            out["fisher"][key.replace("<-port", "<-port|jax", 1)] = {
                "port_draws": f"{a}/{arm['n']}",
                "jax_draws": f"{c}/{other['n']}",
                "p": fisher_p(a, arm["n"], c, other["n"]),
                "least_gap": least_gap(arm["n"])
                if arm["n"] == other["n"] else None}
    return out


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The options the port's study and the JAX package's share."""
    p.add_argument("--width", choices=("full", "reduced"), default="full")
    p.add_argument("--store", default="",
                   help="the store's directory, written if absent")
    p.add_argument("--n-train", type=int, default=CALIBRATED["n_train"],
                   help="reduced width: train images")
    p.add_argument("--n-test", type=int, default=CALIBRATED["n_test"],
                   help="reduced width: test images")
    p.add_argument("--init-dir", default="")
    p.add_argument("--init-seeds", default="")
    p.add_argument("--init-name", default="jax",
                   help="the .npz draws' prefix: <name>_<seed>.npz")
    p.add_argument("--stream-seed", type=int, default=0,
                   help="the shuffle's, dropout's and loader's seed")
    p.add_argument("--stop-after", type=int, default=0,
                   help="epochs to run (default: the calibrated cut at "
                        "reduced width, 12 at full)")
    p.add_argument("--stop-when-learned", action="store_true")
    p.add_argument("--threads", type=int, default=2,
                   help="CPU threads (torch and the loader)")
    p.add_argument("--out", default="")


def stop_after(a) -> int:
    if a.stop_after:
        return a.stop_after
    return CALIBRATED["stop_after"] if a.width == "reduced" else 12


def main(argv=None) -> int:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--port-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tally", nargs="+", default=[],
                   help="print the counts of these JSON-lines files and "
                        "exit")
    a = p.parse_args(argv)
    if a.tally:
        print(json.dumps(tally(a.tally), indent=1))
        return 0
    if not a.store:
        p.error("--store is required")
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("init_study: no CUDA card (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    from ips_tpu_torch.config import config_from_dict

    smoke = chip_smoke()
    if device.type == "cuda":
        print(f"card: {card_name()}", flush=True)
    conf = config_from_dict(study_config(smoke, a.width, a.store,
                                         a.stream_seed))
    if device.type == "cpu":
        torch.set_num_threads(a.threads)
        conf = conf.replace(n_worker=min(conf.n_worker, a.threads))
    train, test = open_store(smoke, a.width, conf, a.n_train, a.n_test)
    summaries = train_port(
        conf, device, train, test,
        draw_list(a.port_seeds, a.init_dir, a.init_seeds, a.init_name),
        stop_after(a), stop_when_learned=a.stop_when_learned, out=a.out,
        width=a.width)
    return 0 if all(s["finite"] for s in summaries) else 1


if __name__ == "__main__":
    sys.exit(main())
