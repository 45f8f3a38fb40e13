"""A megapixel-MNIST learning curve on the card.

    python -m ips_tpu_torch.scripts.mnist_learning [--seed S] [--init w.npz]
        [--out f.jsonl]

Repeats the JAX package's 40-epoch MNIST run (RESULTS.md, "Quality";
its log, results/mnist_40epoch_tpu.log, and metrics,
results/mnist_40epoch_metrics.jsonl) with the port: the shipped config
(chip_smoke.py's literal ``MNIST_CONFIG``: B = 16, N = 900 patches of
50x50, M = I = 100, ResNet-18/2, D = 128, K = 8, bf16, sparse input
densified on the card) with the settings that run logged, 40 epochs of
which 4 warm up (``RUN``), on the store that run trained on: 5000 + 1000
images at 1500x1500 from the sklearn digits with the generator's
defaults, written by the port (two spawned processes, one a split) into
a temporary directory and checked against the smoke script's digest of
the JAX package's store. It trains with ``train.loop.train_one_epoch``
and ``evaluate``, as ``main.run`` does, from random weights drawn from
``--seed`` (the config's seed, 0, by default; the store keeps seed 0),
or from ``--init``, a flat reference-named ``.npz`` as
``ips_tpu_torch.weights`` reads it (e.g. the JAX package's initial
variables, which ``write_jax_init`` in tests/test_torch_mnist_shipped.py
writes), and prints one JSON line an epoch (each task's train and test
loss and metric, the lr, the epoch's train seconds), then a summary with the
last epoch's test metrics beside the JAX run's where its metrics file
is in the checkout. Needs a CUDA card and chip_smoke.py at the root of
the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# what the JAX package's run logged beside the shipped config
RUN = {"n_epoch": 40, "n_epoch_warmup": 4}
JAX_METRICS = os.path.join(ROOT, "results", "mnist_40epoch_metrics.jsonl")
# the least last-epoch test metric that matches the JAX run: its value
# less this
MARGIN = {"majority": 0.01, "max": 0.025, "top": 0.025, "multi": 0.04}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_last_test(n_epoch):
    """The JAX run's test metrics of its last epoch, or None."""
    if not os.path.exists(JAX_METRICS):
        return None
    with open(JAX_METRICS) as f:
        rows = [json.loads(line) for line in f]
    return next((r for r in rows if r["epoch"] == n_epoch - 1
                 and r["split"] == "test"), None)


def main(argv=None) -> int:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0,
                   help="the weights', shuffle's and dropout's seed")
    p.add_argument("--init", default="",
                   help="initial weights: a flat reference-named .npz")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("mnist_learning: needs a CUDA card", file=sys.stderr)
        return 1
    from ips_tpu_torch import main as driver
    from ips_tpu_torch import weights
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.loop import evaluate, train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger

    smoke = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_mnist_")
    try:
        t0 = time.perf_counter()
        data, writers = smoke.shipped_store(tmp)
        try:
            seconds = writers.wait()
        finally:
            writers.close()
        conf = config_from_dict(dict(smoke.MNIST_CONFIG, data_dir=data,
                                     seed=a.seed, **RUN))
        np.random.seed(conf.seed)
        train, test = driver.build_datasets(conf, "mnist")
        digest = smoke.store_digest(train._data, test._data)
        print(json.dumps({
            "train_images": len(train), "test_images": len(test),
            "generate_seconds": seconds,
            "store_seconds": time.perf_counter() - t0,
            "digest_equal": digest == smoke.SHIPPED_DIGEST}), flush=True)
        if digest != smoke.SHIPPED_DIGEST:
            raise AssertionError("the store differs from the JAX package's")
        train_loader, test_loader = driver.build_loaders(conf, train, test)
        trainer = driver.build_trainer(conf)
        if a.init:
            weights.load_flat(trainer.model, a.init)
        log_train = MetricsLogger(conf.task_list)
        log_test = MetricsLogger(conf.task_list)
        rows = []
        for epoch in range(conf.n_epoch):
            t0 = time.perf_counter()
            lr = train_one_epoch(trainer, train_loader, epoch, log_train,
                                 conf)
            torch.cuda.synchronize()
            row = {"epoch": epoch, "lr": lr,
                   "train_seconds": time.perf_counter() - t0}
            evaluate(trainer, test_loader, log_test, conf)
            log_train.compute_metric()
            log_test.compute_metric()
            for split, log in (("train", log_train), ("test", log_test)):
                for t in conf.task_list:
                    row[f"{split}_{t.name}_loss"] = \
                        log.losses_epoch[t.name][-1]
                    row[f"{split}_{t.name}_{t.metric}"] = \
                        log.metrics[t.name][-1]
            rows.append(row)
            print(json.dumps(row), flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last = rows[-1]
    ref = _jax_last_test(conf.n_epoch)
    summary = {"epochs": len(rows), "seed": conf.seed,
               "init": a.init or "seed", "card": card,
               "finite": bool(np.isfinite(
                   [v for r in rows for k, v in r.items()
                    if k.endswith("_loss")]).all()),
               "steps": trainer.step}
    for t in conf.task_list:
        key = f"{t.name}_{t.metric}"
        got = last[f"test_{key}"]
        summary[f"test_{key}"] = got
        if ref is not None:
            bar = ref[key] - MARGIN[t.name]
            summary[f"jax_test_{key}"] = ref[key]
            summary[f"met_{t.name}"] = got >= bar - 1e-12
    print(json.dumps(summary), flush=True)
    return 0 if summary["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
