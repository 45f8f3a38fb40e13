"""A traffic-sign learning curve on the card.

    python -m ips_tpu_torch.scripts.traffic_learning [--out curve.jsonl]

Repeats the JAX package's synthetic traffic learning run (RESULTS.md,
"Quality: traffic pipeline end-to-end"; its log, results/
traffic_synth_train.log) with the port, in memory: 128 synthetic STS
images a set (``IMAGES_PER_SET``) at 1200x1600 from the port's generator
(``chip_smoke.traffic_corpus``, the images before JPEG), the shipped
config (chip_smoke.py's literal ``TRAFFIC_CONFIG``: ResNet-18 with all 4
blocks, D = 512, N = 192 patches of 100x100x3, M = 10, I = 32, bf16)
with the settings that run logged: ``input_norm: imagenet`` (uint8
patches normalized on the card), B = B_seq = 8, 3 warm-up epochs of 30.
It trains with ``train.loop.train_one_epoch`` and ``evaluate``, as
``main.run`` does, from random weights drawn from the config's seed, and
prints one JSON line an epoch: train and test loss and accuracy, the lr
and the epoch's seconds; then a summary line. Needs a CUDA card and
chip_smoke.py at the root of the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# what the JAX package's run logged beside the shipped config
RUN = {"input_norm": "imagenet", "B": 8, "B_seq": 8, "n_epoch": 30,
       "n_epoch_warmup": 3}
# that run's corpus: synthetic STS images a set
IMAGES_PER_SET = 128


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("traffic_learning: needs a CUDA card", file=sys.stderr)
        return 1
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.loop import evaluate, train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger

    smoke = _chip_smoke()
    conf = config_from_dict(dict(smoke.TRAFFIC_CONFIG, **RUN))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    train, test = smoke.traffic_corpus(conf, IMAGES_PER_SET)
    print(json.dumps({"n_per_set": IMAGES_PER_SET,
                      "train_images": len(train), "test_images": len(test),
                      "corpus_seconds": time.perf_counter() - t0}),
          flush=True)
    np.random.seed(conf.seed)
    train_loader, test_loader = driver.build_loaders(conf, train, test)
    trainer = driver.build_trainer(conf)
    log_train = MetricsLogger(conf.task_list)
    log_test = MetricsLogger(conf.task_list)
    task = conf.task_list[0]
    rows = []
    for epoch in range(conf.n_epoch):
        t0 = time.perf_counter()
        lr = train_one_epoch(trainer, train_loader, epoch, log_train, conf)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        evaluate(trainer, test_loader, log_test, conf)
        log_train.compute_metric()
        log_test.compute_metric()
        row = {"epoch": epoch, "lr": lr, "train_seconds": seconds,
               "train_loss": log_train.losses_epoch[task.name][-1],
               "train_accuracy": log_train.metrics[task.name][-1],
               "test_loss": log_test.losses_epoch[task.name][-1],
               "test_accuracy": log_test.metrics[task.name][-1],
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    losses = [r["train_loss"] for r in rows]
    print(json.dumps({
        "epochs": len(rows),
        "test_accuracy": [r["test_accuracy"] for r in rows],
        "test_loss": [r["test_loss"] for r in rows],
        "finite": bool(np.isfinite(losses).all()), "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
