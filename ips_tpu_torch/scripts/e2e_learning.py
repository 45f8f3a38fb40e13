"""A camelyon_e2e learning curve on the card.

    python -m ips_tpu_torch.scripts.e2e_learning [--epochs 30] \\
        [--out curve.jsonl]

Trains the camelyon_e2e driver's schedule (``train.loop.train_one_epoch``
and ``evaluate``, as ``main.run`` runs them) for ``--epochs`` epochs on
the synthetic raw-tile corpus of chip_smoke.py's phase camelyon_e2e
(``chip_smoke.e2e_corpus``: 8 train slides of 1281-2304 tiles, one
optimizer step of B = 8 an epoch; 4 test slides of 200/700/1200/2000
tiles) with the smoke's config literal and gradient re-encode chunk, from
random weights drawn from the config's seed. Each epoch prints one JSON
line: train and test loss and AUC, the test slides' predicted
probabilities and how many distinct values they take (an AUC of exactly
0.5 from tied predictions shows there), and the epoch's seconds. Needs a
CUDA card and chip_smoke.py at the root of the checkout.
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
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("e2e_learning: needs a CUDA card", file=sys.stderr)
        return 1
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.loop import evaluate, train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger

    smoke = _chip_smoke()
    conf = config_from_dict(dict(
        smoke.CAMELYON_E2E_CONFIG, n_epoch=a.epochs,
        grad_encode_chunk=smoke.E2E_GRAD_ENCODE_CHUNK))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    _, train, test = smoke.e2e_corpus(conf)
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
        probs = np.asarray(log_test.y_preds[task.name], np.float64).ravel()
        labels = np.asarray(log_test.y_trues[task.name]).ravel()
        log_train.compute_metric()
        log_test.compute_metric()
        row = {"epoch": epoch, "lr": lr, "train_seconds": seconds,
               "train_loss": log_train.losses_epoch[task.name][-1],
               "train_auc": log_train.metrics[task.name][-1],
               "test_loss": log_test.losses_epoch[task.name][-1],
               "test_auc": log_test.metrics[task.name][-1],
               "test_probs": probs.tolist(), "test_labels": labels.tolist(),
               "test_distinct_probs": int(np.unique(probs).size),
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    losses = [r["train_loss"] for r in rows]
    print(json.dumps({
        "epochs": len(rows), "train_loss_first": losses[0],
        "train_loss_last": losses[-1],
        "train_loss_min": float(np.min(losses)),
        "train_loss_last5_mean": float(np.mean(losses[-5:])),
        "test_auc": [r["test_auc"] for r in rows],
        "finite": bool(np.isfinite(losses).all()), "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
