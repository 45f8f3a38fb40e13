"""A megapixel-MNIST learning curve on the card.

    python -m ips_tpu_torch.scripts.mnist_learning [--seed S] [--init w.npz]
        [--out f.jsonl]

Repeats the JAX package's 40-epoch MNIST run (RESULTS.md, "Quality";
its log, results/mnist_40epoch_tpu.log, and metrics,
results/mnist_40epoch_metrics.jsonl) with the port: the shipped config
(chip_smoke.py's literal ``MNIST_CONFIG``: B = 16, N = 900 patches of
50x50, M = I = 100, ResNet-18/2, D = 128, K = 8, bf16, sparse input
densified on the card) with the settings that run logged, 40 epochs of
which 4 warm up, on the store that run trained on: 5000 + 1000 images
at 1500x1500 from the sklearn digits with the generator's defaults,
written by the port (two spawned processes, one a split) into a
temporary directory and checked against the smoke script's digest of
the JAX package's store. It is one draw of ``init_study.py`` at full
width run for all 40 epochs (its store, loop and lines): from random
weights drawn from ``--seed`` (the weights', shuffle's and dropout's
seed, 0 by default; the store keeps seed 0), or from ``--init``, a flat
reference-named ``.npz`` as ``ips_tpu_torch.weights`` reads it (e.g. the
JAX package's initial variables, which ``write_jax_init`` in
tests/test_torch_mnist_shipped.py writes), with the streams at
``--seed``. It prints one JSON line an epoch (each task's train and test
loss and metric, the lr, the epoch's train seconds), the draw's summary
(``learned``, ``first_epoch``) and then the last epoch's test metrics
beside the JAX run's where its metrics file is in the checkout. Needs a
CUDA card and chip_smoke.py at the root of the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch

from ips_tpu_torch.scripts.init_study import (
    ROOT, RUN, card_name, chip_smoke, open_store, study_config, train_port)

JAX_METRICS = os.path.join(ROOT, "results", "mnist_40epoch_metrics.jsonl")
# the least last-epoch test metric that matches the JAX run: its value
# less this
MARGIN = {"majority": 0.01, "max": 0.025, "top": 0.025, "multi": 0.04}


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
    from ips_tpu_torch.config import config_from_dict

    smoke = chip_smoke()
    card = card_name()
    print(f"card: {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="ips_tpu_torch_mnist_")
    try:
        conf = config_from_dict(study_config(
            smoke, "full", os.path.join(tmp, "mnist"), a.seed))
        train, test = open_store(smoke, "full", conf)
        if a.init:
            draw = ({"draw": "init", "seed": None, "from": a.init}, a.init)
        else:
            draw = ({"draw": "port", "seed": a.seed, "from": "generator"},
                    None)
        summary, = train_port(conf, "cuda", train, test, [draw],
                              RUN["n_epoch"], out=a.out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = _jax_last_test(RUN["n_epoch"])
    bars = {"init": a.init or "seed", "card": card}
    for t in conf.task_list:
        key = f"{t.name}_{t.metric}"
        got = summary[f"test_{key}"]
        bars[f"test_{key}"] = got
        if ref is not None:
            bars[f"jax_test_{key}"] = ref[key]
            bars[f"met_{t.name}"] = got >= ref[key] - MARGIN[t.name] - 1e-12
    print(json.dumps(bars), flush=True)
    return 0 if summary["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
