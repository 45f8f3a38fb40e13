"""Minimal, self-contained Iterative Patch Selection example (counterpart
of examples/minimal_ips.py).

Builds a tiny synthetic patch-classification task (64 images of N = 25
noise patches of 32x32; one patch carries a class-coded stripe), trains
IPS selection and cross-attention aggregation on it with ``fused_step``,
then prints the patches ``select`` keeps for sample 0. Runs on the card,
or on the CPU with ``--cpu``; without a card and without ``--cpu`` it
raises.

    python -m ips_tpu_torch.examples.minimal_ips [--steps 60] [--cpu]

``run(steps, seed)`` is the same program at another draw: ``make_task``
from ``default_rng(seed)``, the initial weights from the config's
``seed``, each step's shuffle and dropout from ``fold_seed(seed, step)``
(the JAX script folds ``PRNGKey(0)`` with the step), and the final
selection's shuffle from ``seed``; ``main`` runs draw 0.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Union

import numpy as np
import torch

from ips_tpu_torch.config import Config, config_from_dict
from ips_tpu_torch.train.loop import fold_seed
from ips_tpu_torch.train.schedule import warmup_cosine_lr
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils.device import fp32_matmuls, resolve_device

# the JAX script's config, field for field (examples/minimal_ips.py)
DEMO_CONFIG = dict(
    n_epoch=1, B=8, B_seq=8, n_epoch_warmup=0.1, lr=3e-4, wd=0.01,
    n_class=4, is_image=True, enc_type="resnet18", n_chan_in=1,
    n_res_blocks=2, shuffle=True, shuffle_style="batch", n_token=1,
    N=25, M=5, I=5, patch_size=[32, 32], patch_stride=[32, 32],
    use_pos=False, H=4, D=128, D_k=16, D_v=16, D_inner=256,
    compute_dtype="float32",
    tasks={"task0": {"id": 0, "name": "cls", "act_fn": "softmax",
                     "metric": "accuracy"}})
N_SAMPLES, PATCH = 64, 32


def make_task(rng: np.random.Generator, n_samples: int, n_class: int,
              N: int, patch: int):
    """Images of N noise patches; one patch carries a class-coded stripe."""
    X = rng.normal(0, 0.1, (n_samples, N, patch, patch, 1)).astype(np.float32)
    y = np.arange(n_samples) % n_class
    for i, cls in enumerate(y):
        slot = rng.integers(0, N)
        pattern = np.zeros((patch, patch, 1), np.float32)
        pattern[cls::4] = 2.0
        X[i, slot] = pattern
    return X, y.astype(np.int64)


def demo_config(seed: int = 0, **over) -> Config:
    """The demo's config with ``seed`` for the initial weights."""
    return config_from_dict(dict(DEMO_CONFIG, seed=seed, **over))


def run(steps: int, seed: int = 0,
        device: Optional[Union[str, torch.device]] = None, *,
        overrides: Optional[dict] = None,
        init: Optional[Callable[[IPSTrainer], None]] = None,
        out: Callable[[str], None] = print) -> dict:
    """Train the demo for ``steps`` steps at draw ``seed`` on ``device``
    (the card by default) and select sample 0's patches. ``overrides``
    change config fields (e.g. ``shuffle=False``, ``dropout=0.0``);
    ``init`` changes the trainer's initial state (e.g. weights carried
    from the JAX package). Returns the per-step losses and batch
    accuracies and the kept indices of sample 0."""
    dev = resolve_device(device)
    conf = demo_config(seed, **(overrides or {}))
    rng_np = np.random.default_rng(seed)
    X, y = make_task(rng_np, N_SAMPLES, conf.n_class, conf.N, PATCH)

    trainer = IPSTrainer(conf, device=dev)
    if init is not None:
        init(trainer)
    mask = torch.ones((conf.B, conf.N), dtype=torch.bool, device=dev)
    weights = torch.ones((conf.B,), dtype=torch.float32, device=dev)

    name = (f" {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
            else "")
    out(f"devices: [{dev}{name}]")
    losses, accs = [], []
    for step in range(steps):
        sel = rng_np.integers(0, len(X), conf.B)
        batch = torch.from_numpy(X[sel]).to(dev)
        labels = {"cls": torch.from_numpy(y[sel]).to(dev)}
        lr = warmup_cosine_lr(step + 1, steps, 1, 0.1, conf.lr)
        loss, _, preds = trainer.fused_step(
            batch, mask, labels, weights,
            trainer.new_generator(fold_seed(seed, step)), lr)
        losses.append(float(loss))
        accs.append(float((preds["cls"].argmax(-1) == labels["cls"])
                          .float().mean()))
        if step % 10 == 0 or step == steps - 1:
            out(f"step {step:3d}  loss {losses[-1]:.4f}  "
                f"batch acc {accs[-1]:.2f}")

    # Show which patches IPS picked for one image (the signal patch should
    # score highest once trained).
    _, _, mem_idx, _ = trainer.select(torch.from_numpy(X[:1]).to(dev),
                                      generator=trainer.new_generator(seed))
    kept = mem_idx.cpu().numpy()[0]
    out(f"selected patch indices for sample 0: {kept}")
    return {"losses": losses, "accs": accs, "kept": kept}


def main(argv=None) -> dict:
    fp32_matmuls()
    p = argparse.ArgumentParser(description="minimal IPS demo")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args(argv)
    return run(a.steps, device="cpu" if a.cpu else None)


if __name__ == "__main__":
    main()
