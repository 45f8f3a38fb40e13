"""One small fp32 training step scored by the kernel, held against the same
step scored by the plain version, on the card and on the CPU, for several
input seeds.

    python -m ips_tpu_torch.scripts.train_parity

From the same seeded weights, ``IPSTrainer.fused_step`` runs three ways,
at a small MNIST-like config (``SMALL_TRAIN``) and at the traffic
config's model (``SMALL_TRAFFIC``, ResNet-18 with all 4 blocks):
on the card with ``csrc/score_logits.cu`` scoring selection, on the card
with the plain scorer, and on the CPU (plain). For each input seed of
``SEEDS`` it prints one JSON line: the kernel's launches, and against each
plain step whether the kept indices agree, the loss's relative
difference, the worst relative Frobenius distance of the ReLU inputs of
the train forward, the ReLU gates the two steps set differently, and the
worst relative Frobenius distance per tensor of the gradients (before the
update) and of the parameters (after it). Then it applies ``check``, as
``chip_smoke.py`` (phase train) and ``tests/test_torch_gpu.py`` do.

A ReLU input within rounding of 0 can fall on either side on two devices,
and one such flip moves the gradient of every parameter used before it in
the forward. So the check asks for evidence instead of avoiding such
inputs: every ReLU input agrees to ``PRE_DIST``, each flipped gate's two
inputs straddle 0 by at most ``FLIP_TOL`` of that ReLU input's RMS, and
the gradient and parameter bounds hold for every parameter first used
after the last flipped gate (all of them when no gate flipped). At least
one seed must flip no gate.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ips_tpu_torch.config import Config, config_from_dict
from ips_tpu_torch.ops import score_kernel as sk
from ips_tpu_torch.train.steps import IPSTrainer

# a small fp32 image config, no shuffle, no dropout
SMALL_TRAIN = {
    "B": 4, "B_seq": 4, "n_class": 10, "n_chan_in": 1, "n_token": 2,
    "N": 40, "M": 8, "I": 8, "patch_size": [16, 16],
    "patch_stride": [16, 16], "use_pos": True, "H": 4, "D": 128, "D_k": 16,
    "D_v": 16, "D_inner": 256, "compute_dtype": "float32", "shuffle": False,
    "attn_dropout": 0.0, "dropout": 0.0,
    "tasks": {"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                        "metric": "accuracy"},
              "task1": {"id": 1, "name": "multi", "act_fn": "sigmoid",
                        "metric": "multilabel_accuracy"}},
}
# the traffic config's model at a small shape, fp32: RGB 20-px patches,
# ResNet-18 with all 4 blocks (D = 512), one token, no positions, one
# softmax task; N - M = 44 makes 6 chunks of I = 8, the last padded
SMALL_TRAFFIC = {
    "B": 4, "B_seq": 4, "n_class": 4, "n_chan_in": 3, "n_res_blocks": 4,
    "n_token": 1, "N": 48, "M": 4, "I": 8, "patch_size": [20, 20],
    "patch_stride": [20, 20], "use_pos": False, "H": 2, "D": 512,
    "D_k": 8, "D_v": 8, "D_inner": 64, "compute_dtype": "float32",
    "shuffle": False, "attn_dropout": 0.0, "dropout": 0.0,
    "tasks": {"task0": {"id": 0, "name": "sign", "act_fn": "softmax",
                        "metric": "accuracy"}},
}
# input seeds; on the H100 seed 4 puts one ReLU input of layer1_block1
# within rounding of 0, so the card and the CPU gate it differently
SEEDS = tuple(range(3, 10))
LR = 1e-3
# Bounds in fp32 with TF32 off: the loss to rtol 1e-4, the gradients per
# tensor to relative Frobenius distance 1e-4, the params after one AdamW
# step to 1e-3, since Adam turns a gradient at rounding level into a step
# of about lr.
LOSS_RTOL = 1e-4
GRAD_DIST = 1e-4
PARAM_DIST = 1e-3
# each ReLU input of the train forward, per tensor
PRE_DIST = 1e-5
# a flipped gate's |a| + |b| over its ReLU input's RMS: about the
# worst-case rounding of an fp32 sum of the encoder's longest reduction
# (3*3*128 terms, 1152 * 2^-24 = 6.9e-5); with all 4 blocks 3*3*512
# terms, 4608 * 2^-24 = 2.7e-4
FLIP_TOL = 1e-4
FLIP_TOL_4_BLOCKS = 3e-4


def make_inputs(conf: Config, seed: int, blank: float = 0.4):
    """(patches, labels, weights) as numpy: a ``blank`` share of blank
    patches, a label for each task, weight 0 for the third instance."""
    rng = np.random.default_rng(seed)
    x = rng.random((conf.B, conf.N) + tuple(conf.patch_size) +
                   (conf.n_chan_in,), np.float32)
    x[:, rng.random(conf.N) < blank] = 0.0
    labels = {t.name: (rng.integers(0, conf.n_class, conf.B)
                       if t.act_fn == "softmax"
                       else (rng.random((conf.B, conf.n_class)) < 0.5
                             ).astype(np.float32))
              for t in conf.task_list}
    w = np.ones(conf.B, np.float32)
    w[2] = 0.0
    return x, labels, w


class _ForwardRecord(TorchFunctionMode):
    """The order in which each parameter is first used, and each ReLU's
    input, on one counter."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.first_use: Dict[str, int] = {}
        self.relus: List[tuple] = []          # (position, name, input)
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in list(args) + list(kwargs.values()):
            k = self.names.get(id(a))
            if k is not None and k not in self.first_use:
                self.first_use[k] = self.n
                self.n += 1
        if func in (F.relu, torch.relu, torch.Tensor.relu):
            last = max(self.first_use, key=self.first_use.get,
                       default="input")
            self.relus.append((self.n, f"{len(self.relus)}:"
                               f"{last.rsplit('.', 1)[0]}",
                               args[0].detach().double().cpu()))
            self.n += 1
        return func(*args, **kwargs)


def run_step(conf: Config, inputs, device, plain_scorer: bool = False
             ) -> Dict[str, object]:
    """One fused_step from the seeded weights; its kept indices, loss,
    kernel launches, gradients, updated params and the train forward's
    record."""
    tr = IPSTrainer(conf, device=device)
    model = tr.model
    if plain_scorer:
        tr._enc_score_fns = lambda: (model.encode, lambda e, m: (
            sk.fast_scores(e.float(), model.score_weights(), m)))
    x, labels, w = inputs
    x = torch.from_numpy(x).to(device)
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=device)
    labels = {k: torch.from_numpy(v).to(device) for k, v in labels.items()}
    w = torch.from_numpy(w).to(device)
    idx = tr.select(x, mask)[2].cpu()
    record = _ForwardRecord(model)
    loss_and_aux = tr._loss_and_aux

    def recorded(*args):                 # the train forward and the loss
        with record:
            return loss_and_aux(*args)
    tr._loss_and_aux = recorded
    before = sk.logits.launches
    loss = tr.fused_step(x, mask, labels, w, None, LR)[0].item()
    return {"idx": idx, "loss": loss, "launches": sk.logits.launches - before,
            "grads": {k: p.grad.detach().double().cpu()
                      for k, p in model.named_parameters()},
            "params": {k: p.detach().double().cpu()
                       for k, p in model.named_parameters()},
            "first_use": record.first_use, "relus": record.relus}


def _worst(a, b, keys):
    dist = {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in keys}
    k = max(dist, key=dist.get)
    return dist[k], k


def compare(a, b) -> Dict[str, object]:
    """Step ``a`` against step ``b``."""
    pre = {}
    flips = {}
    last_flip = -1
    for (pos, name, x), (_, _, y) in zip(a["relus"], b["relus"]):
        pre[name] = ((x - y).norm() / y.norm()).item()
        flip = (x > 0) != (y > 0)
        if flip.any():
            rms = y.pow(2).mean().sqrt()
            flips[name] = {"n": int(flip.sum()),
                           "gap": ((x - y).abs()[flip].max() / rms).item()}
            last_flip = pos
    held = [k for k in b["grads"]
            if a["first_use"].get(k, math.inf) > last_flip]
    grad, grad_at = _worst(a["grads"], b["grads"], held)
    param, param_at = _worst(a["params"], b["params"], held)
    pre_worst = max(pre, key=pre.get)
    return {"same_idx": bool(torch.equal(a["idx"], b["idx"])),
            "loss": a["loss"], "other_loss": b["loss"],
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "n_relu": len(pre), "pre_dist": pre[pre_worst],
            "pre_worst": pre_worst, "gate_flips": flips,
            "n_held": len(held), "n_params": len(b["grads"]),
            "grad_dist": grad, "grad_worst": grad_at,
            "param_dist": param, "param_worst": param_at}


def parity(device, seed: int, config: Dict[str, object] = SMALL_TRAIN,
           blank: float = 0.4) -> Dict[str, object]:
    """The kernel's step against the plain scorer's on ``device`` and the
    CPU's, for one input seed, at ``config`` (SMALL_TRAIN, or
    SMALL_TRAFFIC with ``blank=0``: a selection of blank patches alone
    leaves the stem's batch statistics, and so its gradient, at 0)."""
    conf = config_from_dict(config)
    inputs = make_inputs(conf, seed, blank)
    kernel = run_step(conf, inputs, device)
    return {"seed": seed, "launches": kernel["launches"],
            "n_iter": -(-(conf.N - conf.M) // conf.I),
            "vs_device_plain": compare(kernel, run_step(conf, inputs, device,
                                                        plain_scorer=True)),
            "vs_cpu": compare(kernel, run_step(conf, inputs, "cpu"))}


def check(results: List[Dict[str, object]], flip_tol: float = FLIP_TOL
          ) -> None:
    """Raise unless every seed's comparisons meet the bounds, each flipped
    gate is a rounding near-tie (within ``flip_tol``), and some seed flips
    no gate."""
    clean = 0
    for res in results:
        at = f"seed {res['seed']}"
        if res["launches"] != res["n_iter"]:
            raise AssertionError(f"{at}: the kernel's step launched it "
                                 f"{res['launches']} times, not "
                                 f"{res['n_iter']}")
        for side in ("vs_device_plain", "vs_cpu"):
            r = res[side]
            if not r["same_idx"]:
                raise AssertionError(f"{at} {side}: the steps kept "
                                     "different patches")
            for name, f in r["gate_flips"].items():
                if not f["gap"] <= flip_tol:
                    raise AssertionError(
                        f"{at} {side}: gate {name} flipped with inputs "
                        f"{f['gap']:.3e} of its RMS apart (> {flip_tol})")
            for key, bound in (("loss_rel", LOSS_RTOL), ("pre_dist", PRE_DIST),
                               ("grad_dist", GRAD_DIST),
                               ("param_dist", PARAM_DIST)):
                if not r[key] <= bound:
                    raise AssertionError(f"{at} {side}: {key} {r[key]:.3e} "
                                         f"> {bound} ({r})")
        clean += not (res["vs_device_plain"]["gate_flips"]
                      or res["vs_cpu"]["gate_flips"])
    if not clean:
        raise AssertionError("every seed flipped a ReLU gate: no step was "
                             "held in full")


def main() -> None:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    for config, blank, flip_tol in ((SMALL_TRAIN, 0.4, FLIP_TOL),
                                    (SMALL_TRAFFIC, 0.0, FLIP_TOL_4_BLOCKS)):
        results = []
        for seed in SEEDS:
            results.append(parity(torch.device("cuda"), seed, config,
                                  blank))
            print(json.dumps(results[-1]), flush=True)
        check(results, flip_tol)


if __name__ == "__main__":
    main()
