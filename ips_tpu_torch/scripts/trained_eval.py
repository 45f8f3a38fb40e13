"""The JAX package's TPU-trained MNIST checkpoints in the port: evaluated,
served, int8-probed and resumed (the port's counterpart of
``scripts/probe_int8_trained.py``).

    python -m ips_tpu_torch.scripts.trained_eval eval --store DIR \\
        [--files mnist150_e150,mnist40_e44] [--images N] [--against J]
    python -m ips_tpu_torch.scripts.trained_eval int8 --store DIR
    python -m ips_tpu_torch.scripts.trained_eval resume --store DIR \\
        --file mnist150_e100 [--epochs 2]
    python -m ips_tpu_torch.scripts.trained_eval import --file F \\
        --checkpoint-dir DIR
    (each takes [--device cpu] [--out f.jsonl]; the card by default)

The files are ``ips_tpu_torch/results/trained/*.npz``, flat
reference-named states that ``tests/torch_jax_checkpoints.py`` wrote from
the JAX package's orbax checkpoints (``ckpt_mnist150/{100,150}``,
``ckpt_mnist40/44``; the machine with the card has no JAX to read
those). ``manifest.json`` beside them gives each file's epoch, the
overrides of the run that wrote it and the TPU record lines it is held
against. Every mode runs the shipped MNIST config (``chip_smoke.py``'s
``MNIST_CONFIG``) under a file's overrides on the shipped store
(``init_study.open_store``: written into ``--store`` unless there, its
digest checked against the JAX package's):

* ``eval`` (a): ``train.loop.evaluate`` over the test split (the first
  ``--images``), each task's metric and mean loss; the same images
  served through ``infer.Predictor`` batch by batch, their predictions
  against the eval's image by image (held equal for ``SERVED``). With
  ``--against`` (``tests/torch_jax_checkpoints.py calibrate``'s file),
  each image's predictions and kept set against the JAX package's on
  the CPU (bound (iv)); a kept set may part at a near tie on this
  device's side, or at one on JAX's where it equals JAX's fp32
  selection (``--jax-ties``, ``calibration/near_tie_jax.json``).
* ``int8`` (b): from ``mnist40_e44`` under the probe's config, the
  per-image Jaccard of int8 against bf16 kept sets (one generator seed
  for both, the ragged tail skipped as the probe skips it), its mean,
  p10 and min, and the bf16 and int8 metrics.
* ``resume`` (c): the file's train state written as the port's
  ``epoch_<n>.pt`` (``utils.checkpoint.save_reference_state``) and
  trained on by ``main.run(resume=true)`` for ``--epochs`` epochs at the
  run's ``n_epoch``, each epoch's lines held against the TPU's.
* ``import``: only write the ``epoch_<n>.pt``; then ``python -m
  ips_tpu_torch.main --dataset mnist resume=true checkpoint_dir=DIR
  n_epoch=<n> ...`` continues the JAX run.

Each result is one JSON line (printed, and appended to ``--out``) with
the bounds it missed under ``misses`` (PERF.md states them; ``BOUNDS``).
``chip_smoke.py``'s phase ``trained`` runs (a), (b) and one resumed
epoch. ``ips_tpu_torch/results/trained/run.sh`` holds the commands
behind the recorded lines.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ips_tpu_torch.scripts.init_study import ROOT, card_name, chip_smoke

TRAINED = os.path.join(ROOT, "ips_tpu_torch", "results", "trained")
# the int8 probe's config and selection seed
# (scripts/probe_int8_trained.py: input_dtype=bfloat16, PRNGKey(7))
PROBE_OVERRIDES = {"input_dtype": "bfloat16"}
PROBE_SEED = 7
# the file whose Predictor must give the eval's predictions image by image
SERVED = "mnist150_e150"
# the pre-registered bounds (PERF.md §6), frozen before the card's
# first run. Test accuracy is held within 4 of 1000 images of the TPU's,
# except where the CPU calibration saw rounding alone move a task by more:
# the JAX package's bf16 eval of mnist40_e44 parted from its fp32 eval on
# 1 of 160 images in ``max`` (0.00625), so that task's bound is twice it
ACCURACY = {"majority": 0.004, "max": 0.0125, "top": 0.004, "multi": 0.004}
BOUNDS = {
    # (i) eval against the TPU's line: accuracy per task, loss relative
    # (rounding alone moved a mean loss at most 2.12%, under the default)
    "eval_accuracy": ACCURACY, "eval_loss_rel": 0.03,
    # (ii) int8: mean Jaccard against the probe's, int8 accuracy per task
    "jaccard": 0.03, "int8_accuracy": ACCURACY,
    # (iii) resume: lr relative, test accuracy, train loss factor
    "lr_rel": 1e-9, "resume_accuracy": 0.02, "train_loss_factor": 3.0,
}


# ---------------------------------------------------------------- records
def manifest() -> dict:
    with open(os.path.join(TRAINED, "manifest.json")) as f:
        return json.load(f)


def npz_path(name: str) -> str:
    path = os.path.join(TRAINED, manifest()[name]["file"])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def tpu_records(name: str) -> dict:
    """The TPU lines a file is held against: ``(split, epoch)`` -> metrics
    line, and ``"probe"`` -> the int8 probe's record."""
    out = {}
    for ref in manifest()[name]["records"]:
        path, _, line = ref.partition(":")
        with open(os.path.join(ROOT, path)) as f:
            if not line:
                out["probe"] = json.load(f)
                continue
            row = json.loads(f.readlines()[int(line) - 1])
        out[row["split"], row["epoch"]] = row
    return out


def eval_target(name: str, tasks) -> dict:
    """The TPU's test metrics and mean losses behind a file's weights: the
    run's test line after the epoch that wrote them; for ``mnist40_e44``
    the accuracies of the int8 probe's bf16 eval (the same values)."""
    rec = tpu_records(name)
    epoch = manifest()[name]["epoch"] - 1
    row = rec["test", epoch]
    metrics = {t.name: row[f"{t.name}_{t.metric}"] for t in tasks}
    if "probe" in rec:
        metrics = dict(rec["probe"]["metrics_bf16"])
    return {"epoch": epoch, "metrics": metrics,
            "loss": {t.name: row[f"{t.name}_loss"] for t in tasks}}


def file_config(smoke, name: str, data_dir: str, **over):
    """The shipped MNIST config under the run's overrides of ``name``."""
    from ips_tpu_torch.config import config_from_dict
    return config_from_dict({**smoke.MNIST_CONFIG, "data_dir": data_dir,
                             **manifest()[name]["overrides"], **over})


class First:
    """The first ``n`` items of a dataset."""

    def __init__(self, inner, n: Optional[int]):
        self.inner = inner
        self.n = len(inner) if n is None else min(n, len(inner))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.inner[i]


def trainer_from(conf, name: str, device, init_opt: bool = False):
    """A trainer of ``conf`` holding the file's weights."""
    from ips_tpu_torch import weights
    from ips_tpu_torch.train.steps import IPSTrainer
    tr = IPSTrainer(conf, device=device, init_opt=init_opt)
    flat = weights.read_npz(npz_path(name))
    if "step" in flat:                  # a whole train state
        weights.load_flat_train_state(tr, flat)
    else:
        weights.load_flat(tr.model, flat)
    return tr


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def image_predictions(conf, probs: Dict[str, np.ndarray]) -> dict:
    """Per task, each image's prediction: the class of an accuracy task,
    the labels over 0.5 of a multilabel one."""
    out = {}
    for t in conf.task_list:
        p = np.asarray(probs[t.name])
        out[t.name] = ((p >= 0.5).astype(np.int64)
                       if t.metric == "multilabel_accuracy"
                       else p if p.ndim == 1 else p.argmax(-1)).tolist()
    return out


def flips(conf, a: dict, b: dict) -> Dict[str, int]:
    """Per task, the images whose predictions differ."""
    return {t.name: int(sum(x != y for x, y in zip(a[t.name], b[t.name])))
            for t in conf.task_list}


# ------------------------------------------------------------------- eval
def run_evaluate(trainer, conf, test) -> dict:
    """``train.loop.evaluate`` over ``test``: metrics, mean losses, each
    image's predictions, seconds and ``score_logits`` launches."""
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.train.loop import evaluate
    from ips_tpu_torch.train.metrics import MetricsLogger
    loader = DataLoader(test, batch_size=conf.B_seq, shuffle=False,
                        num_workers=conf.n_worker)
    logger = MetricsLogger(conf.task_list)
    launches = sk.logits.launches
    _sync(trainer.device)
    t0 = time.perf_counter()
    evaluate(trainer, loader, logger, conf)
    _sync(trainer.device)
    seconds = time.perf_counter() - t0
    preds = image_predictions(conf, {k: np.asarray(v) for k, v in
                                     logger.y_preds.items()})
    logger.compute_metric()
    return {"images": len(test), "batches": len(loader),
            "metrics": logger.latest(),
            "loss": {t.name: logger.losses_epoch[t.name][-1]
                     for t in conf.task_list},
            "seconds": seconds, "ms_per_batch": seconds / len(loader) * 1e3,
            "launches": sk.logits.launches - launches,
            "predictions": preds}


def run_predictor(trainer, conf, test) -> dict:
    """``infer.Predictor`` over ``test``, B_seq images a request, each
    batch's sparse pixels densified on the trainer's device: each image's
    predictions and kept set (sorted), ms a request."""
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.ops import score_kernel as sk
    pred = Predictor(conf, trainer=trainer)
    loader = DataLoader(test, batch_size=conf.B_seq, shuffle=False,
                        num_workers=conf.n_worker)
    probs = {t.name: [] for t in conf.task_list}
    kept, ms = [], []
    launches = sk.logits.launches
    for batch in loader:
        x = trainer.densify(batch["input_idx"], batch["input_val"],
                            batch["img_hw"][0])
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        _sync(trainer.device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out, idx = pred.forward(x, mask)
        _sync(trainer.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        for t in conf.task_list:
            probs[t.name].append(out[t.name].float().cpu().numpy())
        kept.extend(np.sort(idx.cpu().numpy(), 1).tolist())
    return {"predictions": image_predictions(
                conf, {k: np.concatenate(v) for k, v in probs.items()}),
            "kept": kept, "requests": len(ms),
            "ms_per_request": float(np.median(ms)),
            "launches": sk.logits.launches - launches}


def eval_misses(conf, res: dict, target: dict) -> List[str]:
    """Bound (i): each task's accuracy within its ``eval_accuracy`` of
    the TPU's and its mean loss within ``eval_loss_rel`` of it."""
    misses = []
    for t in conf.task_list:
        got, want = res["metrics"][t.name], target["metrics"][t.name]
        if abs(got - want) > BOUNDS["eval_accuracy"][t.name] + 1e-12:
            misses.append(f"(i) {t.name} {t.metric} {got} against {want}")
        got, want = res["loss"][t.name], target["loss"][t.name]
        if not abs(got - want) <= BOUNDS["eval_loss_rel"] * abs(want):
            misses.append(f"(i) {t.name} loss {got} against {want}")
    return misses


def eval_file(smoke, name: str, test, data_dir: str, device, *,
              predictor: bool = False) -> dict:
    """Mode (a) for one file: the line, with each image's predictions."""
    conf = file_config(smoke, name, data_dir)
    trainer = trainer_from(conf, name, device)
    res = run_evaluate(trainer, conf, test)
    target = eval_target(name, conf.task_list)
    # bound (i) holds the whole test split, which the TPU's line covers
    whole = not isinstance(test, First) or len(test) == len(test.inner)
    line = dict(mode="eval", file=name, tpu=target,
                misses=eval_misses(conf, res, target) if whole else [],
                **res)
    if predictor:
        served = run_predictor(trainer, conf, test)
        served["flips_against_eval"] = flips(conf, served["predictions"],
                                             res["predictions"])
        line["predictor"] = served
        if name == SERVED and any(served["flips_against_eval"].values()):
            line["misses"].append(
                "(a) the Predictor's predictions differ from the eval's: "
                f"{served['flips_against_eval']}")
    return line


# ------------------------------------------------------------------- int8
def jaccards(bf, i8, conf, test) -> List[float]:
    """Per image, |int8 ∩ bf16| / |int8 ∪ bf16| of the kept sets, both
    selections shuffled by generators of one seed (``PROBE_SEED`` folded
    with the batch); a ragged last batch is skipped, as the probe does."""
    from ips_tpu_torch.data.loader import DataLoader
    from ips_tpu_torch.train.loop import fold_seed
    loader = DataLoader(test, batch_size=conf.B_seq, shuffle=False,
                        num_workers=conf.n_worker)
    out = []
    for it, batch in enumerate(loader):
        if len(batch["input_idx"]) != conf.B_seq:
            continue
        x = bf.densify(batch["input_idx"], batch["input_val"],
                       batch["img_hw"][0])
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        seed = fold_seed(PROBE_SEED, it)
        a = bf.select(x, mask, bf.new_generator(seed))[2].cpu().numpy()
        b = i8.select(x, mask, i8.new_generator(seed))[2].cpu().numpy()
        for ra, rb in zip(a, b):
            sa, sb = set(ra.tolist()), set(rb.tolist())
            out.append(len(sa & sb) / len(sa | sb))
    return out


def int8_probe(smoke, test, data_dir: str, device,
               bf16_eval: Optional[dict] = None) -> dict:
    """Mode (b): the line; ``bf16_eval`` is (a)'s result for
    ``mnist40_e44`` when there is one (else it is evaluated here)."""
    name = "mnist40_e44"
    conf = file_config(smoke, name, data_dir, **PROBE_OVERRIDES)
    bf = trainer_from(conf, name, device)
    i8 = trainer_from(conf.replace(select_dtype="int8"), name, device)
    t0 = time.perf_counter()
    jac = jaccards(bf, i8, conf, test)
    _sync(device)
    jac_s = time.perf_counter() - t0
    bf16 = bf16_eval or run_evaluate(bf, conf, test)
    int8 = run_evaluate(i8, i8.conf, test)
    probe = tpu_records(name)["probe"]
    line = {"mode": "int8", "file": name, "images": len(test),
            "jaccard_images": len(jac),
            "jaccard_mean": float(np.mean(jac)),
            "jaccard_p10": float(np.percentile(jac, 10)),
            "jaccard_min": float(np.min(jac)),
            "jaccard_seconds": jac_s,
            "metrics_bf16": bf16["metrics"], "metrics_int8": int8["metrics"],
            "loss_int8": int8["loss"], "int8_seconds": int8["seconds"],
            "launches": int8["launches"],
            "tpu": {k: probe[k] for k in ("jaccard_mean", "jaccard_p10",
                                          "jaccard_min", "metrics_bf16",
                                          "metrics_int8")}}
    misses = []
    if abs(line["jaccard_mean"] - probe["jaccard_mean"]) > BOUNDS["jaccard"]:
        misses.append(f"(ii) Jaccard mean {line['jaccard_mean']} against "
                      f"{probe['jaccard_mean']}")
    for k, want in probe["metrics_int8"].items():
        if abs(int8["metrics"][k] - want) > \
                BOUNDS["int8_accuracy"][k] + 1e-12:
            misses.append(f"(ii) int8 {k} {int8['metrics'][k]} against "
                          f"{want}")
    line["misses"] = misses
    return line


# ----------------------------------------------------------------- resume
def resume_misses(conf, rows: List[dict], rec: dict) -> List[str]:
    """Bound (iii) for each resumed epoch's train and test lines."""
    misses = []
    tasks = conf.task_list
    worst = {t.name: max(r[f"{t.name}_loss"] for k, r in rec.items()
                         if k != "probe" and k[0] == "train")
             for t in tasks}
    for r in rows:
        tpu = rec[r["split"], r["epoch"]]
        where = f"(iii) {r['split']} epoch {r['epoch']}"
        losses = [r[f"{t.name}_loss"] for t in tasks]
        if not np.isfinite(losses).all():
            misses.append(f"{where}: a loss is not finite: {losses}")
        if r["split"] == "train":
            if not abs(r["lr"] - tpu["lr"]) <= BOUNDS["lr_rel"] * tpu["lr"]:
                misses.append(f"{where}: lr {r['lr']!r} against "
                              f"{tpu['lr']!r}")
            for t in tasks:
                bound = BOUNDS["train_loss_factor"] * worst[t.name]
                if r[f"{t.name}_loss"] > bound:
                    misses.append(f"{where}: {t.name} loss "
                                  f"{r[f'{t.name}_loss']} above {bound}")
        else:
            for t in tasks:
                k = f"{t.name}_{t.metric}"
                if abs(r[k] - tpu[k]) > BOUNDS["resume_accuracy"] + 1e-12:
                    misses.append(f"{where}: {k} {r[k]} against {tpu[k]}")
    return misses


def resume(smoke, name: str, train, test, data_dir: str, device,
           epochs: Optional[int] = None, tmp: Optional[str] = None) -> dict:
    """Mode (c): the line, with the resumed epochs' metrics lines."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.utils.checkpoint import save_reference_state
    with tempfile.TemporaryDirectory(dir=tmp) as work:
        ckpt = os.path.join(work, "ckpt")
        metrics = os.path.join(work, "metrics.jsonl")
        conf = file_config(smoke, name, data_dir, resume=True,
                           checkpoint_dir=ckpt, metrics_path=metrics)
        saved = save_reference_state(conf, npz_path(name), ckpt)
        launches = sk.logits.launches
        t0 = time.perf_counter()
        trainer, _, _ = driver.run(conf, "mnist", device,
                                   datasets=(train, test), epochs=epochs)
        _sync(trainer.device)
        seconds = time.perf_counter() - t0
        with open(metrics) as f:
            rows = [json.loads(line) for line in f]
    rec = tpu_records(name)
    steps = math.ceil(len(train) / conf.B)
    return {"mode": "resume", "file": name,
            "from": os.path.basename(saved), "n_epoch": conf.n_epoch,
            "epochs": sorted({r["epoch"] for r in rows}),
            "step": trainer.step, "steps_per_epoch": steps,
            "seconds": seconds, "launches": sk.logits.launches - launches,
            "rows": rows,
            "tpu": [rec[r["split"], r["epoch"]] for r in rows],
            "misses": resume_misses(conf, rows, rec)}


# --------------------------------------------------- (iv) against JAX's CPU
def fp32_twin(trainer):
    """An inference trainer with ``trainer``'s weights computing in fp32
    with fp32 input."""
    from ips_tpu_torch.train.steps import IPSTrainer
    twin = IPSTrainer(trainer.conf.replace(compute_dtype="float32",
                                           input_dtype="float32"),
                      device=trainer.device, init_opt=False)
    twin.model.load_state_dict(trainer.model.state_dict())
    return twin


def near_tie(smoke, trainer, twin, x) -> Optional[dict]:
    """Where the unshuffled selection of one image ``x`` (1, N, ...) parts
    when its candidates are encoded by ``twin`` (fp32) instead of
    ``trainer`` (the kernel scoring both): ``smoke.tie_report``'s first
    differing step, or None."""
    from ips_tpu_torch.models.ips_net import DTYPES
    conf = trainer.conf.replace(shuffle=False)
    model, m32 = trainer.model, twin.model
    # the selection's input, cast as IPSTrainer._select_impl casts it
    xin, x32 = x.to(DTYPES[conf.input_dtype]), x.float()
    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    rows = torch.arange(1, device=x.device)[:, None]

    def other(idx, e, ok):
        emb = m32.encode(x32[rows, idx]).float()
        if twin.pos_table is not None:
            emb = emb + twin.pos_table[idx]
        return m32.scores(emb, ok)
    return smoke.tie_report(torch, model, conf, trainer.pos_table, xin,
                            mask, None, lambda i: model.encode(xin[rows, i]),
                            other)


def calibrated_flips(conf, jax_file: dict, port_cpu: dict) -> Dict[str, int]:
    """Per task, the prediction flips the CPU calibration showed: the
    larger of the JAX package's eval in the run's dtype against its fp32
    eval (rounding alone) and the port's CPU eval against JAX's."""
    run = jax_file["run"]["predictions"]
    a = flips(conf, run, jax_file["fp32"]["predictions"])
    b = flips(conf, port_cpu["predictions"], run)
    return {k: max(a[k], b[k]) for k in a}


def is_near_tie(rep: Optional[dict]) -> bool:
    """A first differing step whose gap at the M-th place lies within
    twice the two scorings' largest difference."""
    return rep is not None and rep["gap_at_M"] <= 2 * rep["max_score_diff"]


def kept_misses(ties: Dict[int, dict], jax_ties: Dict[int, dict],
                kept: Sequence[list]) -> List[str]:
    """Bound (iv)'s kept-set half: an image whose kept set (``kept[i]``,
    sorted) parts from JAX's must part at a near tie on this device's
    side (``ties[i]["near_tie"]``) or on JAX's, and then equal JAX's
    fp32 selection (``jax_ties[i]``: the JAX package's bf16 and fp32
    selections of the image replayed on the CPU, ``near_tie`` at their
    first parting and ``fp32_kept``, by
    ``tests/torch_jax_checkpoints.py near-tie-jax``)."""
    def jax_side(i):
        t = jax_ties.get(i)
        return is_near_tie(t) and t["fp32_kept"] == kept[i]
    return [f"(iv) image {i}'s kept set parts from JAX's away from a "
            f"near tie on the card's side, and from JAX's fp32 selection "
            f"or away from a near tie on JAX's: {t}"
            for i, t in ties.items()
            if not t["near_tie"] and not jax_side(i)]


def against_jax(smoke, line: dict, jax_file: dict, port_cpu: dict, conf,
                trainer, test, jax_ties: Dict[int, dict]) -> dict:
    """Bound (iv) on the calibration images: the Predictor's kept sets
    against the JAX Predictor's on the CPU (equal, or parted at a near
    tie: where this device's own selection parts between its compute
    dtype and fp32, or where JAX's does, ``jax_ties``, and the kept set
    is JAX's fp32 one; :func:`kept_misses`) and the eval's prediction flips against JAX's
    eval, per task, within the calibrated count
    (:func:`calibrated_flips`)."""
    cal = calibrated_flips(conf, jax_file, port_cpu)
    served = line["predictor"]
    n = len(served["kept"])
    want = jax_file["predictor"]["kept"][:n]
    differ = [i for i in range(n) if served["kept"][i] != want[i]]
    ties = {}
    twin = fp32_twin(trainer) if differ else None
    for i in differ:
        item = test[i]
        x = trainer.densify(item["input_idx"][None], item["input_val"][None],
                            item["img_hw"])
        with torch.inference_mode():
            rep = near_tie(smoke, trainer, twin, x)
        ties[i] = {"swapped": len(set(want[i]) - set(served["kept"][i])),
                   "report": rep, "near_tie": is_near_tie(rep),
                   "jax": jax_ties.get(i)}
    got = flips(conf, line["predictions"],
                jax_file["run"]["predictions"])
    misses = kept_misses(ties, jax_ties, served["kept"])
    misses += [f"(iv) {k}: {v} prediction flips against JAX's eval, "
               f"calibrated {cal[k]}" for k, v in got.items() if v > cal[k]]
    return {"images": n, "kept_equal": n - len(differ), "kept_differ": ties,
            "flips": got, "calibrated_flips": cal, "misses": misses}


def jax_near_ties(path: str) -> Dict[str, Dict[int, dict]]:
    """``near-tie-jax``'s file: per file, each image's first parting of
    the JAX package's bf16 and fp32 selections, by image."""
    with open(path) as f:
        return {name: {int(i): t for i, t in res["parted"].items()}
                for name, res in json.load(f).items()}


# -------------------------------------------------------------------- CLI
def emit(line: dict, out: str, card: str) -> None:
    line = dict(line, card=card)
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(text + "\n")


def main(argv=None) -> int:
    from ips_tpu_torch.scripts.init_study import open_store
    from ips_tpu_torch.utils.device import fp32_matmuls, resolve_device
    fp32_matmuls()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=("eval", "int8", "resume", "import"))
    p.add_argument("--store", default="",
                   help="the shipped store's directory (written if absent)")
    p.add_argument("--files", default="mnist150_e150,mnist40_e44",
                   help="eval: the files, comma-separated")
    p.add_argument("--file", default="mnist150_e100",
                   help="resume and import: the train state")
    p.add_argument("--images", type=int, default=None,
                   help="eval: the first this many test images only")
    p.add_argument("--against", default="",
                   help="eval: the JAX package's calibration file; hold "
                        "each image against it (bound (iv))")
    p.add_argument("--calibration", default="",
                   help="eval --against: the port's CPU lines on the same "
                        "images, which calibrate the prediction flips")
    p.add_argument("--jax-ties", default=os.path.join(
                       TRAINED, "calibration", "near_tie_jax.json"),
                   help="eval --against: where the JAX package's own bf16 "
                        "and fp32 selections part (near-tie-jax)")
    p.add_argument("--epochs", type=int, default=None,
                   help="resume: epochs to train (default: to n_epoch)")
    p.add_argument("--checkpoint-dir", default="",
                   help="import: where to write epoch_<n>.pt")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    p.add_argument("--out", default="", help="append the lines here")
    a = p.parse_args(argv)
    smoke = chip_smoke()
    device = resolve_device(a.device)
    card = card_name() if device.type == "cuda" else "cpu"
    if a.mode == "import":
        from ips_tpu_torch.utils.checkpoint import save_reference_state
        if not a.checkpoint_dir:
            p.error("import needs --checkpoint-dir")
        path = save_reference_state(file_config(smoke, a.file, ""),
                                    npz_path(a.file), a.checkpoint_dir)
        print(json.dumps({"file": a.file, "wrote": path}), flush=True)
        return 0
    store = a.store
    conf = file_config(smoke, "mnist150_e150", store)
    train, test = open_store(smoke, "full", conf)
    misses = []
    if a.mode == "eval":
        sub = First(test, a.images)
        jax_cal, port_cpu, jax_ties = {}, {}, {}
        if a.against:
            with open(a.against) as f:
                jax_cal = json.load(f)
            with open(a.calibration) as f:
                port_cpu = {r["file"]: r for r in map(json.loads, f)}
            jax_ties = jax_near_ties(a.jax_ties)
        for name in a.files.split(","):
            line = eval_file(smoke, name, sub, store, device,
                             predictor=True)
            if name in jax_cal:
                fconf = file_config(smoke, name, store)
                tr = trainer_from(fconf, name, device)
                line["against_jax"] = against_jax(
                    smoke, line, jax_cal[name], port_cpu[name], fconf, tr,
                    sub, jax_ties.get(name, {}))
                line["misses"] += line["against_jax"]["misses"]
            misses += line["misses"]
            emit(line, a.out, card)
    elif a.mode == "int8":
        line = int8_probe(smoke, test, store, device)
        misses += line["misses"]
        emit(line, a.out, card)
    else:
        line = resume(smoke, a.file, train, test, store, device, a.epochs)
        misses += line["misses"]
        emit(line, a.out, card)
    for m in misses:
        print(f"missed: {m}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
