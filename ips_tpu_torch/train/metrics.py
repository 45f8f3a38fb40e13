"""Metrics accumulation and reporting (counterpart of
ips_tpu/train/metrics.py).

  * accuracy: argmax over softmax outputs, exact-match rate
  * multilabel_accuracy: threshold 0.5, all-labels-exact-match rate
  * auc: ROC AUC on raw sigmoid outputs (sklearn when available, otherwise
    a tie-aware Mann-Whitney implementation that matches roc_auc_score)
  * per-epoch mean of per-step losses, printed and written as JSON lines
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable

import numpy as np

try:  # sklearn is optional; the fallback matches its results
    from sklearn.metrics import accuracy_score, roc_auc_score
    _HAVE_SKLEARN = True
except ImportError:  # the card machine has no sklearn
    _HAVE_SKLEARN = False


def _accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    if _HAVE_SKLEARN:
        return float(accuracy_score(y_true, y_pred))
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    if _HAVE_SKLEARN:
        return float(roc_auc_score(y_true, y_score))
    # Mann-Whitney U with midranks (tie-aware), equals roc_auc_score.
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = int((~y_true).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class present")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


class MetricsLogger:
    """Accumulates per-step task losses/preds/labels; computes epoch metrics."""

    def __init__(self, tasks: Iterable):
        # tasks: iterable of TaskConfig (or dicts with name/metric).
        self.tasks = [t if hasattr(t, "name") else type("T", (), t)()
                      for t in tasks]
        self.losses_it: Dict[str, list] = defaultdict(list)
        self.losses_epoch: Dict[str, list] = defaultdict(list)
        self.y_preds: Dict[str, list] = defaultdict(list)
        self.y_trues: Dict[str, list] = defaultdict(list)
        self.metrics: Dict[str, list] = defaultdict(list)

    def update(self, losses: Dict[str, float], preds: Dict[str, np.ndarray],
               labels: Dict[str, np.ndarray],
               weights: np.ndarray | None = None):
        """Record one optimizer step; ``weights`` > 0 marks the valid rows
        of a padded partial batch."""
        for t in self.tasks:
            name, metric = t.name, t.metric
            self.losses_it[name].append(float(losses[name]))
            p = np.asarray(preds[name])
            y = np.asarray(labels[name])
            if weights is not None:
                keep = np.asarray(weights) > 0
                p, y = p[keep], y[keep]
            if metric == "accuracy":
                p = np.argmax(p, axis=-1)
            self.y_preds[name].extend(np.asarray(p).tolist())
            self.y_trues[name].extend(np.asarray(y).tolist())

    def compute_metric(self):
        for t in self.tasks:
            name, metric = t.name, t.metric
            self.losses_epoch[name].append(
                float(np.mean(self.losses_it[name])) if self.losses_it[name]
                else float("nan"))
            y_pred = np.array(self.y_preds[name])
            y_true = np.array(self.y_trues[name])
            if metric == "accuracy":
                val = _accuracy(y_true, y_pred)
            elif metric == "multilabel_accuracy":
                hard = np.where(y_pred >= 0.5, 1.0, 0.0)
                val = float(np.all(hard == y_true, axis=-1).sum()
                            / max(hard.shape[0], 1))
            elif metric == "auc":
                y_score = np.atleast_1d(np.squeeze(y_pred))
                if len(np.unique(y_true)) < 2:
                    # AUC undefined with one class present (tiny epochs);
                    # report nan instead of crashing mid-training.
                    print(f"[metrics] AUC for task {name!r} undefined: "
                          "only one class present this epoch", flush=True)
                    val = float("nan")
                else:
                    val = _auc(y_true, y_score)
            else:
                raise ValueError(f"unknown metric {metric!r}")
            self.metrics[name].append(val)
            self.losses_it[name] = []
            self.y_preds[name] = []
            self.y_trues[name] = []

    def print_stats(self, epoch: int, train: bool, **kwargs):
        """Print the MOST RECENT epoch's stats, labeled ``epoch + 1``.

        ``epoch`` is only a label (so resumed runs print the true epoch
        number); values always come from the latest compute_metric().
        """
        s = ("Train" if train else "Test") + f" Epoch: {epoch + 1} \n"
        avg_loss = 0.0
        for t in self.tasks:
            mean_loss = self.losses_epoch[t.name][-1]
            metric = self.metrics[t.name][-1]
            avg_loss += mean_loss
            s += (f"task: {t.name}, mean loss: {mean_loss:.5f}, "
                  f"{t.metric}: {metric:.5f}, ")
        avg_loss /= max(len(self.tasks), 1)
        s += f"avg. loss over tasks: {avg_loss:.5f}"
        for k, v in kwargs.items():
            s += f", {k}: {v}"
        print(s + "\n", flush=True)

    def latest(self) -> Dict[str, float]:
        return {t.name: self.metrics[t.name][-1] for t in self.tasks
                if self.metrics[t.name]}

    def write_jsonl(self, path: str, epoch: int, split: str, **extra):
        """Append the latest epoch's stats as one JSON line."""
        record = {"epoch": epoch, "split": split}
        for t in self.tasks:
            record[f"{t.name}_loss"] = self.losses_epoch[t.name][-1]
            record[f"{t.name}_{t.metric}"] = self.metrics[t.name][-1]
        record.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")
