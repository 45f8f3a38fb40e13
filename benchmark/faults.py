"""Faults planted underneath the timed path: each must make ``correct``
come out false. ``plant(obj)`` breaks the program (``obj`` is the
trainer or the Predictor that the driver built) and returns what undoes
it. ``benchmark/calibrate.py`` reads them on the card at the cells' own
size, and ``tests/test_bench_faults.py`` on the CPU at a tiny size; the
benchmark's own runs never plant them."""

from __future__ import annotations

from typing import Callable


def half_batch(obj) -> Callable[[], None]:
    """The training losses over the first half of the batch only, the
    mean taken over it."""
    import ips_tpu_torch.train.steps as steps
    full = steps.compute_task_losses

    def half(conf, preds, labels, weights, w_sum=None):
        w = weights.clone()
        w[w.shape[0] // 2:] = 0
        return full(conf, preds, labels, w, w_sum)

    steps.compute_task_losses = half
    return lambda: setattr(steps, "compute_task_losses", full)


def state_unchanged(trainer) -> Callable[[], None]:
    """An optimizer step that returns the state unchanged."""
    trainer.opt.step = lambda *a, **kw: None
    return lambda: None


def scores_ignored(trainer) -> Callable[[], None]:
    """Selection that ranks every patch alike: the scorer's output
    replaced by zeros, so the kept set is whatever the ties leave."""
    import torch
    fns = trainer._enc_score_fns

    def ignoring():
        encode, score = fns()
        return encode, lambda *a, **kw: torch.zeros_like(score(*a, **kw))

    trainer._enc_score_fns = ignoring
    return lambda: None


def answer_altered(predictor) -> Callable[[], None]:
    """The first image's first task answered with certainty for the class
    the program ranked last."""
    import numpy as np
    predict = predictor.predict

    def altered(*a, **kw):
        out = predict(*a, **kw)
        t = next(k for k in out if k != "selected_idx")
        p = out[t][0]
        out[t][0] = np.eye(len(p), dtype=p.dtype)[int(np.argmin(p))]
        return out

    predictor.predict = altered
    return lambda: None


# the faults each kind of cell can have, read on the card by calibrate.py
# (a state left unchanged reads 1 on the change and needs no run there)
BY_DRIVER = {"train": {"half_batch": half_batch},
             "serve": {"answer": answer_altered}}
STREAMING = {"scores_ignored": scores_ignored}
