"""How ``correct`` is decided: the plain reference (``reference/ips.py``)
works out again, from the same inputs and initial weights, what the
timed path produced, and the numbers below are held to the limits in the
cell's workload file.

Training: the first three optimizer steps that set-up drove through the
window's own call. Per step the loss and the predictions; the first
gradient, read from the optimizer's first moment after step one; the
parameters' change after step three. Norms are compared leaf by leaf,
the gap between the program's norm and the reference's over the larger
of the reference's norm of that leaf and of the median leaf.

Where the program selects through its public streaming selection
(camelyon_e2e), the reference also judges the program's kept patches of
every compared loader batch, and then trains on them: ``sel_lift_gap``
is the share of the reference's own selection gain (its kept set's mean
saliency above the batch's mean, in its saliency of every valid patch
scored together) that the program's kept set loses, pooled over the
compared batches. Identical tiles score alike, so a choice among tied
patches costs nothing; a selection that ignores the scores reads about
1.

Serving: a sample of the finished requests, drawn from the seed. The
kept patches are judged by the reference's saliency of the kept and the
reference's own choice scored together (how far the best patch the
program dropped scores above the worst it kept, over the spread of the
scores), and the probabilities by their widest gap to the reference's
forward over the program's kept patches.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import ips as R

# leaves whose first gradient is below this share of the median leaf's
# move under AdamW by rounding alone and are left out of the change
STILL_LEAF = 1e-3


def _norms(tree: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in tree.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def train_numbers(prog: dict, ref: dict, init: Dict[str, np.ndarray]
                  ) -> Dict[str, float]:
    """The compared numbers between a run of the program (or the control)
    and the reference: ``loss_gap`` (the largest relative gap of a
    step's loss), ``loss1_gap`` (step one's), ``pred_gap`` and
    ``pred1_gap`` (the widest gap of a prediction, over the steps and
    in step one), ``grad_gap`` and ``grad_med_gap`` (the worst
    and the median leaf's gap of first-gradient norms),
    ``grad_diff_med`` (the median leaf's norm of the first gradients'
    difference, over the same norm), ``change_gap`` and
    ``change_med_gap`` (the worst and the median leaf's gap of the norms
    of the parameters' change after the compared steps, over the leaves
    that move)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["losses"], ref["losses"])]
    preds = [max(float(np.max(np.abs(np.asarray(p[k], np.float64)
                                     - np.asarray(r[k], np.float64))))
                 for k in r) for p, r in zip(prog["preds"], ref["preds"])]
    keys = sorted(ref["grad1"])
    g_ref = _norms(ref["grad1"])
    grad = _leaf_gaps(_norms({k: prog["grad1"][k] for k in keys}), g_ref,
                      keys)
    med = float(np.median([g_ref[k] for k in keys]))
    moving = [k for k in keys if g_ref[k] >= STILL_LEAF * med]
    change = _leaf_gaps(
        _norms({k: prog["params3"][k] - init[k] for k in moving}),
        _norms({k: ref["params3"][k] - init[k] for k in moving}), moving)
    med_g = float(np.median([g_ref[k] for k in keys]))
    diff = {k: float(np.linalg.norm(np.asarray(prog["grad1"][k], np.float64)
                                    - np.asarray(ref["grad1"][k], np.float64)))
            / max(g_ref[k], med_g, 1e-30) for k in keys}
    out = {"loss_gap": max(gaps), "loss1_gap": gaps[0],
           "pred_gap": max(preds), "pred1_gap": preds[0],
           "grad_gap": max(grad.values()),
           "grad_med_gap": float(np.median(list(grad.values()))),
           "grad_diff_med": float(np.median(list(diff.values()))),
           "change_gap": max(change.values()),
           "change_med_gap": float(np.median(list(change.values())))}
    if "sel_lift" in ref:
        lost, gain = ref["sel_lift"]
        out["sel_lift_gap"] = lost / max(gain, 1e-300)
    return out


def worst_leaves(prog: dict, ref: dict, init: Dict[str, np.ndarray],
                 top: int = 3) -> Dict[str, List]:
    """The leaves with the largest first-gradient and change gaps."""
    keys = sorted(ref["grad1"])
    g = _leaf_gaps(_norms({k: prog["grad1"][k] for k in keys}),
                   _norms(ref["grad1"]), keys)
    c = _leaf_gaps(_norms({k: prog["params3"][k] - init[k] for k in keys}),
                   _norms({k: ref["params3"][k] - init[k] for k in keys}),
                   keys)
    return {"grad": sorted(g.items(), key=lambda kv: -kv[1])[:top],
            "change": sorted(c.items(), key=lambda kv: -kv[1])[:top]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: (value, limit)}); a number that is missing or
    not finite fails."""
    checks = {k: (numbers.get(k, float("nan")), limits[k]) for k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks


# ------------------------------------------------------------ training
def reference_train(conf: dict, data, steps: List[List[int]], epoch: int,
                    steps_per_epoch: int, init: Dict[str, np.ndarray],
                    device, lowp: bool = False,
                    follow: Optional[List[np.ndarray]] = None) -> dict:
    """The reference's first ``len(steps)`` optimizer steps. ``steps[k]``
    lists the rows of each loader batch of step k in order; ``data``
    gives a row's patches, validity and labels (the traffic's ``rows``).
    Every loader batch selects with a generator seeded by its place in
    the epoch; a step of one loader batch trains with that same
    generator after its selection draw, a step of several with a fresh
    one (the last batch's seed folded with 1). With ``follow`` (the kept
    indices the program chose for each loader batch) the reference
    judges that choice against its own (``sel_lift``: the gain lost and
    the gain, summed over the batches; see ``selection_lift``) and trains
    on it, as it follows a served model's tokens."""
    params = {k: torch.from_numpy(np.array(v, np.float32)).to(device)
              for k, v in init.items()}
    ref = R.RefIPS(conf, params, lowp=lowp)
    base = R.train_base_seed(conf["seed"], epoch)
    r = conf["B"] // conf["B_seq"]
    out = {"losses": [], "preds": []}
    for k, step_rows in enumerate(steps):
        kept, idxs, labels, gen = [], [], [], None
        for j, rows in enumerate(step_rows):
            it = k * r + j
            gen = torch.Generator(device=device).manual_seed(
                R.fold_seed(base, it))
            patches, valid, lab = data.rows(rows, device)
            perm = R.permutation(gen, len(rows), valid.shape[1], valid,
                                 conf["shuffle"])
            idx, _ = ref.select(patches, perm, valid)
            out.setdefault("kept", []).append(idx.cpu().numpy())
            if follow is not None:
                theirs = follow[k * r + j]
                lost, gain = selection_lift(
                    ref.saliency(patches, valid).double().cpu().numpy(),
                    valid.cpu().numpy(), out["kept"][-1], theirs)
                was = out.get("sel_lift", (0.0, 0.0))
                out["sel_lift"] = (was[0] + lost, was[1] + gain)
                idx = torch.from_numpy(theirs).to(device).long()
            b = torch.arange(len(rows), device=device)[:, None]
            kept.append(patches[b, idx])
            idxs.append(idx)
            labels.append(lab)
            del patches
        if r > 1:
            gen = torch.Generator(device=device).manual_seed(
                R.fold_seed(R.fold_seed(base, k * r + r - 1), 1))
        lab = {t: torch.cat([x[t] for x in labels]) for t in labels[0]}
        mem = torch.cat(kept)
        lr = R.warmup_cosine_lr(epoch * steps_per_epoch + k * r + r,
                                steps_per_epoch, conf["n_epoch"],
                                conf["n_epoch_warmup"], conf["lr"])
        loss, _, preds, grads = ref.train_step(
            mem, torch.cat(idxs), lab, torch.ones(mem.shape[0],
                                                  device=device),
            gen, lr, conf.get("grad_encode_chunk", 0))
        out["losses"].append(float(loss))
        out["preds"].append({t: v.cpu().numpy() for t, v in preds.items()})
        if k == 0:
            out["grad1"] = {n: g.cpu().numpy() for n, g in grads.items()}
        del mem, kept
    out["params3"] = {n: v.cpu().numpy() for n, v in ref.P.items()
                      if n.startswith("params/")}
    return out


def selection_lift(sal: np.ndarray, valid: np.ndarray, own: np.ndarray,
                   theirs: np.ndarray):
    """(gain lost, gain) summed over the rows: the gain is the mean
    saliency ``sal`` (B, N) of the reference's own kept set ``own``
    (B, M) above the mean over the row's valid patches, and the loss is
    how far the mean over ``theirs`` lies below that of ``own``. A kept
    index that is out of range or not valid scores 0."""
    lost = gain = 0.0
    N = sal.shape[1]
    for b in range(sal.shape[0]):
        t = np.asarray(theirs[b]).astype(np.int64)
        inside = (t >= 0) & (t < N)
        s_t = np.where(inside, sal[b][np.clip(t, 0, N - 1)], 0.0)
        s_t = np.where(inside & valid[b][np.clip(t, 0, N - 1)], s_t, 0.0)
        mine = float(sal[b][own[b]].mean())
        gain += mine - float(sal[b][valid[b]].mean())
        lost += mine - float(s_t.mean())
    return lost, gain


# ------------------------------------------------------------- serving
def selection_gap(ref: R.RefIPS, patches: torch.Tensor, kept: np.ndarray,
                  own: np.ndarray) -> float:
    """How far the best patch that ``kept`` (B, M) dropped from the
    reference's own choice ``own`` scores above the worst patch it kept,
    in the reference's saliency of the two sets scored together, over
    the spread of those scores; the largest over the rows (0 where the
    two agree)."""
    gap = 0.0
    for b in range(kept.shape[0]):
        p, o = set(kept[b].tolist()), set(own[b].tolist())
        if p == o:
            continue
        union = np.array(sorted(p | o))
        u = torch.from_numpy(union).to(patches.device)[None]
        s = ref.set_scores(patches[b:b + 1], u,
                           torch.ones_like(u, dtype=torch.bool))[0]
        s = s.double().cpu().numpy()
        pos = {v: i for i, v in enumerate(union.tolist())}
        dropped = max(s[pos[v]] for v in o - p)
        worst = min(s[pos[v]] for v in p - o)
        spread = float(s.max() - s.min())
        gap = max(gap, float(max(0.0, dropped - worst) / max(spread, 1e-30)))
    return gap


def serve_numbers(conf: dict, ref: R.RefIPS, patches: torch.Tensor,
                  kept: np.ndarray, probs: Dict[str, np.ndarray]
                  ) -> Dict[str, float]:
    """{sel_gap, prob_gap} of one served batch: ``kept`` (B, M) the
    program's kept indices, ``probs`` its probabilities."""
    dev = patches.device
    B, N = patches.shape[:2]
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    own, _ = ref.select(patches, R.permutation(None, B, N, valid, False),
                        valid)
    sel = selection_gap(ref, patches, kept, own.cpu().numpy())
    ref_probs = ref.forward_eval(patches,
                                 torch.from_numpy(kept).to(dev).long())
    prob = max(float(np.max(np.abs(ref_probs[t].double().cpu().numpy()
                                   - np.asarray(probs[t], np.float64))))
               for t in ref_probs)
    return {"sel_gap": sel, "prob_gap": prob}


def reference_serve(conf: dict, ref: R.RefIPS, patches: torch.Tensor
                    ) -> Dict[str, np.ndarray]:
    """The reference put in the program's place: its own kept indices
    and probabilities for one batch (the control's answers)."""
    B, N = patches.shape[:2]
    valid = torch.ones((B, N), dtype=torch.bool, device=patches.device)
    idx, _ = ref.select(patches, R.permutation(None, B, N, valid, False),
                        valid)
    probs = ref.forward_eval(patches, idx)
    return {"kept": idx.cpu().numpy(),
            "probs": {t: v.cpu().numpy() for t, v in probs.items()}}


def worst(values: List[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """Each number's largest reading over several compared units."""
    if not values:
        return None
    return {k: max(v[k] for v in values) for k in values[0]}
