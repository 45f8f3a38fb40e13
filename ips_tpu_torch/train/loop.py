"""Epoch loops: loader batch -> selection -> optimizer step (counterpart of
ips_tpu/train/loop.py, single process).

Each schedule of the JAX package's ``train_one_epoch`` (``loop.py:955``)
and ``evaluate`` (``:1294``) is here, with the same batches, the same lr
per step (``warmup_cosine_lr(data_it + 1, ...)``) and the same order:

  * dense, B_seq == B: ``fused_multi_step`` over K = ``steps_per_dispatch``
    batches, ``fused_step`` for a group of one (``_train_epoch_pipelined``
    :922, ``_train_epoch_grouped`` :551; eval :1083);
  * sparse, B_seq == B: ``fused_sparse_multi_step`` / ``fused_sparse_step``
    likewise (``_train_epoch_sparse_grouped`` :732; eval :1131); a batch
    that arrives dense takes the select-assemble-train step (eval: the
    dense fused eval) alone (``_prep_sparse`` :582);
  * B_seq < B with K > 1: r = B / B_seq loader batches to one
    ``fused_assembled_*`` step, K of them grouped (``:768``, eval
    :1179);
  * otherwise the select-assemble-train schedule with ``BatchAssembler``
    (:48), which also takes a ragged group of r and the epoch's last
    partial optimizer batch;
  * streaming (``eager: false``), any B_seq: each loader batch stays in
    host memory and goes through ``select_streaming`` into the assembler,
    a ``train_step`` once B rows are in or at the epoch's end
    (:1041-1060); eval selects with ``return_emb`` when
    ``_reuse_eval_emb()`` and runs ``eval_from_emb_step`` on the buffer's
    embeddings, else ``eval_step`` on the kept patches (:1344-1372).

A partial last loader batch is zero-padded to B_seq with row weight 0
(``_pad_loader_batch``), so it adds nothing to selection, loss or
metrics. A trailing group shorter than K runs as single steps, so no
fake step touches BatchNorm statistics or weight decay. The JAX
package keeps separate K = 1 loops for its asynchronous staging, which
the port does not have: here K = 1 is the grouped driver with groups of
one.

Randomness: every step's ``torch.Generator`` is seeded with
``fold_seed(base, it)``, a pure function of the epoch's base seed
``seed * 1_000_003 + epoch`` (eval: ``seed * 7_000_003 + 1``) and the
loader batch index, as the JAX package folds ``it`` into
``PRNGKey(base)``; the select-assemble-train step draws its dropout from
``fold_seed(that seed, 1)``. So the grouped and the single-step
schedules make the same updates, and a resumed run repeats an unbroken
one. The streams themselves differ from ``jax.random``'s.

Loader batches are moved to the device ahead of use, at most
``prefetch_depth`` in flight (at least K + 1 for a grouped schedule and
r * K + 1 for an assembled one, whose group is stacked on the device),
from pinned host memory with ``non_blocking=True``.

Under data parallelism (``parallel.ips_sharded.ShardedIPSTrainer``) each
rank's loader yields its B_seq / n_dp rows of every batch, and the
labels and row weights kept for the metrics are gathered to the global
batch (``host_allgather``, where ``ips_tpu/train/loop.py`` gathers
them), so every rank accumulates the same global metrics. With B_seq <
B the loader runs at optimizer-batch granularity instead
(``main.build_loaders``): each rank's B / n_dp rows of an optimizer
batch are its r / n_dp slots of B_seq rows, and every schedule is the
JAX package's multi-host one (``_epoch_assembled_mh`` :486,
``_prep_assembled_mh`` :382, ``_flush_assembled_mh`` :437): global slot
g = it * r + j selects with ``fold_seed(base, g)``, the step trains
with the last global slot's seed folded with 1 at the lr of the last
slot's B_seq-unit step, so every rank reaches one process's
select-assemble-train updates. Eager batches take the fused assembled
steps in groups of K (``_epoch_slots``); streamed ones are selected slot
by slot on the rank and trained once (``_epoch_slots_streamed``).
The sharded loader drops a bucket's last partial optimizer batch, as
JAX's does.
"""

from __future__ import annotations

import contextlib
from collections import deque
from functools import partial
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ips_tpu_torch.config import Config
from ips_tpu_torch.parallel.distributed import host_allgather, is_main_process
from ips_tpu_torch.train.schedule import warmup_cosine_lr
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils.profiling import EfficiencyTracker, span

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A generator seed for (``seed``, ``data``): splitmix64 of their
    combination, cut to 63 bits. Pure, so a step's randomness depends on
    nothing but its place in the run."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def train_base_seed(seed: int, epoch: int) -> int:
    return seed * 1_000_003 + epoch


def eval_base_seed(seed: int) -> int:
    return seed * 7_000_003 + 1


def _n_data(trainer) -> int:
    return getattr(trainer, "n_dp", 1)


def sharded_slots(conf: Config, n_data: int) -> bool:
    """B_seq < B over several data ranks: the loader yields a rank's
    B / n_data rows of each optimizer batch, its r / n_data slots."""
    return conf.B_seq < conf.B and n_data > 1


def check_sharded_slots(conf: Config, n_data: int) -> None:
    """Raise before any step where B_seq < B cannot run over ``n_data``
    data ranks: r = B / B_seq must divide over them, and sparse batches
    have no assembled form (``ips_tpu/main.py:102-130``)."""
    if not sharded_slots(conf, n_data):
        return
    r = conf.B // conf.B_seq
    if r % n_data:
        raise ValueError(
            f"multi-host assembled path (B_seq < B) needs r = B/B_seq "
            f"divisible by the data mesh axis — got r={r}, "
            f"data={n_data}; raise B or lower B_seq/mesh size")
    if conf.sparse_input:
        raise ValueError(
            "multi-host training with B_seq < B requires dense batches "
            "(sparse_input=false): the assembled path takes (r, B_seq, N, "
            f"...) slots — got B_seq={conf.B_seq}, B={conf.B}, "
            f"sparse_input={conf.sparse_input}")


def _global_host(trainer, labels, row_weights):
    """The global batch's labels and row weights, for the metrics: a
    data-parallel trainer's steps return the global predictions."""
    if _n_data(trainer) == 1:
        return labels, row_weights
    return host_allgather((labels, row_weights), trainer.mesh.data_group,
                          trainer.device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_host(task_losses, preds):
    return ({k: float(_np(v)) for k, v in task_losses.items()},
            {k: _np(v) for k, v in preds.items()})


def _host(res):
    loss, task_losses, preds = res
    return (_np(loss), {k: _np(v) for k, v in task_losses.items()},
            {k: _np(v) for k, v in preds.items()})


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _lr(conf: Config, epoch: int, steps_per_epoch: int, it: int) -> float:
    return warmup_cosine_lr(epoch * steps_per_epoch + it + 1,
                            steps_per_epoch, conf.n_epoch,
                            conf.n_epoch_warmup, conf.lr)


def _labels_from_batch(conf: Config, batch: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    labels = {}
    for t in conf.task_list:
        arr = np.asarray(batch[t.name])
        if t.metric == "multilabel_accuracy":
            labels[t.name] = np.asarray(arr, np.float32)
        else:
            labels[t.name] = np.asarray(arr, np.int32)
    return labels


def _batch_mask(batch: Dict[str, np.ndarray], B: int, N: int) -> np.ndarray:
    if "mask" in batch:
        return np.asarray(batch["mask"], bool)
    return np.ones((B, N), dtype=bool)


def _maybe_log_step(conf: Config, data_it: int, loss, lr: float):
    """Optional per-step stdout logging (conf.log_every; waits for the
    device), by rank 0 of a run of several processes."""
    if (conf.log_every and (data_it + 1) % conf.log_every == 0
            and is_main_process()):
        print(f"step {data_it + 1}: loss {float(_np(loss)):.5f}, "
              f"lr {lr:.3g}", flush=True)


def _pad_loader_batch(conf: Config, batch: Dict[str, np.ndarray],
                      rows: Optional[int] = None):
    """Zero-pad a partial last loader batch up to ``rows`` (B_seq, or a
    data rank's B_seq / n_dp share); returns (batch, row_weights). Padded
    rows carry weight 0 and an all-False patch mask, so they never reach
    selection, loss or metrics."""
    ref_key = "input" if "input" in batch else "input_idx"
    n = batch[ref_key].shape[0]
    rows = conf.B_seq if rows is None else rows
    weights = np.ones(n, np.float32)
    if n == rows:
        return batch, weights
    pad = rows - n
    N = batch["input"].shape[1] if "input" in batch else conf.N
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.concatenate(
            [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
    if "mask" not in batch:
        out["mask"] = np.concatenate(
            [np.ones((n, N), bool), np.zeros((pad, N), bool)])
    return out, np.concatenate([weights, np.zeros(pad, np.float32)])


class BatchAssembler:
    """Accumulates B_seq-row selections into one (B, M, ...) train batch,
    zero-padded to B with weight-0 rows; ``rows`` in place of B for a
    data rank's share of the batch."""

    def __init__(self, conf: Config, rows: Optional[int] = None):
        self.conf = conf
        self.rows = conf.B if rows is None else rows
        self.reset()

    def reset(self):
        self._patches, self._pos, self._masks = [], [], []
        self._weights: list = []
        self._labels: Dict[str, list] = {t.name: []
                                         for t in self.conf.task_list}
        self.n_prep = 0

    def add(self, mem_patch, mem_pos, mem_mask, labels, row_weights):
        self._patches.append(mem_patch)
        if mem_pos is not None:
            self._pos.append(mem_pos)
        self._masks.append(mem_mask)
        self._weights.append(np.asarray(row_weights, np.float32))
        for k, v in labels.items():
            self._labels[k].append(v)
        self.n_prep += mem_patch.shape[0]

    @property
    def full(self) -> bool:
        return self.n_prep >= self.rows

    def take(self):
        """(patch, pos, mask, labels, weights), each padded to B rows."""
        B, n = self.rows, self.n_prep

        def pad(xs):
            x = torch.cat(xs)
            if n == B:
                return x
            return torch.cat([x, x.new_zeros((B - n,) + x.shape[1:])])

        patch = pad(self._patches)
        pos = pad(self._pos) if self._pos else None
        mask = pad(self._masks)
        labels = {k: pad(v) for k, v in self._labels.items()}
        weights = torch.from_numpy(np.concatenate(
            self._weights + [np.zeros(B - n, np.float32)])).to(patch.device)
        self.reset()
        return patch, pos, mask, labels, weights


class _Prepped(NamedTuple):
    """One loader batch on the device, with the host copies of its labels
    and row weights kept for the metrics."""
    it: int
    payload: dict
    labels: dict
    row_weights: np.ndarray
    seed: int


def _prefetched(iterable, prepare, depth: int, before=None):
    """Yield prepare(item), keeping up to ``depth`` prepared items (their
    copies to the device started) ahead of the consumer; ``before(item)``,
    if given, runs between each ``next()`` and that item's preparation.
    Each ``next()`` on ``iterable`` and its preparation is a ``data.next``
    span."""
    buf = deque()
    it = iter(iterable)
    while True:
        with span("data.next"):
            item = next(it, _END)
            if item is not _END:
                if before is not None:
                    before(item)
                buf.append(prepare(item))
        if item is _END:
            break
        if len(buf) >= max(depth, 1):
            yield buf.popleft()
    while buf:
        yield buf.popleft()


_END = object()


def _local_rows(trainer, conf: Config) -> int:
    """This rank's share of a loader batch's B_seq rows."""
    return conf.B_seq // _n_data(trainer)


def _put_common(trainer, labels, row_weights) -> dict:
    put = partial(_to_device, device=trainer.device)
    return {"labels": {k: put(v) for k, v in labels.items()},
            "w": put(row_weights)}


def _prep_fused(trainer: IPSTrainer, conf: Config, base: int, ib) -> _Prepped:
    """A dense loader batch on the device; a sparse one is densified there
    (the dense schedules' form of a sparse batch)."""
    it, batch = ib
    batch, row_weights = _pad_loader_batch(conf, batch,
                                           _local_rows(trainer, conf))
    labels = _labels_from_batch(conf, batch)
    payload = _put_common(trainer, labels, row_weights)
    labels, row_weights = _global_host(trainer, labels, row_weights)
    if "input" in batch:
        B_seq, N = batch["input"].shape[:2]
        payload["patches"] = _to_device(batch["input"], trainer.device)
    else:
        B_seq, N = batch["input_idx"].shape[0], conf.N
        payload["patches"] = trainer.densify(
            _to_device(batch["input_idx"], trainer.device),
            _to_device(batch["input_val"], trainer.device),
            tuple(int(v) for v in batch["img_hw"][0]))
    payload["mask"] = _to_device(_batch_mask(batch, B_seq, N), trainer.device)
    payload["kind"] = "dense"
    return _Prepped(it, payload, labels, row_weights, fold_seed(base, it))


def _prep_host(trainer: IPSTrainer, conf: Config, base: int,
               ib) -> _Prepped:
    """A loader batch for streaming selection: the patches stay in host
    memory, the labels and row weights go to the device."""
    it, batch = ib
    batch, row_weights = _pad_loader_batch(conf, batch,
                                           _local_rows(trainer, conf))
    labels = _labels_from_batch(conf, batch)
    payload = _put_common(trainer, labels, row_weights)
    payload.update(patches=batch["input"], mask=batch.get("mask"),
                   kind="host")
    return _Prepped(it, payload, labels, row_weights, fold_seed(base, it))


def _prep_sparse(trainer: IPSTrainer, conf: Config, base: int,
                 ib) -> _Prepped:
    """A sparse loader batch on the device as (idx, val) pairs; a batch
    that arrives dense takes the dense form (kind 'dense')."""
    it, batch = ib
    if "input_idx" not in batch:
        return _prep_fused(trainer, conf, base, ib)
    batch, row_weights = _pad_loader_batch(conf, batch,
                                           _local_rows(trainer, conf))
    labels = _labels_from_batch(conf, batch)
    put = partial(_to_device, device=trainer.device)
    payload = _put_common(trainer, labels, row_weights)
    labels, row_weights = _global_host(trainer, labels, row_weights)
    payload.update(
        idx=put(batch["input_idx"]), val=put(batch["input_val"]),
        mask=put(_batch_mask(batch, batch["input_idx"].shape[0], conf.N)),
        hw=tuple(int(v) for v in batch["img_hw"][0]), kind="sparse")
    return _Prepped(it, payload, labels, row_weights, fold_seed(base, it))


def _stack(group, key):
    return torch.stack([p.payload[key] for p in group])


def _stack_labels(group):
    return {k: torch.stack([p.payload["labels"][k] for p in group])
            for k in group[0].payload["labels"]}


def _log_step_metrics(trainer, logger, task_losses, preds, labels,
                      weights):
    """A step's metrics from its (global) outputs and this rank's labels
    and row weights on the device, gathered to the global batch."""
    tl, pr = _to_host(task_losses, preds)
    lab, w = _global_host(trainer, {k: _np(v) for k, v in labels.items()},
                          _np(weights))
    logger.update(tl, pr, lab, weights=w)


def _log_train_step(trainer, conf, tracker, logger, epoch, data_it,
                    is_last, lr, loss, task_losses, preds, labels, weights):
    """Shared post-step bookkeeping: tracker, optional step log, metrics."""
    if tracker is not None:
        tracker.stop(epoch, data_it, is_last)
    _maybe_log_step(conf, data_it, loss, lr)
    _log_step_metrics(trainer, logger, task_losses, preds, labels, weights)


def _select_into(trainer: IPSTrainer, assembler: BatchAssembler,
                 p: _Prepped, reuse_emb: bool = False):
    """Select one loader batch with its own generator, into the
    assembler. A batch in host memory streams; with ``reuse_emb`` its
    buffer's embeddings take the place of the kept patches."""
    q = p.payload
    gen = trainer.new_generator(p.seed)
    if q["kind"] != "host":
        payload, mem_pos, _, mem_mask = trainer.select(q["patches"],
                                                       q["mask"], gen)
    elif reuse_emb:
        _, mem_pos, _, mem_mask, payload = trainer.select_streaming(
            q["patches"], q["mask"], gen, return_emb=True)
    else:
        payload, mem_pos, _, mem_mask = trainer.select_streaming(
            q["patches"], q["mask"], gen)
    assembler.add(payload, mem_pos, mem_mask, q["labels"], p.row_weights)


def _assembler_train(trainer, conf, assembler, logger, tracker, epoch,
                     steps_per_epoch, last: _Prepped, is_last: bool) -> float:
    """The optimizer step over what the assembler holds; its lr and
    dropout generator come from the last loader batch in it."""
    patch, pos, mmask, lab, weights = assembler.take()
    lr = _lr(conf, epoch, steps_per_epoch, last.it)
    loss, task_losses, preds = trainer.train_step(
        patch, pos, mmask, lab, weights,
        trainer.new_generator(fold_seed(last.seed, 1)), lr)
    _log_train_step(trainer, conf, tracker, logger, epoch,
                    epoch * steps_per_epoch + last.it, is_last, lr, loss,
                    task_losses, preds, lab, weights)
    return lr


def _opt_rows(trainer, conf: Config) -> int:
    """This rank's rows of an optimizer batch."""
    return conf.B // _n_data(trainer)


def _grouped_epoch(loader, epoch, logger, conf, steps_per_epoch, prep,
                   dispatch_multi, dispatch_single, group_key, K,
                   tracker=None, train=True):
    """Shared driver of the B_seq == B schedules: a full group of K > 1
    prepared batches that agree on ``group_key`` goes to
    ``dispatch_multi``; a group of one (K = 1), a shorter or a mixed group
    runs its batches through ``dispatch_single`` in order, each timed by
    ``tracker``."""
    last_lr = 0.0

    def log_step(p, lr, loss, tl, pr):
        if train:
            _maybe_log_step(conf, epoch * steps_per_epoch + p.it, loss, lr)
        logger.update(tl, pr, p.labels, weights=p.row_weights)

    def run_group(group):
        nonlocal last_lr
        if train:
            lrs = [_lr(conf, epoch, steps_per_epoch, p.it) for p in group]
            last_lr = lrs[-1]
        else:
            lrs = [None] * len(group)
        if len(group) == K and len({group_key(p) for p in group}) == 1:
            losses, task_losses, preds = _host(dispatch_multi(group, lrs))
            for j, p in enumerate(group):
                log_step(p, lrs[j], losses[j],
                         {k: float(v[j]) for k, v in task_losses.items()},
                         {k: v[j] for k, v in preds.items()})
            return
        for p, lr in zip(group, lrs):
            if tracker is not None:
                tracker.start()
            loss, task_losses, preds = dispatch_single(p, lr)
            if tracker is not None:
                tracker.stop(epoch, epoch * steps_per_epoch + p.it,
                             p.it == steps_per_epoch - 1)
            tl, pr = _to_host(task_losses, preds)
            log_step(p, lr, loss, tl, pr)

    depth = max(conf.prefetch_depth, K + 1) if K > 1 else conf.prefetch_depth
    group = []
    for item in _prefetched(enumerate(loader), prep, depth):
        group.append(item)
        if len(group) == K:
            run_group(group)
            group = []
    if group:
        run_group(group)
    return last_lr


def _dense_key(p):
    return tuple(p.payload["patches"].shape)


def _sparse_group_key(p):
    """Sparse batches group by image size; a dense-degraded batch never
    groups (there is no mixed multi-step)."""
    if p.payload["kind"] == "dense":
        return ("dense", p.it)
    return ("sparse",) + tuple(p.payload["hw"])


# ---------------------------------------------------------------- training
def _train_epoch_grouped(trainer, loader, epoch, logger, conf, base,
                         steps_per_epoch, K, tracker):
    def dispatch_multi(group, lrs):
        return trainer.fused_multi_step(
            _stack(group, "patches"), _stack(group, "mask"),
            _stack_labels(group), _stack(group, "w"),
            [trainer.new_generator(p.seed) for p in group], lrs)

    def dispatch_single(p, lr):
        q = p.payload
        return trainer.fused_step(q["patches"], q["mask"], q["labels"],
                                  q["w"], trainer.new_generator(p.seed), lr)

    return _grouped_epoch(loader, epoch, logger, conf, steps_per_epoch,
                          partial(_prep_fused, trainer, conf, base),
                          dispatch_multi, dispatch_single, _dense_key, K,
                          tracker)


def _sparse_single_step(trainer, p, lr):
    q = p.payload
    if q["kind"] == "dense":
        # a dense batch on the sparse path: the select-assemble-train
        # step (select with the batch's generator, dropout from fold 1)
        with span("train.step"):
            mem_patch, mem_pos, _, mem_mask = trainer.select(
                q["patches"], q["mask"], trainer.new_generator(p.seed))
            return trainer.train_step(
                mem_patch, mem_pos, mem_mask, q["labels"], q["w"],
                trainer.new_generator(fold_seed(p.seed, 1)), lr)
    return trainer.fused_sparse_step(
        q["idx"], q["val"], q["hw"], q["mask"], q["labels"], q["w"],
        trainer.new_generator(p.seed), lr)


def _train_epoch_sparse_grouped(trainer, loader, epoch, logger, conf, base,
                                steps_per_epoch, K, tracker):
    def dispatch_multi(group, lrs):
        return trainer.fused_sparse_multi_step(
            _stack(group, "idx"), _stack(group, "val"),
            group[0].payload["hw"], _stack(group, "mask"),
            _stack_labels(group), _stack(group, "w"),
            [trainer.new_generator(p.seed) for p in group], lrs)

    return _grouped_epoch(loader, epoch, logger, conf, steps_per_epoch,
                          partial(_prep_sparse, trainer, conf, base),
                          dispatch_multi, partial(_sparse_single_step,
                                                  trainer),
                          _sparse_group_key, K, tracker)


def _assembled_item(group, lr=None):
    """r same-shape prepared loader batches as one optimizer batch."""
    return {
        "p": _stack(group, "patches"), "m": _stack(group, "mask"),
        "lab": {k: torch.cat([p.payload["labels"][k] for p in group])
                for k in group[0].payload["labels"]},
        "w": torch.cat([p.payload["w"] for p in group]),
        "seeds": [p.seed for p in group], "lr": lr, "preps": group}


def _assembled_epoch(loader, conf, prep, make_item, flush, legacy):
    """Shared driver for B_seq < B with K > 1: every r loader batches of
    one shape become an item, K items one grouped dispatch (``flush``);
    a mixed-shape r-group and the epoch's last partial optimizer batch
    take the select-assemble schedule (``legacy``), in order."""
    r = conf.B // conf.B_seq
    K = conf.steps_per_dispatch
    pending, group = [], []
    for p in _prefetched(enumerate(loader), prep,
                         max(conf.prefetch_depth, r * K + 1)):
        group.append(p)
        if len(group) < r:
            continue
        if len({_dense_key(q) for q in group}) == 1:
            pending.append(make_item(group))
            if len(pending) == K:
                flush(pending)
                pending = []
        else:
            flush(pending)
            pending = []
            legacy(group)
        group = []
    flush(pending)
    if group:
        legacy(group)


def _train_epoch_assembled(trainer, loader, epoch, logger, conf, base,
                           steps_per_epoch):
    """r = B / B_seq loader batches to one fused_assembled step, K steps a
    group; each loader batch keeps its own selection generator, and the
    train generator and lr come from the optimizer batch's last loader
    batch, as in the select-assemble-train schedule."""
    K = conf.steps_per_dispatch
    last_lr = 0.0
    gen = trainer.new_generator

    def make_item(group):
        return _assembled_item(
            group, _lr(conf, epoch, steps_per_epoch, group[-1].it))

    def log_opt_step(i, loss, task_losses, preds):
        preps = i["preps"]
        _maybe_log_step(conf, epoch * steps_per_epoch + preps[-1].it, loss,
                        i["lr"])
        tl, pr = _to_host(task_losses, preds)
        logger.update(tl, pr,
                      {k: np.concatenate([p.labels[k] for p in preps])
                       for k in preps[0].labels},
                      weights=np.concatenate([p.row_weights for p in preps]))

    def flush(items):
        nonlocal last_lr
        if not items:
            return
        train_gens = [gen(fold_seed(i["preps"][-1].seed, 1)) for i in items]
        if len(items) == K and len({tuple(i["p"].shape) for i in items}) == 1:
            losses, task_losses, preds = _host(
                trainer.fused_assembled_multi_step(
                    torch.stack([i["p"] for i in items]),
                    torch.stack([i["m"] for i in items]),
                    {k: torch.stack([i["lab"][k] for i in items])
                     for k in items[0]["lab"]},
                    torch.stack([i["w"] for i in items]),
                    [[gen(s) for s in i["seeds"]] for i in items],
                    train_gens, [i["lr"] for i in items]))
            for j, i in enumerate(items):
                log_opt_step(i, losses[j],
                             {k: v[j] for k, v in task_losses.items()},
                             {k: v[j] for k, v in preds.items()})
        else:
            for i, tg in zip(items, train_gens):
                log_opt_step(i, *trainer.fused_assembled_step(
                    i["p"], i["m"], i["lab"], i["w"],
                    [gen(s) for s in i["seeds"]], tg, i["lr"]))
        last_lr = items[-1]["lr"]

    def legacy(preps):
        nonlocal last_lr
        assembler = BatchAssembler(conf)
        with span("train.step"):
            for p in preps:
                _select_into(trainer, assembler, p)
            last_lr = _assembler_train(trainer, conf, assembler, logger,
                                       None, epoch, steps_per_epoch,
                                       preps[-1], False)

    _assembled_epoch(loader, conf, partial(_prep_fused, trainer, conf, base),
                     make_item, flush, legacy)
    return last_lr


# ------------------------------------ B_seq < B over several data ranks
class _Slots(NamedTuple):
    """One optimizer batch's slots on this rank: its r / n_dp slots'
    selection seeds, the step's train seed and lr, and the global batch's
    labels and row weights for the metrics."""
    it: int
    payload: dict
    labels: dict
    row_weights: np.ndarray
    seeds: list
    train_seed: int
    lr: float


def _prep_slots(trainer, conf: Config, base: int, epoch: int,
                steps_seq: int, host: bool, ib) -> _Slots:
    """Loader batch ``it`` (this rank's contiguous B / n_dp rows of global
    optimizer batch ``it``) as (r / n_dp, B_seq, N, ...) slots, on the
    device or, for streaming (``host``), in host memory. Global slot
    g = it * r + j is one process's loader batch g: it selects with
    ``fold_seed(base, g)``; the step trains with the last slot's seed
    folded with 1, at the lr of the last slot's B_seq-unit step
    (``_prep_assembled_mh``, ``ips_tpu/train/loop.py:382``)."""
    it, batch = ib
    n_dp, d = _n_data(trainer), trainer.mesh.coords[0]
    r = conf.B // conf.B_seq
    rows = conf.B // n_dp
    x = np.asarray(batch["input"])
    if x.shape[0] != rows:
        # the data-rank-sharded loader drops partial batches
        raise ValueError(f"multi-host assembled: expected {rows} local "
                         f"rows, got {x.shape[0]}")
    r_loc, N = r // n_dp, x.shape[1]
    labels = _labels_from_batch(conf, batch)
    row_weights = np.ones(rows, np.float32)
    mask = _batch_mask(batch, rows, N).reshape(r_loc, conf.B_seq, N)
    x = x.reshape((r_loc, conf.B_seq) + x.shape[1:])
    payload = _put_common(trainer, labels, row_weights)
    if host:
        payload.update(patches=x, mask=mask)
    else:
        payload.update(patches=_to_device(x, trainer.device),
                       mask=_to_device(mask, trainer.device))
    slot0 = it * r + d * r_loc
    labels, row_weights = _global_host(trainer, labels, row_weights)
    return _Slots(it, payload, labels, row_weights,
                  [fold_seed(base, slot0 + j) for j in range(r_loc)],
                  fold_seed(fold_seed(base, it * r + r - 1), 1),
                  _lr(conf, epoch, steps_seq, it * r + r - 1))


def _log_slots(conf, logger, epoch, steps_seq, i: _Slots, loss,
               task_losses, preds, train: bool):
    if train:
        r = conf.B // conf.B_seq
        _maybe_log_step(conf, epoch * steps_seq + (i.it + 1) * r - 1, loss,
                        i.lr)
    tl, pr = _to_host(task_losses, preds)
    logger.update(tl, pr, i.labels, weights=i.row_weights)


def _flush_slots(trainer, conf, logger, items, train: bool, epoch: int,
                 steps_seq: int) -> None:
    """Pending optimizer (or eval) batches: one K-stacked dispatch for a
    full group of one shape, single steps otherwise (a bucket's shape
    changed, or the epoch's tail); ``_flush_assembled_mh`` :437."""
    if not items:
        return
    K, gen = conf.steps_per_dispatch, trainer.new_generator

    def stack(key):
        return torch.stack([i.payload[key] for i in items])

    if (len(items) == K and K > 1
            and len({i.payload["patches"].shape for i in items}) == 1):
        lab = {k: torch.stack([i.payload["labels"][k] for i in items])
               for k in items[0].payload["labels"]}
        sel = [[gen(s) for s in i.seeds] for i in items]
        if train:
            out = trainer.fused_assembled_multi_step(
                stack("patches"), stack("mask"), lab, stack("w"), sel,
                [gen(i.train_seed) for i in items], [i.lr for i in items])
        else:
            out = trainer.fused_assembled_eval_multi_step(
                stack("patches"), stack("mask"), lab, stack("w"), sel)
        losses, task_losses, preds = _host(out)
        for j, i in enumerate(items):
            _log_slots(conf, logger, epoch, steps_seq, i, losses[j],
                       {k: v[j] for k, v in task_losses.items()},
                       {k: v[j] for k, v in preds.items()}, train)
        return
    for i in items:
        q, sel = i.payload, [gen(s) for s in i.seeds]
        if train:
            out = trainer.fused_assembled_step(
                q["patches"], q["mask"], q["labels"], q["w"], sel,
                gen(i.train_seed), i.lr)
        else:
            out = trainer.fused_assembled_eval_step(
                q["patches"], q["mask"], q["labels"], q["w"], sel)
        _log_slots(conf, logger, epoch, steps_seq, i, *out, train)


def _epoch_slots(trainer, loader, epoch, logger, conf, base,
                 train: bool) -> float:
    """Eager B_seq < B over data ranks, train or eval (``_epoch_assembled_mh``
    :486): every loader batch is one optimizer batch; K of one shape make
    one dispatch, and a change of shape flushes early, which keeps the
    order of the updates."""
    K = conf.steps_per_dispatch
    steps_seq = len(loader) * (conf.B // conf.B_seq)
    prep = partial(_prep_slots, trainer, conf, base, epoch, steps_seq,
                   False)
    last_lr, pending = 0.0, []

    def flush():
        nonlocal last_lr, pending
        if pending:
            _flush_slots(trainer, conf, logger, pending, train, epoch,
                         steps_seq)
            last_lr = pending[-1].lr
            pending = []

    for item in _prefetched(enumerate(loader), prep,
                            max(conf.prefetch_depth, K + 1)):
        if (pending and pending[-1].payload["patches"].shape
                != item.payload["patches"].shape):
            flush()
        pending.append(item)
        if len(pending) == K:
            flush()
    flush()
    return last_lr


def _epoch_slots_streamed(trainer, loader, epoch, logger, conf, base,
                          train: bool, tracker=None) -> float:
    """Streaming B_seq < B over data ranks: each rank streams its r / n_dp
    slots with their global slots' generators into an assembler of its
    B / n_dp rows, then one train step (global statistics, loss weight
    and gradient all-reduce) or eval step: one process's
    select-assemble-train schedule with the work split by slot. Eval
    reuses the buffer's embeddings when ``_reuse_eval_emb()``."""
    steps_seq = len(loader) * (conf.B // conf.B_seq)
    reuse = not train and trainer._reuse_eval_emb()
    last_lr = 0.0
    prep = partial(_prep_slots, trainer, conf, base, epoch, steps_seq, True)

    def start(ib):
        # a step's time includes its batch's preparation
        if tracker is not None:
            tracker.start()

    for p in _prefetched(enumerate(loader), prep, 1, start):
        if train:
            with span("train.step"):
                out = trainer.train_step(
                    *_streamed_slots(trainer, conf, p, False),
                    trainer.new_generator(p.train_seed), p.lr)
            last_lr = p.lr
            if tracker is not None:
                tracker.stop(epoch, epoch * steps_seq + (p.it + 1)
                             * (conf.B // conf.B_seq) - 1,
                             p.it == len(loader) - 1)
        else:
            step = trainer.eval_from_emb_step if reuse else trainer.eval_step
            out = step(*_streamed_slots(trainer, conf, p, reuse))
        _log_slots(conf, logger, epoch, steps_seq, p, *out, train)
    return last_lr


def _streamed_slots(trainer, conf, p: _Slots, reuse: bool):
    """The rank's slots of ``p`` streamed with their generators into one
    (patch, pos, mask, labels, weights) batch of its B / n_dp rows; with
    ``reuse`` the buffer's embeddings in place of the patches."""
    q = p.payload
    assembler = BatchAssembler(conf, _opt_rows(trainer, conf))
    for j, seed in enumerate(p.seeds):
        rows = slice(j * conf.B_seq, (j + 1) * conf.B_seq)
        gen = trainer.new_generator(seed)
        if reuse:
            _, mem_pos, _, mem_mask, payload = trainer.select_streaming(
                q["patches"][j], q["mask"][j], gen, return_emb=True)
        else:
            payload, mem_pos, _, mem_mask = trainer.select_streaming(
                q["patches"][j], q["mask"][j], gen)
        assembler.add(payload, mem_pos, mem_mask,
                      {k: v[rows] for k, v in q["labels"].items()},
                      np.ones(conf.B_seq, np.float32))
    return assembler.take()


def _slots_epoch(trainer, loader, epoch, logger, conf, base, train,
                 tracker=None) -> float:
    """The schedule of B_seq < B over data ranks: eager batches take the
    fused assembled steps, streamed ones the rank's select-assemble."""
    check_sharded_slots(conf, _n_data(trainer))
    if conf.eager:
        return _epoch_slots(trainer, loader, epoch, logger, conf, base,
                            train)
    return _epoch_slots_streamed(trainer, loader, epoch, logger, conf, base,
                                 train, tracker)


def train_one_epoch(trainer: IPSTrainer, loader, epoch: int, logger,
                    conf: Config,
                    tracker: Optional[EfficiencyTracker] = None) -> float:
    """One training epoch; returns the last step's lr."""
    with span("train.epoch"):
        return _train_epoch(trainer, loader, epoch, logger, conf, tracker)


def _train_epoch(trainer, loader, epoch, logger, conf, tracker) -> float:
    steps_per_epoch = len(loader)
    base = train_base_seed(conf.seed, epoch)
    tracker = tracker or EfficiencyTracker(conf, trainer.device)
    if sharded_slots(conf, _n_data(trainer)):
        last_lr = _slots_epoch(trainer, loader, epoch, logger, conf, base,
                               True, tracker)
        tracker.finish_epoch(epoch)
        return last_lr
    # track_efficiency keeps the single-step schedules, timed per step
    grouped = conf.steps_per_dispatch > 1 and not conf.track_efficiency
    if conf.eager and conf.B_seq == conf.B:
        # sparse_input chooses the schedule; _prep_sparse sends a batch
        # that arrives dense down the dense one
        epoch_fn = (_train_epoch_sparse_grouped if conf.sparse_input
                    else _train_epoch_grouped)
        last_lr = epoch_fn(trainer, loader, epoch, logger, conf, base,
                           steps_per_epoch,
                           conf.steps_per_dispatch if grouped else 1, tracker)
        tracker.finish_epoch(epoch)
        return last_lr
    if conf.eager and grouped and not conf.sparse_input:
        return _train_epoch_assembled(trainer, loader, epoch, logger, conf,
                                      base, steps_per_epoch)

    # B_seq < B, or streaming: select each loader batch, train once B rows
    # are in
    prep = partial(_prep_fused if conf.eager else _prep_host, trainer, conf,
                   base)
    last_lr = 0.0
    assembler = BatchAssembler(conf, _opt_rows(trainer, conf))

    def start(ib):
        # a step's time includes its first batch's preparation (at depth
        # 1 the assembler holds what the previous batches put in)
        if assembler.n_prep == 0:
            tracker.start()

    # a step's span opens at its first selection and closes after its
    # update, across the loader batches it takes
    with contextlib.ExitStack() as step:
        for p in _prefetched(enumerate(loader), prep, 1, start):
            is_last = p.it == steps_per_epoch - 1
            if assembler.n_prep == 0:
                step.enter_context(span("train.step"))
            _select_into(trainer, assembler, p)
            if assembler.full or is_last:
                last_lr = _assembler_train(trainer, conf, assembler, logger,
                                           tracker, epoch, steps_per_epoch,
                                           p, is_last)
                step.close()
    tracker.finish_epoch(epoch)
    return last_lr


# -------------------------------------------------------------- evaluation
def _eval_fused_single(trainer, p, lr=None):
    q = p.payload
    if q["kind"] == "sparse":
        return trainer.fused_sparse_eval_step(
            q["idx"], q["val"], q["hw"], q["mask"], q["labels"], q["w"],
            trainer.new_generator(p.seed))
    return trainer.fused_eval_step(q["patches"], q["mask"], q["labels"],
                                   q["w"], trainer.new_generator(p.seed))


def _eval_pipelined(trainer, loader, logger, conf, base):
    def dispatch_multi(group, lrs):
        return trainer.fused_eval_multi_step(
            _stack(group, "patches"), _stack(group, "mask"),
            _stack_labels(group), _stack(group, "w"),
            [trainer.new_generator(p.seed) for p in group])

    _grouped_epoch(loader, 0, logger, conf, len(loader),
                   partial(_prep_fused, trainer, conf, base), dispatch_multi,
                   partial(_eval_fused_single, trainer), _dense_key,
                   conf.steps_per_dispatch, train=False)


def _eval_sparse_pipelined(trainer, loader, logger, conf, base):
    def dispatch_multi(group, lrs):
        return trainer.fused_sparse_eval_multi_step(
            _stack(group, "idx"), _stack(group, "val"),
            group[0].payload["hw"], _stack(group, "mask"),
            _stack_labels(group), _stack(group, "w"),
            [trainer.new_generator(p.seed) for p in group])

    _grouped_epoch(loader, 0, logger, conf, len(loader),
                   partial(_prep_sparse, trainer, conf, base), dispatch_multi,
                   partial(_eval_fused_single, trainer), _sparse_group_key,
                   conf.steps_per_dispatch, train=False)


def _eval_assembled_step(trainer, logger, assembler, from_emb=False):
    payload, pos, mmask, lab, weights = assembler.take()
    step = trainer.eval_from_emb_step if from_emb else trainer.eval_step
    _, task_losses, preds = step(payload, pos, mmask, lab, weights)
    _log_step_metrics(trainer, logger, task_losses, preds, lab, weights)


def _eval_assembled(trainer, loader, logger, conf, base):
    """B_seq < B eval with K > 1: r loader batches to one
    fused_assembled eval, K per group; the same selection generators as
    the select-assemble schedule."""
    K = conf.steps_per_dispatch
    gen = trainer.new_generator

    def log_item(i, task_losses, preds):
        preps = i["preps"]
        tl, pr = _to_host(task_losses, preds)
        logger.update(tl, pr,
                      {k: np.concatenate([p.labels[k] for p in preps])
                       for k in preps[0].labels},
                      weights=np.concatenate([p.row_weights for p in preps]))

    def flush(items):
        if not items:
            return
        if len(items) == K and len({tuple(i["p"].shape) for i in items}) == 1:
            _, task_losses, preds = _host(
                trainer.fused_assembled_eval_multi_step(
                    torch.stack([i["p"] for i in items]),
                    torch.stack([i["m"] for i in items]),
                    {k: torch.stack([i["lab"][k] for i in items])
                     for k in items[0]["lab"]},
                    torch.stack([i["w"] for i in items]),
                    [[gen(s) for s in i["seeds"]] for i in items]))
            for j, i in enumerate(items):
                log_item(i, {k: v[j] for k, v in task_losses.items()},
                         {k: v[j] for k, v in preds.items()})
            return
        for i in items:
            _, task_losses, preds = trainer.fused_assembled_eval_step(
                i["p"], i["m"], i["lab"], i["w"],
                [gen(s) for s in i["seeds"]])
            log_item(i, task_losses, preds)

    def legacy(preps):
        assembler = BatchAssembler(conf)
        for p in preps:
            _select_into(trainer, assembler, p)
        _eval_assembled_step(trainer, logger, assembler)

    _assembled_epoch(loader, conf, partial(_prep_fused, trainer, conf, base),
                     _assembled_item, flush, legacy)


def evaluate(trainer: IPSTrainer, loader, logger, conf: Config) -> None:
    """One evaluation pass over ``loader``."""
    steps_per_epoch = len(loader)
    base = eval_base_seed(conf.seed)
    if sharded_slots(conf, _n_data(trainer)):
        _slots_epoch(trainer, loader, 0, logger, conf, base, False)
        return
    if conf.eager and conf.B_seq == conf.B:
        eval_fn = (_eval_sparse_pipelined if conf.sparse_input
                   else _eval_pipelined)
        return eval_fn(trainer, loader, logger, conf, base)
    if conf.eager and conf.steps_per_dispatch > 1 and not conf.sparse_input:
        return _eval_assembled(trainer, loader, logger, conf, base)

    # streaming eval reuses the buffer's embeddings: selection ran the
    # same eval-mode encoder the forward would
    reuse = not conf.eager and trainer._reuse_eval_emb()
    prep = _prep_fused if conf.eager else _prep_host
    assembler = BatchAssembler(conf, _opt_rows(trainer, conf))
    for ib in enumerate(loader):
        _select_into(trainer, assembler, prep(trainer, conf, base, ib),
                     reuse)
        if assembler.full or ib[0] == steps_per_epoch - 1:
            _eval_assembled_step(trainer, logger, assembler, reuse)
