"""Training driver CLI (counterpart of ips_tpu/main.py).

    python -m ips_tpu_torch.main --dataset mnist \\
        --config config/mnist_config.yml data_dir=<dir> B=8 n_epoch=5
    python -m ips_tpu_torch.main --dataset traffic \\
        --config config/traffic_config.yml data_dir=<dir> ...
    python -m ips_tpu_torch.main --dataset camelyon \\
        --config config/camelyon_config.yml data_dir=<dir> ...
    python -m ips_tpu_torch.main --dataset camelyon_e2e \\
        --config config/camelyon_e2e_config.yml data_dir=<dir> ...
    python -m ips_tpu_torch.main --config cfg.json --device cpu ...

``--config`` takes YAML or JSON (``.json``). Any config key can be
overridden as ``key=value``, parsed as a YAML scalar as in the JAX CLI;
without pyyaml only a JSON config with no overrides loads. Checkpoints
(``checkpoint_dir``, ``checkpoint_every``, ``resume``), per-epoch metrics
as JSON lines (``metrics_path``), per-step loss lines (``log_every``) and
a ``torch.profiler`` trace of the first epoch (``profile_dir``) work as in
the JAX package. The run is on ``cuda`` unless ``--device`` says
otherwise; without a card that raises.

Several processes (``multihost=true``) train one model with data and
context parallelism (``ips_tpu_torch.parallel``): each rank is one
device, ``mesh_data x mesh_patch`` of them, e.g. two ranks sharing one
card (gloo; NCCL refuses two ranks on one device)::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m ips_tpu_torch.main --dataset mnist --config cfg.json

with ``multihost: true``, ``cpu_collectives: gloo`` and ``mesh_data: 2``
in ``cfg.json`` (a 1 x 1 mesh takes ``mesh_data = world //
mesh_patch``). Rank 0 alone prints, writes metrics and saves
checkpoints; on resume every rank loads the checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ips_tpu_torch.config import Config, load_config
from ips_tpu_torch.parallel import distributed as pdist
from ips_tpu_torch.train.loop import (check_sharded_slots, evaluate,
                                      sharded_slots, train_one_epoch)
from ips_tpu_torch.train.metrics import MetricsLogger
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils.device import fp32_matmuls
from ips_tpu_torch.utils.profiling import EfficiencyTracker

DATASETS = ("mnist", "traffic", "camelyon", "camelyon_e2e")


def build_datasets(conf: Config, dataset: str):
    if dataset == "mnist":
        from ips_tpu_torch.data.mnist import MegapixelMNIST
        return (MegapixelMNIST(conf, train=True),
                MegapixelMNIST(conf, train=False))
    if dataset == "traffic":
        from ips_tpu_torch.data.traffic import TrafficSigns
        return (TrafficSigns(conf, train=True),
                TrafficSigns(conf, train=False))
    if dataset == "camelyon":
        from ips_tpu_torch.data.camelyon.dataset import CamelyonFeatures
        return (CamelyonFeatures(conf, train=True),
                CamelyonFeatures(conf, train=False))
    if dataset == "camelyon_e2e":
        from ips_tpu_torch.data.camelyon.patches import CamelyonPatches
        return (CamelyonPatches(conf, train=True),
                CamelyonPatches(conf, train=False))
    raise ValueError(f"unknown dataset {dataset!r}")


def build_loaders(conf: Config, train_data, test_data, data_rank: int = 0,
                  n_data: int = 1):
    """Seeded loaders of B_seq rows a batch; data rank ``data_rank`` of
    ``n_data`` loads its B_seq / n_data rows of each. With B_seq < B over
    several data ranks the loaders run at optimizer-batch granularity
    (B rows), so that a rank's B / n_data contiguous rows are its
    r / n_data slots, and a dataset with buckets always buckets: an
    optimizer batch has one shape (``ips_tpu/main.py:49-84``)."""
    from ips_tpu_torch.data.loader import DataLoader
    slots = sharded_slots(conf, n_data)
    batch_size = conf.B if slots else conf.B_seq

    def bucket_fn(data):
        # variable-N datasets batch > 1 rows by grouping same-bucket items
        if (conf.B_seq > 1 or slots) and hasattr(data, "bucket_of"):
            return data.bucket_of
        return None

    train_loader = DataLoader(train_data, batch_size=batch_size,
                              shuffle=True, num_workers=conf.n_worker,
                              seed=conf.seed,
                              bucket_fn=bucket_fn(train_data),
                              process_index=data_rank, process_count=n_data)
    test_loader = DataLoader(test_data, batch_size=batch_size, shuffle=False,
                             num_workers=conf.n_worker,
                             bucket_fn=bucket_fn(test_data),
                             process_index=data_rank, process_count=n_data)
    return train_loader, test_loader


def resolve_mesh(conf: Config) -> Config:
    """A run of several processes with a 1 x 1 mesh in its config takes
    ``mesh_data = world // mesh_patch`` (``ips_tpu/main.py:94-95``)."""
    world = pdist.world_size()
    if world > 1 and conf.mesh_data * conf.mesh_patch == 1:
        return conf.replace(mesh_data=world // conf.mesh_patch)
    return conf


def build_trainer(conf: Config,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> IPSTrainer:
    """The one-device trainer, or ``ShardedIPSTrainer`` over the
    config's mesh when it is larger than 1 x 1 or the world has more than
    one rank; weights drawn from ``conf.seed``."""
    conf = resolve_mesh(conf)
    if conf.mesh_data * conf.mesh_patch > 1 or pdist.world_size() > 1:
        from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
        return ShardedIPSTrainer(conf, device=device)
    return IPSTrainer(conf, device=device)


def _check_multihost_path(conf: Config) -> Config:
    """Fail before any step where a run of several processes cannot go;
    returns the config with its mesh resolved. B_seq < B over several
    data ranks needs r = B / B_seq to divide over them and dense batches
    (``ips_tpu/main.py:102-130``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not conf.multihost:
        raise ValueError(
            f"WORLD_SIZE={world} in the environment but multihost is "
            "false: each process would train the whole model alone; set "
            "multihost=true to train one model over the ranks")
    conf = resolve_mesh(conf)
    check_sharded_slots(conf, conf.mesh_data)
    return conf


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run(conf: Config, dataset: str,
        device: Optional[Union[str, torch.device]] = None,
        datasets: Optional[Tuple[Any, Any]] = None):
    """Train ``conf.n_epoch`` epochs with an eval after each; returns
    (trainer, train logger, test logger). ``datasets`` (train, test)
    replaces the ones ``dataset`` names, e.g. images or slides held in
    memory (``TrafficSigns(conf, images=...)`` for traffic,
    ``CamelyonFeatures(conf, slides=...)``, or
    ``CamelyonPatches(conf, slides=...)`` for camelyon_e2e). With
    ``multihost`` the process joins its group first (see the module
    docstring)."""
    if pdist.initialize_from_config(conf, device):
        device = pdist.local_device(device)
    conf = _check_multihost_path(conf)
    main_process = pdist.is_main_process()
    np.random.seed(conf.seed)
    if main_process:
        print("Used config:")
        print(conf.pretty(), flush=True)

    train_data, test_data = datasets or build_datasets(conf, dataset)
    train_loader, test_loader = build_loaders(
        conf, train_data, test_data, pdist.rank() // conf.mesh_patch,
        conf.mesh_data)
    trainer = build_trainer(conf, device)

    ckpt_mgr = None
    start_epoch = 0
    last_saved = -1
    if conf.checkpoint_dir:
        from ips_tpu_torch.utils.checkpoint import CheckpointManager
        ckpt_mgr = CheckpointManager(conf.checkpoint_dir)
        if conf.resume:
            start_epoch = ckpt_mgr.restore(trainer) or 0
            # the shuffle stream as an unbroken run left it
            train_loader.skip_epochs(start_epoch)

    log_train = MetricsLogger(conf.task_list)
    log_test = MetricsLogger(conf.task_list)
    tracker = EfficiencyTracker(conf, trainer.device)

    for epoch in range(start_epoch, conf.n_epoch):
        profiling = bool(conf.profile_dir) and epoch == start_epoch
        with (_profiler(trainer.device) if profiling
              else contextlib.nullcontext()) as prof:
            t_epoch = time.perf_counter()
            lr = train_one_epoch(trainer, train_loader, epoch, log_train,
                                 conf, tracker)
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            t_epoch = time.perf_counter() - t_epoch
        if profiling and main_process:
            os.makedirs(conf.profile_dir, exist_ok=True)
            path = os.path.join(conf.profile_dir, f"epoch_{epoch}.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace written to {path}", flush=True)
        # every rank accumulates the same global metrics; one reports them
        log_train.compute_metric()
        if main_process:
            log_train.print_stats(epoch, train=True, lr=lr)
            print(f"epoch wall: {t_epoch:.2f}s", flush=True)
            if conf.metrics_path:
                log_train.write_jsonl(conf.metrics_path, epoch, "train",
                                      lr=lr, train_seconds=t_epoch)

        evaluate(trainer, test_loader, log_test, conf)
        log_test.compute_metric()
        if main_process:
            log_test.print_stats(epoch, train=False)
            if conf.metrics_path:
                log_test.write_jsonl(conf.metrics_path, epoch, "test")

        if ckpt_mgr and main_process and conf.checkpoint_every and \
                (epoch + 1) % conf.checkpoint_every == 0:
            ckpt_mgr.save(trainer, epoch + 1)
            last_saved = epoch + 1

    if (ckpt_mgr and main_process and last_saved != conf.n_epoch
            and start_epoch < conf.n_epoch):
        # a resumed run that had nothing left to train already has it
        ckpt_mgr.save(trainer, conf.n_epoch)
    return trainer, log_train, log_test


def main(argv=None):
    fp32_matmuls()
    p = argparse.ArgumentParser(description="ips_tpu_torch training driver")
    p.add_argument("--dataset", default="mnist", choices=DATASETS)
    p.add_argument("--config", default=None,
                   help="config path, YAML or JSON (.json); without "
                        "pyyaml, as on a machine with only torch and "
                        "numpy, only JSON loads (default: "
                        "config/<dataset>_config.yml)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    p.add_argument("overrides", nargs="*",
                   help="config overrides as key=value (YAML scalars; "
                        "needs pyyaml, so without it put every key in a "
                        "JSON config)")
    a = p.parse_args(argv)
    cfg_path = a.config or os.path.join("config", f"{a.dataset}_config.yml")
    conf = load_config(cfg_path, a.overrides)
    owned = not torch.distributed.is_initialized()
    try:
        return run(conf, a.dataset, a.device)
    finally:
        # the process group this run joined ends with it
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
