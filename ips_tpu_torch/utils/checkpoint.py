"""Training checkpoints with ``torch.save`` (counterpart of
ips_tpu/utils/checkpoint.py, which keeps them with orbax).

One file per epoch, ``epoch_<n>.pt``, holding the model's state dict
(running statistics included), AdamW's state dict, the trainer's step
counter and the epoch; the newest ``max_to_keep`` are kept.
:func:`save_reference_state` writes the JAX package's train state (a
flat ``.npz``, :func:`ips_tpu_torch.weights.load_flat_train_state`) as
such a file, so that ``resume`` continues the reference's run.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The saved epochs, oldest first."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, trainer, epoch: int):
        payload = {
            "model": trainer.model.state_dict(),
            "opt": (trainer.opt.state_dict() if trainer.opt is not None
                    else None),
            "step": trainer.step,
            "epoch": epoch,
        }
        # written whole, then renamed: a cut run never leaves a torn file
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, trainer) -> Optional[int]:
        """Load the newest checkpoint into ``trainer``; its epoch, or None
        when there is none. An inference-only trainer (``init_opt=False``)
        drops the saved optimizer state."""
        saved = self.epochs()
        if not saved:
            return None
        # to the CPU first: load_state_dict moves each tensor to its
        # parameter's device, and AdamW keeps its step counts on the CPU
        payload = torch.load(self._path(saved[-1]), map_location="cpu",
                             weights_only=True)
        trainer.model.load_state_dict(payload["model"], strict=True)
        if trainer.opt is not None:
            if payload["opt"] is None:
                raise ValueError(
                    f"{self._path(saved[-1])} holds no optimizer state "
                    "(saved by an inference-only trainer)")
            trainer.opt.load_state_dict(payload["opt"])
        trainer.step = int(payload["step"])
        return int(payload["epoch"])


def save_reference_state(conf, npz: str, directory: str) -> str:
    """Write the reference train state in ``npz`` as ``directory``'s
    ``epoch_<n>.pt``, ``n`` the epochs it has trained, through a trainer
    of ``conf`` on the CPU; returns the file's path. The driver resumed
    on ``directory`` (``resume=true checkpoint_dir=<directory>``) then
    trains epoch ``n`` first, as the reference's resumed run does."""
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch.weights import load_flat_train_state
    trainer = IPSTrainer(conf, device="cpu")
    epoch = load_flat_train_state(trainer, npz)
    mgr = CheckpointManager(directory)
    mgr.save(trainer, epoch)
    return mgr._path(epoch)
