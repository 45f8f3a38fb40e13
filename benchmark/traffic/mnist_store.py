"""Training traffic of megapixel MNIST: a store of ``n_images`` images
(``mnist_images``) written under the run's temporary directory, read by
the program's dataset, and the same images densified for the reference.

Parameters: n_images, width, height, n_noise, workers (processes that
make the images)."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.traffic import mnist_images


class Store:
    def __init__(self, p: dict, seed: int, workdir: str):
        self.p = dict(p, train=True)
        self.images = mnist_images.make_images(self.p, seed,
                                               p.get("workers", 1))
        self.dir = os.path.join(workdir, "mnist_store")
        mnist_images.write_store(self.dir, self.images, self.p, seed)
        self.conf_updates = {"data_dir": self.dir}

    def dataset(self, conf):
        from ips_tpu_torch.data.mnist import MegapixelMNIST
        return MegapixelMNIST(conf, train=True)

    def rows(self, rows: List[int], device):
        """(patches (B, N, ph, pw, 1) fp32, valid (B, N), labels) of the
        images ``rows``, densified on ``device``."""
        H, W = self.p["height"], self.p["width"]
        ph = pw = self.p["patch"]
        img = torch.zeros((len(rows), H * W), device=device)
        for b, i in enumerate(rows):
            idx, val = self.images[i]["input"]
            img[b, torch.from_numpy(np.asarray(idx)).to(device)] = \
                torch.from_numpy(np.asarray(val, np.float32)).to(device)
        patches = (img.view(len(rows), H // ph, ph, W // pw, pw)
                   .permute(0, 1, 3, 2, 4)
                   .reshape(len(rows), -1, ph, pw, 1))
        valid = torch.ones(patches.shape[:2], dtype=torch.bool,
                           device=device)
        labels: Dict[str, torch.Tensor] = {}
        for key in ("majority", "max", "top", "multi"):
            labels[key] = torch.from_numpy(np.stack(
                [np.asarray(self.images[i][key]) for i in rows])).to(device)
        return patches, valid, labels


def make(p: dict, seed: int, workdir: str, conf: dict) -> Store:
    return Store(p, seed, workdir)
