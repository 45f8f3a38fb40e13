"""Training traffic of CAMELYON16 end to end: ``tile_slides`` held in host
memory, read by the program's slide dataset, and for the reference each
slide's tiles padded to its bucket with their validity.

Parameters: n_slides, min_tiles, max_tiles, tile, pool, shift."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.traffic import tile_slides


def buckets(max_n: int, M: int, I: int) -> List[int]:
    """The padding ladder M, M+I, M+2I, M+4I, ... up to max_n."""
    out, k = [M], 1
    while out[-1] < max_n:
        out.append(M + k * I)
        k *= 2
    return out


class Slides:
    def __init__(self, p: dict, seed: int, conf: dict):
        self.slides = tile_slides.make_slides(p, seed)
        self.names = sorted(self.slides)
        self.ladder = buckets(max(len(t) for t, _ in self.slides.values()),
                              conf["M"], conf["I"])
        self.conf_updates = {}

    def dataset(self, conf):
        from ips_tpu_torch.data.camelyon.patches import CamelyonPatches
        return CamelyonPatches(conf, train=True, slides=self.slides)

    def rows(self, rows: List[int], device):
        """(tiles (B, N, ph, pw, 3) uint8 padded to the bucket, valid
        (B, N), labels) of the slides ``rows``."""
        n = max(len(self.slides[self.names[i]][0]) for i in rows)
        N = next(b for b in self.ladder if b >= n)
        tiles = np.zeros((len(rows), N) + self.slides[self.names[0]][0]
                         .shape[1:], np.uint8)
        valid = np.zeros((len(rows), N), bool)
        labels = []
        for b, i in enumerate(rows):
            t, label = self.slides[self.names[i]]
            tiles[b, :len(t)] = t
            valid[b, :len(t)] = True
            labels.append(label)
        lab = torch.tensor(labels, device=device)
        return (torch.from_numpy(tiles).to(device),
                torch.from_numpy(valid).to(device),
                {"metastases": lab})


def make(p: dict, seed: int, workdir: str, conf: dict) -> Slides:
    return Slides(p, seed, conf)
