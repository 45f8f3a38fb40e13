"""Serving traffic of megapixel MNIST: a pool of ``pool`` test images
(``mnist_images`` over the test digits), densified into float32 patches
on the host once, and ``batches`` request batches of ``batch`` images
each drawn from the pool without repeats; a closed loop sends them in an
order drawn from the seed.

Parameters: pool, batches, batch, width, height, n_noise, patch."""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.traffic import mnist_images


class Requests:
    def __init__(self, p: dict, seed: int):
        q = dict(p, train=False, n_images=p["pool"])
        images = mnist_images.make_images(q, seed, 1)
        hw, patch = (p["height"], p["width"]), (p["patch"], p["patch"])
        pool = np.stack([mnist_images.dense_patches(im, hw, patch)
                         for im in images])
        rng = np.random.default_rng([seed, 1])
        self.batches: List[np.ndarray] = [
            np.ascontiguousarray(pool[rng.choice(len(pool), p["batch"],
                                                 replace=False)])
            for _ in range(p["batches"])]
        self._rng = np.random.default_rng([seed, 2])

    def next_batch(self) -> int:
        """The index of the next request's batch."""
        return int(self._rng.integers(len(self.batches)))


def make(p: dict, seed: int, workdir: str, conf: dict) -> Requests:
    return Requests(p, seed)
