"""Megapixel MNIST images from a seed: a frozen copy of the task's sample
maker (Bergner et al., arXiv:2210.13007; reference ``megapixel_mnist``
generator), over the 1797 8x8 digits that scikit-learn ships
(``digits8x8.npz`` beside this file, upsampled to 28x28) and line-scribble
noise sprites.

Each image is H x W, float32 in [0, 1], held sparse as (flat indices,
values): 3 digits of a target class and 2 of other classes at
non-overlapping random positions, over ``n_noise`` noise sprites, with
the labels majority, max, top and multi (multi-hot). Images are made in
blocks, block ``b`` from ``default_rng([seed, b])`` after the noise bank
from ``default_rng(seed)``, so a store is the same whatever the number of
worker processes.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Dict, List, Optional, Tuple

import numpy as np

DIGIT = 28
DIGITS_8X8 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits8x8.npz")
BLOCK = 64


def digit_bank(train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n, 28, 28) in [0, 1], labels): scikit-learn's digits,
    each pixel a 3x3 block, padded by 2; 80% of them (a fixed split) for
    training images, the rest for test images."""
    with np.load(DIGITS_8X8) as d:
        images, labels = d["images"], d["labels"]
    x = (images / 16.0).astype(np.float32)
    x = np.kron(x, np.ones((1, 3, 3), np.float32))
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))
    order = np.random.default_rng(1234).permutation(len(x))
    cut = int(0.8 * len(x))
    sel = order[:cut] if train else order[cut:]
    return x[sel], labels[sel]


def noise_bank(rng: np.random.Generator, n_noise: int) -> np.ndarray:
    """Line-scribble sprites: two random lines each, some flipped."""
    angles = np.tan(rng.random(n_noise) * np.pi / 2.5)
    A = np.zeros((n_noise, DIGIT, DIGIT), np.float32)
    for i in range(n_noise):
        m = min(27.49, 27.49 / max(angles[i], 1e-6))
        x = np.linspace(0, m, 56)
        y = np.clip(angles[i] * x, 0, 27.49)
        A[i, np.round(x).astype(int), np.round(y).astype(int)] = 1.0
    B = A.copy()
    rng.shuffle(B)
    flip_x = rng.random(n_noise) < 0.33
    flip_y = rng.random(n_noise) < 0.33
    B[flip_x] = np.flip(B[flip_x], 2)
    B[flip_y] = np.flip(B[flip_y], 1)
    noise = ((A + B) > 0).astype(np.float32)
    noise *= (rng.random((n_noise, DIGIT, DIGIT)).astype(np.float32) * 0.2
              + 0.8)
    return noise


def _positions(rng: np.random.Generator, n: int, H: int, W: int):
    """n positions with pairwise L-inf distance of at least 28."""
    out: list = []
    for _ in range(n):
        while True:
            pos = np.round(rng.random(2) * [H - DIGIT, W - DIGIT]).astype(int)
            if not out:
                break
            d = np.abs(np.asarray(out) - pos[None])
            if not np.logical_and(d[:, 0] < DIGIT, d[:, 1] < DIGIT).any():
                break
        out.append(pos)
    return np.asarray(out)


def make_image(rng, digits, labels, W: int, H: int,
               noise: Optional[np.ndarray], n_noise: int) -> Dict:
    target = int(rng.integers(0, 10))
    pos_pool = np.flatnonzero(labels == target)
    neg_pool = np.flatnonzero(labels != target)
    chosen = np.concatenate([rng.choice(pos_pool, 3), rng.choice(neg_pool, 2)])
    chosen_labels = labels[chosen]
    positions = _positions(rng, 5, H, W)
    img = np.zeros((H, W), np.float32)
    if noise is not None:
        npos = (rng.random((n_noise, 2)) * [H - 2 * DIGIT, W - 2 * DIGIT]
                + DIGIT).astype(int)
        pat = rng.integers(0, len(noise), n_noise)
        for (py, px), pi in zip(npos, pat):
            img[py:py + DIGIT, px:px + DIGIT] = noise[pi]
    for (py, px), di in zip(positions, chosen):
        img[py:py + DIGIT, px:px + DIGIT] = digits[di]
    flat = img.ravel()
    nz = np.flatnonzero(flat)
    multi = np.zeros(10, np.float32)
    multi[np.unique(chosen_labels)] = 1.0
    return {"input": (nz, flat[nz]),
            "majority": np.int64(target),
            "max": np.int64(chosen_labels.max()),
            "top": np.int64(chosen_labels[np.argmin(positions[:, 0])]),
            "multi": multi}


def _block(seed: int, block: int, n: int, p: dict) -> List[Dict]:
    digits, labels = digit_bank(p["train"])
    noise = noise_bank(np.random.default_rng(seed), p["n_noise"])
    rng = np.random.default_rng([seed, block])
    return [make_image(rng, digits, labels, p["width"], p["height"], noise,
                       p["n_noise"]) for _ in range(n)]


def make_images(p: dict, seed: int, workers: int = 1) -> List[Dict]:
    """``p["n_images"]`` images of ``p["height"]`` x ``p["width"]`` with
    ``p["n_noise"]`` noise sprites; ``workers`` spawned processes."""
    n = p["n_images"]
    blocks = [(b, min(BLOCK, n - b * BLOCK)) for b in range(-(-n // BLOCK))]
    if workers <= 1:
        parts = [_block(seed, b, k, p) for b, k in blocks]
    else:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) \
                as pool:
            parts = list(pool.map(_block, [seed] * len(blocks),
                                  [b for b, _ in blocks],
                                  [k for _, k in blocks],
                                  [p] * len(blocks)))
    return [s for part in parts for s in part]


def write_store(out_dir: str, images: List[Dict], p: dict, seed: int) -> None:
    """The store a megapixel MNIST dataset reads: ``parameters.json`` and
    ``train.npy`` (an object array of the per-image dicts)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "parameters.json"), "w") as f:
        json.dump({"n_train": len(images), "n_test": 0, "width": p["width"],
                   "height": p["height"], "noise": True,
                   "n_noise": p["n_noise"], "seed": seed,
                   "digit_source": "sklearn"}, f)
    np.save(os.path.join(out_dir, "train.npy"),
            np.array(images, dtype=object), allow_pickle=True)


def dense_patches(image: Dict, hw: Tuple[int, int],
                  patch: Tuple[int, int]) -> np.ndarray:
    """(N, ph, pw, 1) float32 patches of one sparse image, row-major."""
    H, W = hw
    ph, pw = patch
    img = np.zeros(H * W, np.float32)
    idx, val = image["input"]
    img[idx] = val
    return np.ascontiguousarray(
        img.reshape(H // ph, ph, W // pw, pw).transpose(0, 2, 1, 3)
        .reshape(-1, ph, pw, 1))
