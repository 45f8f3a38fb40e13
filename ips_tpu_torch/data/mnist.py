"""Megapixel MNIST: offline generator CLI + training dataset (counterpart
of ips_tpu/data/mnist.py).

Each sample is a sparse H x W grayscale image holding 5 digits (3 of a
target class + 2 others) at non-overlapping random positions plus n_noise
line-scribble distractors, with four labels:

  majority — the target class (3 of 5 digits)
  max      — the largest digit present
  top      — the topmost digit
  multi    — multi-hot vector of present digits

Storage is the JAX package's, byte for byte for the same seed and digit
source: ``parameters.json`` plus ``train.npy``/``test.npy`` holding
per-sample dicts of sparse ``(indices, values)`` arrays, so a dataset
generated by either package loads in both.

Digit sources (no network is assumed):
  * ``mnist``     — a local ``mnist.npz`` (keras cache format)
  * ``sklearn``   — the 1797 8x8 digits that scikit-learn ships
                    (``load_digits``), upsampled to 28x28; the default
  * ``synthetic`` — procedurally rendered digit glyphs

The ``sklearn`` source needs no scikit-learn: the package carries the
digits in ``digits8x8.npz`` (``images`` uint8 (1797, 8, 8) in 0..16,
``labels`` int64), written once from ``sklearn.datasets.load_digits()``.
They are scikit-learn's copy (BSD-3-Clause) of the test set of the UCI
"Optical Recognition of Handwritten Digits" data (E. Alpaydin and C.
Kaynak, 1998).

    python -m ips_tpu_torch.data.mnist <output_directory>   # 5000 + 1000
    python -m ips_tpu_torch.data.mnist --n_train 128 --n_test 32 \
        --digit_source synthetic <output_directory>
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ips_tpu_torch.data.loader import Dataset
from ips_tpu_torch.native import densify_patchify

DIGIT = 28  # digit sprite side


# --------------------------------------------------------------------------
# digit sources
# --------------------------------------------------------------------------

# 5x7 bitmap font for the synthetic fallback source.
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _synthetic_digits(rng: np.random.Generator, n_per_class: int = 200
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Render jittered glyph variants: (N, 28, 28) float in [0,1], labels."""
    imgs, labels = [], []
    for digit, rows in _FONT.items():
        glyph = np.array([[float(c) for c in r] for r in rows], np.float32)
        for _ in range(n_per_class):
            scale = rng.integers(3, 5)  # 15-20 px wide
            big = np.kron(glyph, np.ones((scale, scale), np.float32))
            h, w = big.shape
            canvas = np.zeros((DIGIT, DIGIT), np.float32)
            oy = rng.integers(0, DIGIT - h + 1)
            ox = rng.integers(0, DIGIT - w + 1)
            canvas[oy:oy + h, ox:ox + w] = big
            canvas *= rng.uniform(0.7, 1.0)
            canvas += rng.normal(0, 0.05, canvas.shape).astype(np.float32)
            imgs.append(np.clip(canvas, 0, 1))
            labels.append(digit)
    order = rng.permutation(len(imgs))
    return np.stack(imgs)[order], np.array(labels)[order]


DIGITS_8X8 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits8x8.npz")


def _sklearn_digits() -> Tuple[np.ndarray, np.ndarray]:
    """``load_digits()`` from the bundled copy, upsampled as the JAX
    package upsamples it (bitwise: the same float64 quotient)."""
    with np.load(DIGITS_8X8) as d:
        images, labels = d["images"], d["labels"]
    x = (images / 16.0).astype(np.float32)          # (N, 8, 8)
    x = np.kron(x, np.ones((1, 3, 3), np.float32))  # (N, 24, 24)
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))         # (N, 28, 28)
    return x, labels


def load_digit_bank(source: str = "sklearn", train: bool = True,
                    mnist_path: Optional[str] = None,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Return (images (N,28,28) in [0,1], labels (N,))."""
    if source == "mnist":
        path = mnist_path or os.path.expanduser(
            "~/.keras/datasets/mnist.npz")
        with np.load(path) as f:
            if train:
                return f["x_train"].astype(np.float32) / 255.0, f["y_train"]
            return f["x_test"].astype(np.float32) / 255.0, f["y_test"]
    if source == "sklearn":
        x, y = _sklearn_digits()
        # deterministic train/test split
        rng = np.random.default_rng(1234)
        order = rng.permutation(len(x))
        cut = int(0.8 * len(x))
        sel = order[:cut] if train else order[cut:]
        return x[sel], y[sel]
    if source == "synthetic":
        rng = np.random.default_rng(seed + (0 if train else 10_000))
        return _synthetic_digits(rng)
    raise ValueError(f"unknown digit source {source!r}")


# --------------------------------------------------------------------------
# generator
# --------------------------------------------------------------------------

def _make_noise_patterns(rng: np.random.Generator, n_noise: int) -> np.ndarray:
    """Line-scribble noise sprites ."""
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


def generate_split(out_dir: str, split: str, n_samples: int, *,
                   width: int, height: int, noise: bool, n_noise: int,
                   seed: int, digit_source: str,
                   mnist_path: Optional[str]) -> None:
    """Write ``<split>.npy`` (``split`` is ``train`` or ``test``) from the
    split's own generator, ``default_rng(seed + is_train)``."""
    is_train = split == "train"
    digits, labels = load_digit_bank(digit_source, train=is_train,
                                     mnist_path=mnist_path, seed=seed)
    rng = np.random.default_rng(seed + int(is_train))
    noise_bank = _make_noise_patterns(rng, n_noise) if noise else None
    data = []
    for _ in range(n_samples):
        data.append(_make_sample(rng, digits, labels, width, height,
                                 noise_bank, n_noise))
    np.save(os.path.join(out_dir, f"{split}.npy"),
            np.array(data, dtype=object), allow_pickle=True)


def _store_splits(out_dir: str, n_train: int = 5000, n_test: int = 1000,
                  width: int = 1500, height: int = 1500, noise: bool = True,
                  n_noise: int = 50, seed: int = 0,
                  digit_source: str = "sklearn",
                  mnist_path: Optional[str] = None):
    """Write parameters.json; returns each split's ``generate_split``
    arguments."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "parameters.json"), "w") as f:
        json.dump({"n_train": n_train, "n_test": n_test, "width": width,
                   "height": height, "noise": noise, "n_noise": n_noise,
                   "seed": seed, "digit_source": digit_source}, f, indent=4)
    kw = dict(width=width, height=height, noise=noise, n_noise=n_noise,
              seed=seed, digit_source=digit_source, mnist_path=mnist_path)
    return [((out_dir, "train", n_train), kw), ((out_dir, "test", n_test), kw)]


def generate_megapixel_mnist(out_dir: str, **kw) -> None:
    """Write parameters.json + train.npy/test.npy. Keywords: n_train
    (5000), n_test (1000), width, height (1500), noise (True), n_noise
    (50), seed (0), digit_source ("sklearn"), mnist_path."""
    for args, split_kw in _store_splits(out_dir, **kw):
        generate_split(*args, **split_kw)


def _timed_split(*args, **kw) -> float:
    t0 = time.perf_counter()
    generate_split(*args, **kw)
    return time.perf_counter() - t0


class SplitWriters:
    """``generate_megapixel_mnist(out_dir, **kw)``'s store with each split
    written by a spawned process of its own, started at construction; the
    two splits draw from separate generators, so the files are the same
    bytes. ``close()`` stops the processes (a no-op after ``wait()``)."""

    def __init__(self, out_dir: str, **kw):
        import multiprocessing
        splits = _store_splits(out_dir, **kw)
        self._pool = multiprocessing.get_context("spawn").Pool(len(splits))
        self._jobs = {args[1]: self._pool.apply_async(_timed_split, args,
                                                      split_kw)
                      for args, split_kw in splits}

    def wait(self, timeout: Optional[float] = None) -> Dict[str, float]:
        """Each split's seconds; raises ``multiprocessing.TimeoutError``
        (and stops the processes) when ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            seconds = {k: job.get(None if deadline is None else max(
                deadline - time.monotonic(), 0))
                for k, job in self._jobs.items()}
        except BaseException:
            self.close()
            raise
        self._pool.close()
        self._pool.join()
        return seconds

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def _place_nonoverlapping(rng: np.random.Generator, n: int, H: int, W: int
                          ) -> np.ndarray:
    """n random positions with pairwise L_inf distance >= 28."""
    positions: list = []
    for _ in range(n):
        while True:
            pos = np.round(rng.random(2) * [H - DIGIT, W - DIGIT]).astype(int)
            if not positions:
                break
            d = np.abs(np.asarray(positions) - pos[None])
            if not np.logical_and(d[:, 0] < DIGIT, d[:, 1] < DIGIT).any():
                break
        positions.append(pos)
    return np.asarray(positions)


def _make_sample(rng: np.random.Generator, digits: np.ndarray,
                 labels: np.ndarray, W: int, H: int,
                 noise_bank: Optional[np.ndarray], n_noise: int) -> Dict:
    # 3 digits of a random target class + 2 of other classes
    target = int(rng.integers(0, 10))
    pos_pool = np.flatnonzero(labels == target)
    neg_pool = np.flatnonzero(labels != target)
    chosen = np.concatenate([rng.choice(pos_pool, 3), rng.choice(neg_pool, 2)])
    chosen_labels = labels[chosen]
    positions = _place_nonoverlapping(rng, 5, H, W)

    img = np.zeros((H, W), np.float32)
    if noise_bank is not None:
        npos = (rng.random((n_noise, 2)) * [H - 2 * DIGIT, W - 2 * DIGIT]
                + DIGIT).astype(int)
        pat = rng.integers(0, len(noise_bank), n_noise)
        for (py, px), pi in zip(npos, pat):
            img[py:py + DIGIT, px:px + DIGIT] = noise_bank[pi]
    for (py, px), di in zip(positions, chosen):
        img[py:py + DIGIT, px:px + DIGIT] = digits[di]

    flat = img.ravel()
    nz = np.flatnonzero(flat)
    top_digit = int(chosen_labels[np.argmin(positions[:, 0])])
    multi = np.zeros(10, np.float32)
    multi[np.unique(chosen_labels)] = 1.0
    return {
        "input": (nz, flat[nz]),
        "majority": np.int64(target),
        "max": np.int64(chosen_labels.max()),
        "top": np.int64(top_digit),
        "multi": multi,
    }


# --------------------------------------------------------------------------
# training dataset
# --------------------------------------------------------------------------

class MegapixelMNIST(Dataset):
    """Loads the sparse store and emits, per sample, either the sparse
    pixels padded to a multiple of 512 (``sparse_input``: densified on the
    device, ``ips_tpu_torch.ops.densify``) or NHWC patches (N, ph, pw, C)
    densified on the host."""

    def __init__(self, conf, train: bool = True):
        with open(os.path.join(conf.data_dir, "parameters.json")) as f:
            self.parameters = json.load(f)
        self.patch_size = conf.patch_size
        self.patch_stride = conf.patch_stride
        self.tasks = conf.task_list
        self._hw = (self.parameters["height"], self.parameters["width"])
        fname = "train.npy" if train else "test.npy"
        self._data = np.load(os.path.join(conf.data_dir, fname),
                             allow_pickle=True)
        # sparse mode ships (idx, val) pairs: O(nnz) host-to-device bytes
        self.sparse = bool(getattr(conf, "sparse_input", False))
        if self.sparse:
            if conf.patch_size != conf.patch_stride:
                raise ValueError("sparse_input requires exact patch tiling")
            max_nnz = max(len(s["input"][0]) for s in self._data)
            self.nnz_pad = -(-max_nnz // 512) * 512

    @property
    def img_hw(self):
        return self._hw

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        sample = self._data[i]
        H, W = self._hw
        idx, vals = sample["input"]
        if self.sparse:
            n = len(idx)
            pidx = np.zeros(self.nnz_pad, np.int32)
            pval = np.zeros(self.nnz_pad, np.float32)
            pidx[:n] = idx
            pval[:n] = vals
            out = {"input_idx": pidx, "input_val": pval,
                   "img_hw": np.asarray(self._hw, np.int32)}
        else:
            patches = densify_patchify(idx, vals, (H, W, 1), self.patch_size,
                                       self.patch_stride)
            out = {"input": patches}
        for t in self.tasks:
            out[t.name] = np.asarray(sample[t.name])
        return out


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(description="Create the Megapixel MNIST dataset")
    p.add_argument("--n_train", type=int, default=5000)
    p.add_argument("--n_test", type=int, default=1000)
    p.add_argument("--width", type=int, default=1500)
    p.add_argument("--height", type=int, default=1500)
    p.add_argument("--no_noise", action="store_false", dest="noise")
    p.add_argument("--n_noise", type=int, default=50)
    p.add_argument("--dataset_seed", type=int, default=0)
    p.add_argument("--digit_source", default="sklearn",
                   choices=["mnist", "sklearn", "synthetic"])
    p.add_argument("--mnist_path", default=None,
                   help="path to a local mnist.npz (digit_source=mnist)")
    p.add_argument("output_directory")
    a = p.parse_args(argv)
    generate_megapixel_mnist(
        a.output_directory, n_train=a.n_train, n_test=a.n_test,
        width=a.width, height=a.height, noise=a.noise, n_noise=a.n_noise,
        seed=a.dataset_seed, digit_source=a.digit_source,
        mnist_path=a.mnist_path)


if __name__ == "__main__":
    main()
