"""CAMELYON16 slide features with bucketed padding (counterpart of
ips_tpu/data/camelyon/dataset.py).

One item is one slide: its variable-length (N_slide, F) feature rows,
zero-padded to a *bucket* size, a (bucket,) validity mask and the slide's
binary label for every task. Buckets default to M, M + I, M + 2I, M + 4I,
... (or ``conf.bucket_sizes``), so the selection sees a few shapes only
and ``bucket_of`` lets the loader batch same-shape slides.

The slides come from the reference's HDF5 layout (one group per slide
holding ``img`` (N, F) and ``pos``, the label in ``attrs["label"]``),
read through one lazy handle per loader thread, or from an in-memory
mapping ``name -> (features, label)`` (``slides=``), such as
``dict(synth_slides(...))`` on a machine without h5py. ``h5py`` is
imported only where an HDF5 file is read or written.
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from ips_tpu_torch.data.loader import Dataset

Slides = Mapping[str, Tuple[np.ndarray, int]]


def default_buckets(max_n: int, M: int, I: int) -> List[int]:
    """Geometric bucket ladder: M, M+I, M+2I, M+4I, ... >= max_n."""
    buckets = [M]
    k = 1
    while buckets[-1] < max_n:
        buckets.append(M + k * I)
        k *= 2
    return buckets


def pad_to_bucket(x: np.ndarray, buckets: List[int]):
    """(N, F) -> ((bucket, F) zero-padded, (bucket,) bool mask)."""
    n = x.shape[0]
    i = bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(f"slide with {n} patches exceeds largest bucket "
                         f"{buckets[-1]}")
    b = buckets[i]
    out = np.zeros((b,) + x.shape[1:], x.dtype)
    out[:n] = x
    mask = np.zeros(b, bool)
    mask[:n] = True
    return out, mask


class CamelyonFeatures(Dataset):
    """Slide features (HDF5 file or in-memory slides), bucket-padded with
    a validity mask."""

    def __init__(self, conf, train: bool = True,
                 slides: Optional[Slides] = None):
        self.tasks = conf.task_list
        self._slides = slides
        self._local = threading.local()     # lazy per-thread HDF5 handle
        if slides is not None:
            self.path = None
            # the order an HDF5 file lists its groups in: by name
            self.slide_names = sorted(slides)
            self._ns = [slides[s][0].shape[0] for s in self.slide_names]
        else:
            fname = conf.train_fname if train else conf.test_fname
            self.path = os.path.join(conf.data_dir, fname)
            import h5py
            with h5py.File(self.path, "r") as f:
                self.slide_names = list(f.keys())
                self._ns = [f[s]["img"].shape[0] for s in self.slide_names]
        max_n = max(self._ns, default=conf.M)
        self.buckets = (list(conf.bucket_sizes) if conf.bucket_sizes
                        else default_buckets(max_n, conf.M, conf.I))

    def bucket_of(self, i: int) -> int:
        """Padded bucket size of slide i, for bucket-batched loading
        (``DataLoader(bucket_fn=ds.bucket_of)``). Raises for a slide
        beyond the largest bucket when the loader is built, not later
        inside a worker thread."""
        j = bisect_left(self.buckets, self._ns[i])
        if j == len(self.buckets):
            raise ValueError(
                f"slide {self.slide_names[i]} with {self._ns[i]} patches "
                f"exceeds largest bucket {self.buckets[-1]}; set "
                "conf.bucket_sizes accordingly")
        return self.buckets[j]

    def _file(self):
        import h5py
        if not hasattr(self._local, "f"):
            self._local.f = h5py.File(self.path, "r")
        return self._local.f

    def _slide(self, i: int) -> Tuple[np.ndarray, int]:
        name = self.slide_names[i]
        if self._slides is not None:
            feats, label = self._slides[name]
            return np.asarray(feats, np.float32), int(label)
        grp = self._file()[name]
        return grp["img"][:].astype(np.float32), int(grp.attrs["label"])

    def __len__(self) -> int:
        return len(self.slide_names)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        feats, label = self._slide(i)
        padded, mask = pad_to_bucket(feats, self.buckets)
        out = {"input": padded, "mask": mask}
        for t in self.tasks:
            out[t.name] = np.int64(label)
        return out


def synth_slides(n_slides: int = 8, feat_dim: int = 32, n_range=(40, 200),
                 seed: int = 0, signal: float = 2.0
                 ) -> Iterator[Tuple[str, Tuple[np.ndarray, int]]]:
    """The synthetic corpus, one ``(name, (features, label))`` at a time.

    Labels alternate 0, 1; a tumor slide gets ``max(1, n // 20)``
    'lesion' rows with ``signal`` added to the first half of the
    features, so the IPS + AUC path can learn it. The draws, names and
    labels are the JAX package's for the same arguments.
    """
    rng = np.random.default_rng(seed)
    for i in range(n_slides):
        n = int(rng.integers(*n_range))
        label = i % 2
        feats = rng.normal(0, 1, (n, feat_dim)).astype(np.float32)
        if label:
            k = max(1, n // 20)
            rows = rng.choice(n, k, replace=False)
            feats[rows, : feat_dim // 2] += signal
        name = (f"slide_{'test_' if i >= n_slides // 2 else ''}"
                f"{i:03d}")
        yield name, (feats, label)


def make_synth_features(path: str, n_slides: int = 8, feat_dim: int = 32,
                        n_range=(40, 200), seed: int = 0,
                        signal: float = 2.0,
                        compression: Optional[str] = "gzip") -> str:
    """Write :func:`synth_slides` as an HDF5 file in the reference layout
    (byte-compatible with the JAX package's writer). ``compression=None``
    writes uncompressed datasets: gzip of random floats runs ~20 MB/s on
    one core, too slow for a corpus at N ~ 10k, 2048-dim."""
    import h5py
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, (feats, label) in synth_slides(n_slides, feat_dim,
                                                 n_range, seed, signal):
            n = feats.shape[0]
            grp = f.create_group(name)
            grp.create_dataset("img", data=feats, compression=compression)
            grp.create_dataset("pos", data=np.arange(n),
                               compression=compression)
            grp.attrs["label"] = label
    return path

