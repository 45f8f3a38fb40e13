"""CAMELYON16 end-to-end image mode: raw slide tiles for the conv encoder
(counterpart of ips_tpu/data/camelyon/patches.py).

One item is one slide: its foreground tiles as (bucket, ph, pw, 3) uint8
(a quarter of fp32's bytes), zero-padded to a bucket (``default_buckets``
or ``conf.bucket_sizes``), a (bucket,) validity mask and the slide's
tumour label for every task. With ``eager: false`` the tiles stay in host
memory and the streaming selection moves O(M + I) of them to the device.

The tiles come from the slides that the otsu and foreground steps
indexed (``<data_dir>/otsu.csv`` and the ``fg/{coords,bounds}_*.pkl``
pickles, read with pandas, which is imported only there), or from an
in-memory mapping ``name -> (tiles (n, ph, pw, 3) uint8, label)``
(``slides=``), for a machine without pandas or PIL. The mapping's slides
come in name order, the order the foreground step writes them in; item
``i`` is byte-identical either way.
"""

from __future__ import annotations

import os
from bisect import bisect_left
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from ips_tpu_torch.data.camelyon.dataset import default_buckets
from ips_tpu_torch.data.camelyon.slide import SlideManager
from ips_tpu_torch.data.loader import Dataset

TileSlides = Mapping[str, Tuple[np.ndarray, int]]


class CamelyonPatches(Dataset):
    """One item = one slide = (bucket, ph, pw, 3) uint8 tiles + mask."""

    def __init__(self, conf, train: bool = True, lvl: int = 0,
                 otsu_fname: str = "otsu.csv",
                 coords_dir: Optional[str] = None,
                 max_tiles: Optional[int] = None,
                 slides: Optional[TileSlides] = None):
        self.conf = conf
        self.tasks = conf.task_list
        self.lvl = lvl
        self.tile_hw = tuple(conf.patch_size)
        self.max_tiles = max_tiles
        self._slides = slides
        if slides is not None:
            self.slide_names = sorted(slides)
            counts = [len(slides[s][0]) for s in self.slide_names]
        else:
            import pandas as pd
            sub = "train" if train else "test"
            coords_dir = coords_dir or os.path.join(conf.data_dir, "fg")
            self.coords = pd.read_pickle(
                os.path.join(coords_dir, f"coords_{sub}.pkl"))
            self.bounds = pd.read_pickle(
                os.path.join(coords_dir, f"bounds_{sub}.pkl"))
            self.slide_man = SlideManager(data_dir=conf.data_dir,
                                          otsu_fname=otsu_fname)
            self.slide_names = list(self.bounds["name"])
            counts = [row.end_id - row.start_id + 1
                      for row in self.bounds.itertuples()]
        self._ns = [min(n, max_tiles) if max_tiles else n for n in counts]
        max_n = max(self._ns) if self._ns else conf.M
        self.buckets = (list(conf.bucket_sizes) if conf.bucket_sizes
                        else default_buckets(max_n, conf.M, conf.I))

    def _bucket(self, i: int, n: int) -> int:
        j = bisect_left(self.buckets, n)
        if j == len(self.buckets):
            raise ValueError(
                f"slide {self.slide_names[i]} has {n} tiles, exceeding the "
                f"largest bucket {self.buckets[-1]}; extend "
                "conf.bucket_sizes or set max_tiles")
        return self.buckets[j]

    def bucket_of(self, i: int) -> int:
        """Padded bucket size of slide i, for bucket-batched loading
        (``DataLoader(bucket_fn=ds.bucket_of)``)."""
        return self._bucket(i, self._ns[i])

    def __len__(self) -> int:
        return len(self.slide_names)

    def _read(self, i: int, out: np.ndarray) -> Tuple[int, int]:
        """Write slide i's tiles into ``out[:n]``; returns (n, label)."""
        ph, pw = self.tile_hw
        if self._slides is not None:
            tiles, label = self._slides[self.slide_names[i]]
            n = self._ns[i]
            if tuple(tiles.shape[1:]) != (ph, pw, 3):
                raise ValueError(f"slide {self.slide_names[i]}: tiles "
                                 f"{tuple(tiles.shape[1:])}, expected "
                                 f"{(ph, pw, 3)}")
            out[:n] = tiles[:n]
            return n, int(label)
        row = self.bounds.iloc[i]
        slide = self.slide_man.get_slide(row["name"])
        rows = self.coords.iloc[row["start_id"]:row["end_id"] + 1]
        n = self._ns[i]
        # one vectorised gather for array-backed slides; OpenSlide readers
        # loop, as any whole-slide reader must
        xy = rows[["x", "y"]].to_numpy()[:n]
        slide.read_tiles(xy, self.lvl, (pw, ph), out=out[:n])
        return n, int(slide.has_tumor)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        ph, pw = self.tile_hw
        b = self._bucket(i, self._ns[i])
        tiles = np.zeros((b, ph, pw, 3), np.uint8)
        n, label = self._read(i, tiles)
        mask = np.zeros(b, bool)
        mask[:n] = True
        out = {"input": tiles, "mask": mask}
        for t in self.tasks:
            out[t.name] = np.int64(label)
        return out


def synth_tile_slides(counts: Sequence[int],
                      tile_hw: Tuple[int, int] = (224, 224), seed: int = 0,
                      shift: int = 40, pool: int = 64
                      ) -> Dict[str, Tuple[np.ndarray, int]]:
    """Synthetic slides for ``CamelyonPatches(slides=)``: slide i has
    ``counts[i]`` tiles, each one of ``pool`` random uint8 tiles drawn
    from ``seed``, and label i % 2. A tumour slide has a twentieth of its
    tiles (at least one) brightened by ``shift`` in the red channel, so
    that selection can find them and the loss can fall."""
    rng = np.random.default_rng(seed)
    ph, pw = tile_hw
    base = rng.integers(0, 256 - shift, (pool, ph, pw, 3), np.uint8)
    out = {}
    for i, n in enumerate(counts):
        label = i % 2
        tiles = base[rng.integers(0, pool, n)]
        if label:
            rows = rng.choice(n, max(1, n // 20), replace=False)
            tiles[rows, :, :, 0] += np.uint8(shift)
        out[f"slide_{i:03d}"] = (tiles, label)
    return out
