"""Offline step 1 of 3: per-slide Otsu thresholds -> CSV (counterpart of
ips_tpu/data/camelyon/otsu.py).

The CSV (``name,level,threshold``) goes to ``<data_dir>/<otsu_fname>``.
:func:`otsu_thresholds` computes the same rows for slides given as file
paths or as arrays held in memory. With ``n_worker > 1`` the slides are
spread over a pool of worker processes.

    python -m ips_tpu_torch.data.camelyon.otsu [--lvl L] [--n_worker W] \\
        data_dir otsu_fname
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing as mp
import os
from functools import partial
from typing import List, Mapping, Tuple, Union

import numpy as np

from ips_tpu_torch.data.camelyon.methods import get_otsu_threshold
from ips_tpu_torch.data.camelyon.slide import Slide, SlideManager

Source = Union[str, np.ndarray]      # a slide file, or (H, W, 3) uint8


def _slide_threshold(work: Tuple[str, Source], lvl: int = 0):
    name, src = work
    slide = (Slide(name, src) if isinstance(src, str)
             else Slide.from_array(name, src))
    try:
        threshold = get_otsu_threshold(slide, level=lvl, step_size=1000)
    finally:
        slide.close()
    return name, lvl, threshold


def otsu_thresholds(slides: Mapping[str, Source], lvl: int = 0,
                    n_worker: int = 1) -> List[Tuple[str, int, float]]:
    """(name, level, threshold) per slide, in the given order. ``slides``:
    name -> file path or (H, W, 3) uint8 array."""
    work = list(slides.items())
    fn = partial(_slide_threshold, lvl=lvl)
    if n_worker > 1:
        with mp.get_context("spawn").Pool(n_worker) as pool:
            return pool.map(fn, work)
    return [fn(w) for w in work]


def compute_thresholds(data_dir: str, otsu_fname: str, lvl: int = 0,
                       n_worker: int = 16) -> str:
    slide_man = SlideManager(data_dir=data_dir, otsu_fname=otsu_fname)
    rows = otsu_thresholds(slide_man.slide_paths, lvl, n_worker)
    out_path = os.path.join(data_dir, otsu_fname)
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["name", "level", "threshold"])
        writer.writerows(rows)
    return out_path


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Compute Otsu thresholds from WSIs")
    p.add_argument("--lvl", type=int, default=0)
    p.add_argument("--n_worker", type=int, default=16)
    p.add_argument("data_dir")
    p.add_argument("otsu_fname")
    a = p.parse_args(argv)
    out = compute_thresholds(a.data_dir, a.otsu_fname, a.lvl, a.n_worker)
    print(f"Done saving thresholds to {out}")


if __name__ == "__main__":
    main()
