"""Offline step 2 of 3: foreground tile coordinates (counterpart of
ips_tpu/data/camelyon/foreground.py).

Each slide is tiled by ``split_slide`` at its otsu threshold. The tiles
that hold enough foreground (or any tumour) make one flat table
``coords`` (``name, x, y, pos_id``) and one row per slide in ``bounds``
(``name, start_id, end_id``, inclusive). A slide with no such tile is
skipped with a warning. :func:`compute_foreground` writes them as pandas
pickles ``coords_{train,test}.pkl`` / ``bounds_{train,test}.pkl``
(pandas is imported only there); :func:`foreground_tables` returns the
same columns as numpy arrays for slides held in memory.

    python -m ips_tpu_torch.data.camelyon.foreground [--train|--test] \\
        [--tile_size 256] [--n_worker W] data_dir otsu_fname out_dir
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
from functools import partial
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ips_tpu_torch.data.camelyon.methods import split_slide
from ips_tpu_torch.data.camelyon.slide import Slide, SlideManager

Tables = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def slide_tiles(slide: Slide, *, lvl: int = 0, otsu_lvl: int = 0,
                tile_size: int = 256, fg_perc_thresh: float = 0.01,
                overlap: int = 0) -> Tuple[List[int], List[int]]:
    """Level-0 (x, y) of the slide's foreground tiles, in scan order."""
    otsu_threshold = slide.get_otsu_threshold(otsu_lvl)
    if otsu_threshold is None:
        raise ValueError(f"no otsu threshold for slide {slide.name} at "
                         f"level {otsu_lvl}; run the otsu step first")
    xs, ys = [], []
    for _, bounds in split_slide(slide, lvl, otsu_threshold, fg_perc_thresh,
                                 tile_size, overlap):
        xs.append(bounds[0][0])
        ys.append(bounds[0][1])
    print("Finished slide: ", slide.name, flush=True)
    return xs, ys


def _file_slide_tiles(name: str, *, data_dir: str, otsu_fname: str, **kw):
    slide = SlideManager(data_dir=data_dir,
                         otsu_fname=otsu_fname).get_slide(name)
    try:
        return slide_tiles(slide, **kw)
    finally:
        slide.close()


def _map(fn, items: Sequence, n_worker: int) -> list:
    if n_worker > 1:
        with mp.get_context("spawn").Pool(n_worker) as pool:
            return list(pool.imap(fn, items))
    return [fn(x) for x in items]


def _collect(names: Sequence[str], results):
    """Per-slide (xs, ys) -> the flat coordinate columns and the bounds
    rows; a slide without tiles is skipped with a warning."""
    all_x, all_y, all_names, bounds_rows = [], [], [], []
    for name, (xs, ys) in zip(names, results):
        if not xs:
            # a blank slide (or fg_perc_thresh too high): a bounds row
            # with end_id < start_id would break every reader
            print(f"warning: slide {name} produced no foreground tiles; "
                  f"skipping", file=sys.stderr)
            continue
        start = len(all_x)
        all_x.extend(xs)
        all_y.extend(ys)
        all_names.extend([name] * len(xs))
        bounds_rows.append({"name": name, "start_id": start,
                            "end_id": len(all_x) - 1})
    return all_names, all_x, all_y, bounds_rows


def tables_from_tiles(names: Sequence[str],
                      tiles: Sequence[Tuple[List[int], List[int]]]
                      ) -> Tables:
    """Per-slide (xs, ys) from :func:`slide_tiles`, in slide order ->
    (coords, bounds) as dicts of numpy columns: coords ``name, x, y,
    pos_id``; bounds ``name, start_id, end_id``."""
    all_names, all_x, all_y, rows = _collect(names, tiles)
    coords = {"name": np.asarray(all_names, dtype=str),
              "x": np.asarray(all_x, np.int64),
              "y": np.asarray(all_y, np.int64),
              "pos_id": np.arange(len(all_x), dtype=np.int64)}
    bounds = {"name": np.asarray([r["name"] for r in rows], dtype=str),
              "start_id": np.asarray([r["start_id"] for r in rows],
                                     np.int64),
              "end_id": np.asarray([r["end_id"] for r in rows], np.int64)}
    return coords, bounds


def foreground_tables(slides: Mapping[str, Slide], *, lvl: int = 0,
                      otsu_lvl: int = 0, tile_size: int = 256,
                      fg_perc_thresh: float = 0.01, overlap: int = 0,
                      n_worker: int = 1) -> Tables:
    """(coords, bounds) of slides held in memory (name -> ``Slide`` with
    its otsu thresholds, in the order given), as
    :func:`tables_from_tiles` returns them."""
    names = list(slides)
    fn = partial(slide_tiles, lvl=lvl, otsu_lvl=otsu_lvl,
                 tile_size=tile_size, fg_perc_thresh=fg_perc_thresh,
                 overlap=overlap)
    return tables_from_tiles(names,
                             _map(fn, [slides[n] for n in names], n_worker))


def compute_foreground(data_dir: str, otsu_fname: str, out_dir: str, *,
                       train: bool = True, lvl: int = 0, otsu_lvl: int = 0,
                       tile_size: int = 256, fg_perc_thresh: float = 0.01,
                       overlap: int = 0, n_worker: int = 16):
    import pandas as pd
    os.makedirs(out_dir, exist_ok=True)
    slide_man = SlideManager(data_dir=data_dir, otsu_fname=otsu_fname)
    names = slide_man.get_slide_names_subset(train=train)
    fn = partial(_file_slide_tiles, data_dir=data_dir, otsu_fname=otsu_fname,
                 lvl=lvl, otsu_lvl=otsu_lvl, tile_size=tile_size,
                 fg_perc_thresh=fg_perc_thresh, overlap=overlap)
    all_names, all_x, all_y, rows = _collect(names,
                                             _map(fn, names, n_worker))
    coords = pd.DataFrame({"name": all_names, "x": all_x, "y": all_y,
                           "pos_id": list(range(len(all_x)))})
    bounds = pd.DataFrame(rows)
    sub = "train" if train else "test"
    coords_path = os.path.join(out_dir, f"coords_{sub}.pkl")
    bounds_path = os.path.join(out_dir, f"bounds_{sub}.pkl")
    coords.to_pickle(coords_path)
    bounds.to_pickle(bounds_path)
    return coords_path, bounds_path


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Compute foreground coordinates for each slide")
    p.add_argument("--train", dest="is_train", action="store_true")
    p.add_argument("--test", dest="is_train", action="store_false")
    p.set_defaults(is_train=True)
    p.add_argument("--lvl", type=int, default=0)
    p.add_argument("--otsu_lvl", type=int, default=0)
    p.add_argument("--tile_size", type=int, default=256)
    p.add_argument("--fg_perc_thresh", type=float, default=0.01)
    p.add_argument("--overlap", type=int, default=0)
    p.add_argument("--n_worker", type=int, default=16)
    p.add_argument("data_dir")
    p.add_argument("otsu_fname")
    p.add_argument("out_dir")
    a = p.parse_args(argv)
    coords, bounds = compute_foreground(
        a.data_dir, a.otsu_fname, a.out_dir, train=a.is_train, lvl=a.lvl,
        otsu_lvl=a.otsu_lvl, tile_size=a.tile_size,
        fg_perc_thresh=a.fg_perc_thresh, overlap=a.overlap,
        n_worker=a.n_worker)
    print(f"Wrote {coords} and {bounds}")


if __name__ == "__main__":
    main()
