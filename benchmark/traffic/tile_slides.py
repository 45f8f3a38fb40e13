"""Synthetic whole-slide tiles from a seed: a frozen copy of the
repository's synthetic CAMELYON16 tile corpus.

Every slide is a set of 224 x 224 x 3 uint8 tiles drawn from a pool of
``pool`` random textures; a tumour slide (every second one) has a
twentieth of its tiles brightened in the red channel, so that selection
has something to find. The tile counts of a run are one fixed list
spread evenly from ``min_tiles`` to ``max_tiles``; the seed only decides
which slide gets which count, and the textures and their placement, so
every seed gives the device the same amount of work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def tile_counts(p: dict) -> List[int]:
    return [int(round(v)) for v in np.linspace(p["min_tiles"], p["max_tiles"],
                                               p["n_slides"])]


def make_slides(p: dict, seed: int) -> Dict[str, Tuple[np.ndarray, int]]:
    """name -> (tiles (n, ph, pw, 3) uint8, label): the counts in an order
    drawn from ``default_rng([seed, 1])``, then slide by slide as the
    repository's ``synth_tile_slides(counts, tile, seed, shift, pool)``
    makes them."""
    counts = np.random.default_rng([seed, 1]).permutation(tile_counts(p))
    rng = np.random.default_rng(seed)
    ph, pw = p["tile"]
    shift = p["shift"]
    base = rng.integers(0, 256 - shift, (p["pool"], ph, pw, 3), np.uint8)
    out = {}
    for i, n in enumerate(counts):
        label = i % 2
        tiles = base[rng.integers(0, p["pool"], n)]
        if label:
            rows = rng.choice(n, max(1, n // 20), replace=False)
            tiles[rows, :, :, 0] += np.uint8(shift)
        out[f"slide_{i:03d}"] = (tiles, label)
    return out
