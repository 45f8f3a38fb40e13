"""Synthetic Swedish-Traffic-Signs corpus (counterpart of
ips_tpu/data/traffic_synth.py).

    python -m ips_tpu_torch.data.traffic_synth --n_per_set 128 \\
        --height 1200 --width 1600 <out_dir>

writes a corpus in the STS layout,

    out_dir/Set1/{set1_img*.jpg, annotations.txt}
    out_dir/Set2/{set2_img*.jpg, annotations.txt}
    out_dir/SYNTHETIC            (marker: skips the md5 gate)

byte for byte what the JAX package's generator writes from the same seed
and arguments. Scenes are road-like (sky gradient, road wedge,
rectangles, sensor noise); images of the classes 50/70/80 carry a
red-ring speed-limit sign at a random place with a glyph of its class
(two bars, a diagonal stroke, two discs). Some sign images are annotated
OCCLUDED and some carry MISC_SIGNS entries, which the reader's filter
drops or skips.

``synth_sts_images`` yields the same images in memory, before JPEG
compression, for a machine without PIL; ``synth_sts_sets`` gathers them
into the ``images=`` form of ``TrafficSigns``. Their pixels therefore
differ from the files' (the JPEG's loss), while annotations and labels
are the same.
"""

from __future__ import annotations

import argparse
import os
from os import path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ips_tpu_torch.data.traffic import Sign, parse_annotation_line

CLASSES = ["EMPTY", "50_SIGN", "70_SIGN", "80_SIGN"]
SETS = ("Set1", "Set2")


def _background(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    yy = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None]
    sky = np.stack([0.45 + 0.2 * (1 - yy), 0.6 + 0.2 * (1 - yy),
                    0.8 + 0.15 * (1 - yy)], axis=-1)
    img = np.broadcast_to(sky, (H, W, 3)).copy()
    # road wedge in the lower half
    horizon = int(H * rng.uniform(0.45, 0.6))
    xs = np.arange(W, dtype=np.float32)[None, :]
    ys = np.arange(H, dtype=np.float32)[:, None]
    frac = np.clip((ys - horizon) / max(H - horizon, 1), 0, 1)
    half_w = (0.08 + 0.55 * frac) * W
    cx = W * rng.uniform(0.4, 0.6)
    road = (ys >= horizon) & (np.abs(xs - cx) <= half_w)
    img[road] = rng.uniform(0.25, 0.4)
    # buildings / distractor rectangles
    for _ in range(rng.integers(3, 8)):
        w = int(rng.uniform(0.05, 0.2) * W)
        h = int(rng.uniform(0.1, 0.35) * H)
        x0 = int(rng.uniform(0, W - w))
        y0 = int(max(0, horizon - h))
        img[y0:horizon, x0:x0 + w] = rng.uniform(0.3, 0.7, 3)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def _blend(img: np.ndarray, sel: np.ndarray, color, c: float) -> None:
    """Alpha-blend `color` into img[sel] with weight c (c=1: opaque)."""
    img[sel] = img[sel] * (1.0 - c) + np.asarray(color, np.float32) * c


def _paint_sign(img: np.ndarray, rng: np.random.Generator, cls: int,
                contrast: float = 1.0):
    """Red-ring speed-limit sign with a class glyph; returns its bbox.

    ``contrast`` < 1 alpha-blends the whole sign into the background: a
    draw near 0 leaves the glyph unrecognisable while the label stays a
    sign class, so test accuracy stays below 1.0 (a weak-signal corpus)."""
    H, W = img.shape[:2]
    r = rng.uniform(0.05, 0.09) * H
    cy = rng.uniform(0.2, 0.6) * H
    cx = rng.uniform(0.1, 0.9) * W
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    d = np.sqrt((ys - cy) ** 2 + (xs - cx) ** 2)
    c = float(contrast)
    _blend(img, d <= r, (0.95, 0.92, 0.85), c)            # interior
    ring = (d <= r) & (d >= 0.72 * r)
    _blend(img, ring, (0.82, 0.08, 0.10), c)              # red ring
    u, v = (ys - cy) / r, (xs - cx) / r                   # sign-local coords
    inner = d < 0.64 * r
    dark = (0.08, 0.08, 0.10)
    if cls == 1:    # 50: two horizontal bars
        _blend(img, inner & (np.abs(u + 0.25) < 0.12), dark, c)
        _blend(img, inner & (np.abs(u - 0.25) < 0.12), dark, c)
    elif cls == 2:  # 70: one thick diagonal stroke
        _blend(img, inner & (np.abs(u - v) < 0.17), dark, c)
    elif cls == 3:  # 80: two stacked discs
        dd = np.sqrt((u + 0.28) ** 2 + v ** 2)
        _blend(img, inner & (dd < 0.22), dark, c)
        dd = np.sqrt((u - 0.28) ** 2 + v ** 2)
        _blend(img, inner & (dd < 0.22), dark, c)
    return (cx + r, cy + r, cx - r, cy - r)   # (x_max, y_max, x_min, y_min)


def _annot_line(fname: str, entries) -> str:
    if not entries:
        return f"{fname}:"
    return f"{fname}:" + ";".join(entries)


def synth_sts_images(n_per_set: int = 128, height: int = 600,
                     width: int = 800, seed: int = 0,
                     occluded_frac: float = 0.08, contrast: float = 1.0,
                     contrast_min: Optional[float] = None
                     ) -> Iterator[Tuple[str, str, np.ndarray, str]]:
    """Yields (set name, file name, uint8 (height, width, 3) image,
    annotation line) for Set1's images, then Set2's, all drawn from one
    ``default_rng(seed)`` in the file writer's order: background, the
    contrast (when ``contrast_min`` is given, a draw from U(contrast_min,
    contrast), else the fixed ``contrast``), the sign, its visibility,
    the MISC_SIGNS entry."""
    rng = np.random.default_rng(seed)
    for set_name in SETS:
        for i in range(n_per_set):
            cls = i % len(CLASSES)       # balanced classes
            img = _background(rng, height, width)
            fname = f"{set_name.lower()}_img{i:04d}.jpg"
            entries = []
            if cls > 0:
                c = (rng.uniform(contrast_min, contrast)
                     if contrast_min is not None else contrast)
                bbox = _paint_sign(img, rng, cls, contrast=c)
                vis = ("OCCLUDED" if rng.random() < occluded_frac
                       else "VISIBLE")
                entries.append(
                    f"{vis}, {bbox[0]:.2f}, {bbox[1]:.2f}, {bbox[2]:.2f}, "
                    f"{bbox[3]:.2f}, SIGN, {CLASSES[cls]}")
            if rng.random() < 0.1:
                entries.append("MISC_SIGNS")
            yield (set_name, fname, (img * 255).astype(np.uint8),
                   _annot_line(fname, entries))


def synth_sts_sets(n_per_set: int = 128, height: int = 600, width: int = 800,
                   seed: int = 0, **kw
                   ) -> Dict[str, List[Tuple[str, np.ndarray, List[Sign]]]]:
    """Both sets in memory, ``{set: [(file name, uint8 image, signs)]}``,
    the ``images=`` form of ``TrafficSigns``; the signs parsed from each
    annotation line as the file reader parses them."""
    sets: Dict[str, list] = {s: [] for s in SETS}
    for set_name, fname, img, line in synth_sts_images(
            n_per_set, height, width, seed, **kw):
        name, signs = parse_annotation_line(line)
        sets[set_name].append((name, img, signs))
    return sets


def generate_synth_sts(out_dir: str, n_per_set: int = 128, height: int = 600,
                       width: int = 800, seed: int = 0,
                       occluded_frac: float = 0.08,
                       contrast: float = 1.0,
                       contrast_min: Optional[float] = None) -> None:
    """Write the corpus of ``synth_sts_images`` as JPEGs (quality 88) with
    one ``annotations.txt`` a set and the ``SYNTHETIC`` marker."""
    from PIL import Image
    lines: Dict[str, List[str]] = {s: [] for s in SETS}
    for s in SETS:
        os.makedirs(path.join(out_dir, s), exist_ok=True)
    for set_name, fname, img, line in synth_sts_images(
            n_per_set, height, width, seed, occluded_frac, contrast,
            contrast_min):
        lines[set_name].append(line)
        Image.fromarray(img).save(path.join(out_dir, set_name, fname),
                                  quality=88)
    for s in SETS:
        with open(path.join(out_dir, s, "annotations.txt"), "w") as f:
            f.write("\n".join(lines[s]) + "\n")
    with open(path.join(out_dir, "SYNTHETIC"), "w") as f:
        f.write("synthetic STS-layout corpus; md5 gate bypassed\n")


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Generate a synthetic STS-layout traffic-sign corpus")
    p.add_argument("--n_per_set", type=int, default=128)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--contrast", type=float, default=1.0,
                   help="sign contrast in (0, 1]; with --contrast_min, a "
                        "per-image U(contrast_min, contrast) draw")
    p.add_argument("--contrast_min", type=float, default=None)
    p.add_argument("output_directory")
    a = p.parse_args(argv)
    generate_synth_sts(a.output_directory, a.n_per_set, a.height, a.width,
                       a.seed, contrast=a.contrast,
                       contrast_min=a.contrast_min)
    print(f"wrote synthetic STS corpus to {a.output_directory}")


if __name__ == "__main__":
    main()
