"""WSI processing methods: HE grayscale, chunked Otsu, masks, tiling
(counterpart of ips_tpu/data/camelyon/methods.py; numpy and scipy).

  * ``rgb2gray``: HE-stain grayscale r + b - (r+g+b)/1.5, clipped to
    [0, 255]
  * ``get_otsu_threshold``: histogram Otsu over the exact value counts of
    the whole slide, read in width x step_size chunks
  * ``create_otsu_mask_by_threshold``: threshold at t and 0.25 t, keep the
    weak components that hold at least one strong pixel (scipy labels)
  * ``create_tumor_mask``: the annotation polygons, rounded to int32 and
    rasterized by :func:`fill_poly`, which gives OpenCV's ``fillPoly``
    (8-connected, no sub-pixel shift) bit for bit without OpenCV
  * ``split_slide``: the tile generator with its foreground and tumour
    checks and the early stop after 100 tumour tiles
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
from scipy import ndimage


def remove_alpha_channel(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3 and image.shape[2] == 4:
        return image[:, :, :3]
    return image


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """Custom HE-stain grayscale."""
    rgb = rgb.astype(np.float64)
    gray = (1.0 * rgb[:, :, 0] + rgb[:, :, 2]
            - (1.0 * rgb[:, :, 0] + rgb[:, :, 1] + rgb[:, :, 2]) / 1.5)
    return np.clip(gray, 0, 255)


def otsu_by_hist(hist: np.ndarray, bin_centers: np.ndarray) -> float:
    """Otsu threshold from a histogram."""
    hist = hist.astype(float)
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean1 = np.cumsum(hist * bin_centers) / weight1
        mean2 = (np.cumsum((hist * bin_centers)[::-1])
                 / weight2[::-1])[::-1]
        variance12 = (weight1[:-1] * weight2[1:]
                      * (mean1[:-1] - mean2[1:]) ** 2)
    idx = np.nanargmax(variance12)
    return float(bin_centers[:-1][idx])


def create_otsu_mask_by_threshold(image: np.ndarray,
                                  threshold: float) -> np.ndarray:
    """Foreground mask keeping weak components attached to strong pixels;
    every component is checked, as in the JAX package."""
    strong = image > threshold
    weak = image > threshold * 0.25
    labeled, n = ndimage.label(weak)
    if n:
        # component ids containing at least one strong pixel
        has_strong = np.zeros(n + 1, bool)
        strong_ids = np.unique(labeled[strong])
        has_strong[strong_ids] = True
        has_strong[0] = False
        return has_strong[labeled].astype(np.uint8)
    return np.zeros_like(image, np.uint8)


def get_otsu_threshold(slide, level: int = 0, step_size: int = 1000) -> float:
    """Chunked whole-slide Otsu threshold."""
    size = slide.level_dimensions[0]
    downsample = slide.level_downsamples[level]
    counts: Dict[float, int] = {}
    for y in range(0, size[1], step_size):
        cur = min(step_size, size[1] - y)
        cut = (int(size[0] / downsample), int(cur / downsample))
        img = np.asarray(slide.read_region((0, y), level, cut))
        gray = rgb2gray(remove_alpha_channel(img))
        vals, cnts = np.unique(gray, return_counts=True)
        for v, c in zip(vals, cnts):
            counts[v] = counts.get(v, 0) + int(c)
    values = np.asarray(sorted(counts))
    hist = np.asarray([counts[v] for v in values])
    return otsu_by_hist(hist, values)


def create_tumor_mask(slide, level: int,
                      bounds: Optional[Tuple[Tuple[int, int],
                                             Tuple[int, int]]] = None
                      ) -> np.ndarray:
    """Rasterize the annotation polygons into a (h, w) uint8 mask.

    bounds: ((x, y) on level 0, (width, height) on `level`).
    """
    if bounds is None:
        start, size = (0, 0), slide.level_dimensions[level]
    else:
        start, size = bounds
    mask = np.zeros((size[1], size[0]), np.uint8)
    ds = slide.level_downsamples[level]
    polys = []
    for ann in slide.annotations:
        pts = np.asarray(ann.polygon, np.float64)          # (P, 2) = (x, y)
        pts[:, 0] = (pts[:, 0] - start[0]) / ds
        pts[:, 1] = (pts[:, 1] - start[1]) / ds
        polys.append(np.round(pts).astype(np.int32))
    return fill_poly(mask, polys, 1)


# OpenCV's polygon fill (imgproc/drawing.cpp: fillPoly -> CollectPolyEdges,
# FillEdgeCollection, with Line and clipLine), as cv2 5.0 computes it for
# integer points, line type 8 and shift 0. Edges are fixed point with 16
# fraction bits. Each edge is drawn as an 8-connected line; an edge with
# an end outside the image is clipped first, and its fill edge runs
# through the clipped ends (a point, when the clipped line is one: then
# the edge is vertical there). Each row fills from ceil to floor between
# consecutive edge crossings, in x order.
_XY_SHIFT = 16


def _idiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the (w, h) image: (inside, x1, y1, x2,
    y2), the ends moved onto the border in double precision."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x: int, y: int) -> bool:
    return not (0 <= x < w and 0 <= y < h)


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int,
           value) -> None:
    """OpenCV's 8-connected Bresenham line (``LineIterator``, left to
    right), clipped to the mask."""
    h, w = mask.shape
    if _outside(w, h, x1, y1) or _outside(w, h, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        mask[y, x] = value
        diag = err < 0
        err += 2 * dx - 2 * dy if diag else -2 * dy
        if vert:
            y += sy
            x += diag
        else:
            x += 1
            y += sy if diag else 0


def fill_poly(mask: np.ndarray, polys, value=1) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, value)`` for a 2-D mask and int32
    (P, 2) (x, y) polygons, in place, bit for bit."""
    h, w = mask.shape
    edges = []                       # (y0, y1, x at y0, dx per row)
    for pts in polys:
        pts = [(int(x), int(y)) for x, y in pts]
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            _line8(mask, x0, y0, x1, y1, value)
            c0x, c0y, c1x, c1y = x0, y0, x1, y1
            if _outside(w, h, x0, y0) or _outside(w, h, x1, y1):
                _, c0x, c0y, c1x, c1y = _clip_line(w, h, x0, y0, x1, y1)
            if y0 != y1:
                c0x, c1x = c0x << _XY_SHIFT, c1x << _XY_SHIFT
                dx = (_idiv(c1x - c0x, c1y - c0y) if c1y != c0y else 0)
                if y0 < y1:
                    edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
                else:
                    edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))
            x0, y0 = x1, y1
    if len(edges) < 2:
        return mask
    one = 1 << _XY_SHIFT
    for y in range(max(min(e[0] for e in edges), 0),
                   min(max(e[1] for e in edges), h)):
        xs = sorted(x + (y - ey0) * dx for ey0, ey1, x, dx in edges
                    if ey0 <= y < ey1)
        for a, b in zip(xs[0::2], xs[1::2]):
            lo, hi = (a + one - 1) >> _XY_SHIFT, b >> _XY_SHIFT
            if lo < w and hi >= 0:
                mask[y, max(lo, 0):min(hi, w - 1) + 1] = value
    return mask


def split_slide(slide, lvl: int, otsu_threshold: float,
                fg_perc_thresh: float, tile_size: int, overlap: int,
                num_pos_tiles_threshold: int = 100
                ) -> Iterator[Tuple[np.ndarray,
                                    Tuple[Tuple[int, int],
                                          Tuple[int, int]]]]:
    """Yield (tile RGB, ((x, y), (w0, h0))) for foreground/tumor tiles."""
    if tile_size <= overlap:
        raise ValueError("Overlap has to be smaller than the tile size.")
    if overlap < 0:
        raise ValueError("Overlap can not be negative.")
    if otsu_threshold < 0:
        raise ValueError("Otsu threshold can not be negative.")
    if not 0.0 <= fg_perc_thresh <= 1.0:
        raise ValueError("Foreground threshold has to be between 0 and 1")

    width0, height0 = slide.level_dimensions[0]
    downsample = slide.level_downsamples[lvl]
    tile_size0 = int(tile_size * downsample + 0.5)
    overlap0 = int(overlap * downsample + 0.5)
    min_fg_count = tile_size ** 2 * fg_perc_thresh

    num_pos_tiles = 0
    skip_pos_mask_calc = False

    for y in range(0, height0, tile_size0 - overlap0):
        if skip_pos_mask_calc or not slide.has_tumor:
            mask_row = None
            n_tumor_pixels_row = 0
        else:
            mask_row = create_tumor_mask(slide, lvl,
                                         ((0, y), (width0, tile_size)))
            n_tumor_pixels_row = int(mask_row.sum())

        for x in range(0, width0, tile_size0 - overlap0):
            if n_tumor_pixels_row > 0:
                if lvl == 0:
                    pos_count = int(mask_row[:, x:x + tile_size].sum())
                else:
                    tile_mask = create_tumor_mask(
                        slide, lvl, ((x, y), (tile_size, tile_size)))
                    pos_count = int(tile_mask.sum())
                if pos_count > 0:
                    num_pos_tiles += 1
                    if num_pos_tiles > num_pos_tiles_threshold:
                        skip_pos_mask_calc = True
            else:
                pos_count = 0

            tile = np.asarray(slide.read_region((x, y), lvl,
                                                (tile_size, tile_size)))
            fg = create_otsu_mask_by_threshold(
                rgb2gray(remove_alpha_channel(tile)), otsu_threshold)
            if fg.sum() >= min_fg_count or pos_count > 0:
                yield (remove_alpha_channel(tile),
                       ((x, y), (tile_size0, tile_size0)))
