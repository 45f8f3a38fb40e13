"""Annotation visualization helpers (counterpart of
ips_tpu/data/camelyon/viz.py): translate a tumour polygon into a level's
coordinate frame, draw it over the slide region, and render a padded crop
of the annotated tissue section. Uses PIL.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

from ips_tpu_torch.data.camelyon.slide import Annotation, Point, Slide


def get_relative_polygon(polygon: Sequence[Point], origin: Point,
                         downsample: float = 1.0) -> Tuple[Point, ...]:
    """Translate polygon points to be relative to `origin`, downscaled."""
    ox, oy = origin
    return tuple(((x - ox) / downsample, (y - oy) / downsample)
                 for x, y in polygon)


def draw_polygon(image: Image.Image, polygon: Sequence[Point], *, fill,
                 outline) -> Image.Image:
    """Alpha-composite a filled polygon onto an image."""
    overlay = Image.new("RGBA", image.size)
    ImageDraw.Draw(overlay).polygon([tuple(p) for p in polygon], fill,
                                    outline)
    image = image.convert("RGBA") if image.mode != "RGBA" else image
    image.paste(overlay, mask=overlay)
    return image


def annotation_boundaries(annotation: Annotation, slide: Slide, level: int,
                          padding: int = 0
                          ) -> Tuple[Point, Tuple[int, int]]:
    """((x, y) level-0 origin, (w, h) on `level`) of the annotation bbox."""
    xs = [p[0] for p in annotation.polygon]
    ys = [p[1] for p in annotation.polygon]
    x = int(min(xs) - padding)
    y = int(min(ys) - padding)
    width = int(max(xs) - x + padding)
    height = int(max(ys) - y + padding)
    ds = slide.level_downsamples[level]
    return (x, y), (int(width / ds), int(height / ds))


def annotation_image(annotation: Annotation, slide: Slide, *, level: int = 4,
                     padding: int = 100,
                     fill=(50, 50, 50, 80)) -> Image.Image:
    """Annotated tissue section with the tumour polygon overlaid."""
    level = min(level, len(slide.level_dimensions) - 1)
    origin, size = annotation_boundaries(annotation, slide, level, padding)
    ds = slide.level_downsamples[level]
    region = slide.read_region(origin, level, size)
    img = Image.fromarray(np.asarray(region)[..., :3].astype(np.uint8))
    outline = annotation.color or "#F4FA58"
    return draw_polygon(img,
                        get_relative_polygon(annotation.polygon, origin, ds),
                        fill=fill, outline=outline)
