"""Synthetic CAMELYON16-layout corpus (counterpart of
ips_tpu/data/camelyon/synth.py).

H&E-like slides: white glass with pink-purple tissue blobs; a tumour
slide also carries a lesion of dense dark "nuclei" speckle, annotated by a
12-point polygon. :func:`synth_camelyon_slides` makes the slides in memory,
one at a time, each with its split and polygon;
:func:`generate_synth_camelyon` writes the same slides, drawn from the
same ``np.random.default_rng(seed)`` stream, in the CAMELYON16 layout the
``SlideManager`` walks:

    out_dir/training/normal/normal_XXX.png
    out_dir/training/tumor/tumor_XXX.png
    out_dir/training/lesion_annotations/tumor_XXX.xml   (ASAP polygons)
    out_dir/testing/images/test_XXX.png
    out_dir/testing/lesion_annotations/test_XXX.xml     (tumour tests only)

PIL is imported only by the file writer.

    python -m ips_tpu_torch.data.camelyon.synth --n_normal 2 --n_tumor 2 \\
        --n_test 2 --height 256 --width 256 out_dir
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from os import path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_ASAP_TPL = """<?xml version="1.0"?>
<ASAP_Annotations>
  <Annotations>
    <Annotation Name="_0" Type="Polygon" PartOfGroup="Tumor" Color="#F4FA58">
      <Coordinates>
{coords}
      </Coordinates>
    </Annotation>
  </Annotations>
</ASAP_Annotations>
"""

SPLIT_DIRS = {"normal": "training/normal", "tumor": "training/tumor",
              "test": "testing/images"}
ANNOTATION_DIRS = {"tumor": "training/lesion_annotations",
                   "test": "testing/lesion_annotations"}


@dataclass
class SynthSlide:
    """One synthetic slide: ``img`` (H, W, 3) uint8 and, for a tumour
    slide, the annotation ``polygon`` (level-0 (x, y), to 0.1 px as the
    XML holds it)."""
    name: str
    split: str                      # normal | tumor | test
    img: np.ndarray
    polygon: Optional[List[Tuple[float, float]]] = None

    @property
    def label(self) -> int:
        return int(self.polygon is not None)


def _tissue_slide(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """White glass + 2-4 elliptical pink-purple tissue blobs."""
    img = np.full((H, W, 3), 243, np.float32)
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.uniform(0.25, 0.75, 2) * (H, W)
        ry, rx = rng.uniform(0.18, 0.35, 2) * (H, W)
        blob = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
        tint = np.array([rng.uniform(175, 205), rng.uniform(120, 150),
                         rng.uniform(175, 205)], np.float32)
        img[blob] = tint + rng.normal(0, 8, 3).astype(np.float32)
    img += rng.normal(0, 4, img.shape).astype(np.float32)
    return img


def _add_lesion(img: np.ndarray, rng: np.random.Generator,
                contrast: float = 1.0):
    """Dense dark-nuclei speckle disc; returns its 12-point polygon
    (x, y). ``contrast`` scales how distinct the lesion's texture is
    (1.0: trivially separable; ~0.1-0.3: a weak signal)."""
    H, W = img.shape[:2]
    cy = rng.uniform(0.35, 0.65) * H
    cx = rng.uniform(0.35, 0.65) * W
    r = rng.uniform(0.12, 0.2) * min(H, W)
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    lesion = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
    a = 0.4 * contrast
    img[lesion] = (img[lesion] * (1 - a)
                   + np.array([90, 40, 110], np.float32) * a)
    nuclei = (rng.random((H, W)) < 0.25 * contrast) & lesion
    cn = min(1.0, 0.25 + 0.75 * contrast)
    img[nuclei] = (img[nuclei] * (1 - cn)
                   + np.array([60, 20, 80], np.float32) * cn)
    poly = [(cx + r * np.cos(t), cy + r * np.sin(t))
            for t in np.linspace(0, 2 * np.pi, 12, endpoint=False)]
    return poly


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def _tenth(poly) -> List[Tuple[float, float]]:
    """The polygon as its ASAP XML stores it: each coordinate to 0.1."""
    return [(float(f"{x:.1f}"), float(f"{y:.1f}")) for x, y in poly]


def synth_camelyon_slides(n_normal: int = 8, n_tumor: int = 8,
                          n_test: int = 8, height: int = 768,
                          width: int = 768, seed: int = 0,
                          contrast: float = 1.0,
                          contrast_min: Optional[float] = None
                          ) -> Iterator[SynthSlide]:
    """The corpus in memory, one slide at a time: ``n_normal`` normal and
    ``n_tumor`` tumour training slides, then ``n_test`` test slides (the
    odd ones with a lesion). ``contrast_min``: each lesion draws its
    contrast from U(contrast_min, contrast) instead."""
    rng = np.random.default_rng(seed)

    def lesion(img):
        c = (contrast if contrast_min is None
             else float(rng.uniform(contrast_min, contrast)))
        return _tenth(_add_lesion(img, rng, c))

    for i in range(n_normal):
        yield SynthSlide(f"normal_{i:03d}", "normal",
                         _to_u8(_tissue_slide(rng, height, width)))
    for i in range(n_tumor):
        img = _tissue_slide(rng, height, width)
        poly = lesion(img)              # draws the lesion into img
        yield SynthSlide(f"tumor_{i:03d}", "tumor", _to_u8(img), poly)
    for i in range(n_test):
        img = _tissue_slide(rng, height, width)
        poly = lesion(img) if i % 2 == 1 else None  # odd ones: a lesion
        yield SynthSlide(f"test_{i:03d}", "test", _to_u8(img), poly)


def _write_xml(fpath: str, poly) -> None:
    coords = "\n".join(
        f'        <Coordinate Order="{i}" X="{x:.1f}" Y="{y:.1f}"/>'
        for i, (x, y) in enumerate(poly))
    with open(fpath, "w") as f:
        f.write(_ASAP_TPL.format(coords=coords))


def generate_synth_camelyon(out_dir: str, n_normal: int = 8,
                            n_tumor: int = 8, n_test: int = 8,
                            height: int = 768, width: int = 768,
                            seed: int = 0, contrast: float = 1.0,
                            contrast_min: Optional[float] = None) -> None:
    """Write the corpus of :func:`synth_camelyon_slides` as PNG slides
    and ASAP XML annotations."""
    from PIL import Image
    for sub in list(SPLIT_DIRS.values()) + list(ANNOTATION_DIRS.values()):
        os.makedirs(path.join(out_dir, sub), exist_ok=True)
    for s in synth_camelyon_slides(n_normal, n_tumor, n_test, height, width,
                                   seed, contrast, contrast_min):
        if s.polygon is not None:
            _write_xml(path.join(out_dir, ANNOTATION_DIRS[s.split],
                                 f"{s.name}.xml"), s.polygon)
        Image.fromarray(s.img).save(
            path.join(out_dir, SPLIT_DIRS[s.split], f"{s.name}.png"))


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Generate a synthetic CAMELYON16-layout corpus")
    p.add_argument("--n_normal", type=int, default=8)
    p.add_argument("--n_tumor", type=int, default=8)
    p.add_argument("--n_test", type=int, default=8)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--contrast", type=float, default=1.0,
                   help="lesion texture strength; ~0.1-0.3 gives a "
                        "weak-signal corpus")
    p.add_argument("--contrast_min", type=float, default=None,
                   help="when set, each lesion draws its contrast from "
                        "U(contrast_min, contrast)")
    p.add_argument("output_directory")
    a = p.parse_args(argv)
    generate_synth_camelyon(a.output_directory, a.n_normal, a.n_tumor,
                            a.n_test, a.height, a.width, a.seed, a.contrast,
                            a.contrast_min)
    print(f"wrote synthetic CAMELYON16 corpus to {a.output_directory}")


if __name__ == "__main__":
    main()
