"""CAMELYON16 whole-slide-image data model (counterpart of
ips_tpu/data/camelyon/slide.py, framework-free; a copy, not an import).

Slides are read through a pluggable *reader*:

  * OpenSlide (when the C library and its binding are installed),
  * plain image files (PIL) for small-scale runs,
  * in-memory numpy pyramids (tests, synthetic data; ``.npy`` files).

``Slide`` carries the name, annotations, tumour flag, per-level otsu
thresholds and region reads (``Slide.from_array`` holds one in memory);
``parse_asap_annotations`` reads ASAP annotation XML; ``SlideManager``
walks ``training/normal``, ``training/tumor`` and ``testing/images`` with
the otsu CSV. PIL and openslide are imported only where a file of theirs
is opened.
"""

from __future__ import annotations

import csv
import os
import xml.etree.ElementTree as Xml
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from fnmatch import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Point = Tuple[float, float]  # (x, y) on level 0


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

class SlideReader:
    """Minimal multi-resolution region reader protocol."""

    @property
    def level_dimensions(self) -> Sequence[Tuple[int, int]]:  # (w, h) per level
        raise NotImplementedError

    @property
    def level_downsamples(self) -> Sequence[float]:
        raise NotImplementedError

    def read_tiles(self, xys, level: int, size_wh: Tuple[int, int],
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched read_region: (n, h, w, 3) uint8 tiles for n (x, y)
        level-0 coords. Default loops read_region (correct for any
        reader — OpenSlide WSIs cannot materialize a level); array-backed
        readers override with one vectorized gather (the loop is the
        dominant host cost of lazy large-N epochs: ~12.8k Python
        iterations per slide at the 4608^2/32px shape)."""
        w, h = size_wh
        n = len(xys)
        if out is None:
            out = np.empty((n, h, w, 3), np.uint8)
        for k in range(n):
            t = self.read_region((int(xys[k][0]), int(xys[k][1])),
                                 level, size_wh)
            out[k] = t[:h, :w, :3]
        return out

    def read_region(self, xy0: Tuple[int, int], level: int,
                    size_wh: Tuple[int, int]) -> np.ndarray:
        """(x, y) on level 0, size on `level`; returns (h, w, 3|4) uint8."""
        raise NotImplementedError

    def close(self):
        pass


class ArraySlide(SlideReader):
    """In-memory pyramid over one (H, W, 3) uint8 array."""

    def __init__(self, img: np.ndarray, n_levels: int = 3):
        assert img.dtype == np.uint8 and img.ndim == 3
        self._levels = [img]
        for _ in range(n_levels - 1):
            self._levels.append(self._levels[-1][::2, ::2])

    @property
    def level_dimensions(self):
        return [(lv.shape[1], lv.shape[0]) for lv in self._levels]

    @property
    def level_downsamples(self):
        w0 = self._levels[0].shape[1]
        return [w0 / lv.shape[1] for lv in self._levels]

    def read_region(self, xy0, level, size_wh):
        x0, y0 = xy0
        w, h = size_wh
        ds = self.level_downsamples[level]
        x, y = int(x0 / ds), int(y0 / ds)
        lv = self._levels[level]
        out = np.zeros((h, w, 3), np.uint8)
        ys, xs = max(0, y), max(0, x)
        ye, xe = min(lv.shape[0], y + h), min(lv.shape[1], x + w)
        if ye > ys and xe > xs:
            out[ys - y:ye - y, xs - x:xe - x] = lv[ys:ye, xs:xe]
        return out

    def read_tiles(self, xys, level, size_wh, out=None):
        """Vectorized batch read for GRID-ALIGNED tiles on a contiguous
        level (the foreground pipeline emits stride==tile_size grids):
        view the level as a (H/h, W/w, h, w, 3) tile grid and gather the
        n requested tiles with ONE fancy index — no per-tile Python
        loop. Misaligned/out-of-bounds requests and non-contiguous
        levels (the [::2, ::2] downsamples) fall back to the base
        loop."""
        w, h = size_wh
        ds = self.level_downsamples[level]
        lv = self._levels[level]
        xs = (np.asarray([c[0] for c in xys], np.float64) / ds
              ).astype(np.int64)
        ys = (np.asarray([c[1] for c in xys], np.float64) / ds
              ).astype(np.int64)
        gridded = (lv.flags.c_contiguous
                   and len(xs) > 0
                   and (xs % w == 0).all() and (ys % h == 0).all()
                   and (xs >= 0).all() and (ys >= 0).all()
                   and (xs + w <= lv.shape[1]).all()
                   and (ys + h <= lv.shape[0]).all())
        if not gridded:
            return super().read_tiles(xys, level, size_wh, out)
        H2 = (lv.shape[0] // h) * h
        W2 = (lv.shape[1] // w) * w
        grid = lv[:H2, :W2].reshape(H2 // h, h, W2 // w, w, 3)
        tiles = grid[ys // h, :, xs // w]          # (n, h, w, 3)
        if out is None:
            return np.ascontiguousarray(tiles)
        out[:] = tiles
        return out


class OpenSlideReader(SlideReader):
    """Backed by the OpenSlide C library (requires `openslide` binding)."""

    def __init__(self, filename: str):
        import openslide  # gated: not installed in every environment
        self._osr = openslide.OpenSlide(filename)

    @property
    def level_dimensions(self):
        return self._osr.level_dimensions

    @property
    def level_downsamples(self):
        return self._osr.level_downsamples

    def read_region(self, xy0, level, size_wh):
        return np.asarray(self._osr.read_region(xy0, level, size_wh))

    def close(self):
        self._osr.close()


class ImageFileSlide(ArraySlide):
    """Single-resolution image file via PIL, exposed as a tiny pyramid."""

    def __init__(self, filename: str, n_levels: int = 3):
        from PIL import Image
        img = np.asarray(Image.open(filename).convert("RGB"))
        super().__init__(img, n_levels)


def open_slide_file(filename: str) -> SlideReader:
    ext = os.path.splitext(filename)[1].lower()
    if ext in (".tif", ".tiff", ".svs", ".ndpi", ".mrxs"):
        try:
            return OpenSlideReader(filename)
        except ImportError as e:
            raise ImportError(
                f"reading {filename} requires the OpenSlide library "
                "(pip install openslide-python + libopenslide)") from e
    if ext == ".npy":
        return ArraySlide(np.load(filename))
    return ImageFileSlide(filename)


# --------------------------------------------------------------------------
# annotations (ASAP XML, reference datamodel.py:169-202)
# --------------------------------------------------------------------------

@dataclass
class Annotation:
    name: str
    type: str
    part_of_group: str
    color: str
    polygon: List[Point]


def parse_asap_annotations(xml_path: str) -> List[Annotation]:
    root = Xml.parse(xml_path).getroot()
    annotations = []
    for ann in root.iter("Annotation"):
        polygon = [(float(c.get("X")), float(c.get("Y")))
                   for c in ann.iter("Coordinate")]
        annotations.append(Annotation(
            name=ann.get("Name", ""),
            type=ann.get("Type", ""),
            part_of_group=ann.get("PartOfGroup", ""),
            color=ann.get("Color", ""),
            polygon=polygon))
    return annotations


# --------------------------------------------------------------------------
# slide + manager
# --------------------------------------------------------------------------

@dataclass
class Slide:
    name: str
    filename: str
    annotation_filename: Optional[str] = None
    stage: Optional[str] = None
    otsu_thresholds: Dict[int, float] = field(default_factory=dict)
    _reader: Optional[SlideReader] = None
    _annotations: Optional[List[Annotation]] = None

    @classmethod
    def from_array(cls, name: str, img: np.ndarray,
                   polygon: Optional[Sequence[Point]] = None,
                   otsu_thresholds: Optional[Dict[int, float]] = None,
                   n_levels: int = 3) -> "Slide":
        """A slide held in memory: an (H, W, 3) uint8 array and the tumour
        annotation's polygon (level-0 (x, y)) if it has one."""
        anns = ([] if polygon is None else
                [Annotation("_0", "Polygon", "Tumor", "#F4FA58",
                            [tuple(p) for p in polygon])])
        return cls(name, "", otsu_thresholds=dict(otsu_thresholds or {}),
                   _reader=ArraySlide(img, n_levels),
                   _annotations=anns)

    @property
    def is_annotated(self) -> bool:
        return self.annotation_filename is not None or bool(self._annotations)

    @property
    def has_tumor(self) -> bool:
        return self.is_annotated or (self.stage is not None
                                     and self.stage != "negative")

    @property
    def reader(self) -> SlideReader:
        if self._reader is None:
            self._reader = open_slide_file(self.filename)
        return self._reader

    @property
    def annotations(self) -> List[Annotation]:
        if self._annotations is None:
            self._annotations = (parse_asap_annotations(self.annotation_filename)
                                 if self.is_annotated else [])
        return self._annotations

    # reader passthroughs
    @property
    def level_dimensions(self):
        return self.reader.level_dimensions

    @property
    def level_downsamples(self):
        return self.reader.level_downsamples

    def read_region(self, xy0, level, size_wh):
        return self.reader.read_region(xy0, level, size_wh)

    def read_tiles(self, xys, level, size_wh, out=None):
        return self.reader.read_tiles(xys, level, size_wh, out)

    def get_otsu_threshold(self, level: int) -> Optional[float]:
        return self.otsu_thresholds.get(level)

    def close(self):
        if self._reader is not None and self.filename:
            self._reader.close()
            self._reader = None


def find_files(pattern: str, directory: str) -> Dict[str, str]:
    out = {}
    if not os.path.isdir(directory):
        return out
    for root, _, files in os.walk(directory):
        for f in files:
            if fnmatch(f, pattern):
                out[f] = os.path.join(root, f)
    return out


SLIDE_PATTERNS = ("*.tif", "*.tiff", "*.png", "*.jpg", "*.npy")


class SlideManager:
    """Index the CAMELYON16 directory layout (reference datamodel.py:324-506).

    training/normal/*.tif        negative slides
    training/tumor/*.tif         annotated slides (training/lesion_annotations)
    testing/images/*.tif         test slides (testing/lesion_annotations opt.)
    <otsu_fname>                 CSV name,level,threshold
    """

    def __init__(self, *, data_dir: str, otsu_fname: str):
        data_dir = os.path.expanduser(data_dir)
        self._path = {
            "dir": data_dir,
            "negative": os.path.join(data_dir, "training/normal"),
            "positive": os.path.join(data_dir, "training/tumor"),
            "annotations": os.path.join(data_dir, "training/lesion_annotations"),
            "test": os.path.join(data_dir, "testing/images"),
            "test_annotations": os.path.join(data_dir,
                                             "testing/lesion_annotations"),
            "otsu": os.path.join(data_dir, otsu_fname),
        }
        self._slides: "OrderedDict[str, Slide]" = OrderedDict()
        self.slide_paths: "OrderedDict[str, str]" = OrderedDict()
        self.negative_slides: Tuple[Slide, ...] = ()
        self.annotated_slides: Tuple[Slide, ...] = ()
        self.test_slides: Tuple[Slide, ...] = ()
        self.otsu_thresholds: Dict[str, Dict[int, float]] = defaultdict(dict)
        self._load()

    def _load(self):
        try:
            with open(self._path["otsu"]) as f:
                for line in csv.DictReader(f):
                    self.otsu_thresholds[line["name"]][int(line["level"])] = \
                        float(line["threshold"])
        except FileNotFoundError:
            print("No pre-calculated otsu thresholds found.")

        def scan(directory):
            files = {}
            for pat in SLIDE_PATTERNS:
                files.update(find_files(pat, directory))
            return sorted(files.items())

        def add(slide: Slide):
            if slide.name in self._slides:
                raise RuntimeError(
                    f'Slide "{slide.name}" already exists! ({slide.filename})')
            self._slides[slide.name] = slide
            self.slide_paths[slide.name] = slide.filename

        for fname, fpath in scan(self._path["negative"]):
            name = fname.partition(".")[0]
            add(Slide(name, fpath,
                      otsu_thresholds=self.otsu_thresholds[name]))
            self.negative_slides += (self._slides[name],)

        for fname, fpath in scan(self._path["positive"]):
            name = fname.partition(".")[0]
            annot = os.path.join(self._path["annotations"], f"{name}.xml")
            if not os.path.exists(annot):
                raise FileNotFoundError(annot)
            add(Slide(name, fpath, annotation_filename=annot,
                      otsu_thresholds=self.otsu_thresholds[name]))
            self.annotated_slides += (self._slides[name],)

        for fname, fpath in scan(self._path["test"]):
            name = fname.partition(".")[0]
            annot = os.path.join(self._path["test_annotations"], f"{name}.xml")
            add(Slide(name, fpath,
                      annotation_filename=annot if os.path.exists(annot)
                      else None,
                      otsu_thresholds=self.otsu_thresholds[name]))
            self.test_slides += (self._slides[name],)

    @property
    def slides(self) -> Tuple[Slide, ...]:
        return tuple(self._slides.values())

    @property
    def slide_names(self) -> Tuple[str, ...]:
        return tuple(self._slides.keys())

    def get_slide_names_subset(self, train: bool = True) -> Tuple[str, ...]:
        if train:
            return tuple(n for n in self._slides if "test" not in n)
        return tuple(n for n in self._slides if "test" in n)

    def get_slide(self, name: str) -> Slide:
        return self._slides[name]
