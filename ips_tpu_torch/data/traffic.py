"""Swedish Traffic Signs (STS): annotations, filter, augmentation, patches
(counterpart of ips_tpu/data/traffic.py).

What the JAX package's reader does, item for item:

  * the md5 gate on both sets' ``annotations.txt``, bypassed by the
    ``SYNTHETIC`` marker of a generated corpus
    (``ips_tpu_torch.data.traffic_synth``);
  * set choice ``Set{1 + ((seed + 1 + train) % 2)}``;
  * annotation lines parsed into ``Sign`` records, ordered VISIBLE <
    BLURRED < SIDE_ROAD < OCCLUDED, ties by larger area;
  * the class filter: EMPTY / 50_SIGN / 70_SIGN / 80_SIGN, keeping only
    images whose most visible speed-limit sign is VISIBLE;
  * resize to 1200x1600 (``img_size``); on train items torchvision's
    ``ColorJitter(0.1, 0.1, 0.1, 0.1)`` and a shift of up to 100 px
    (scaled with ``img_size``, or ``max_shift``), drawn from
    ``default_rng([seed, i, draw])`` (``TrafficSigns``' draw rule);
    ImageNet normalisation on the host, or uint8 out under ``input_norm:
    imagenet``; patches channels-last.

Items are bitwise the JAX package's. Its download of the two sets is left
out: it needs the network, so ``allow_download=True`` raises where the
JAX package would fetch them.

Images come from files (PIL, imported only to read them) or from memory:
``TrafficSigns(conf, train, images={set: [(name, uint8 (H, W, 3), signs)]})``
for a machine without PIL. The in-memory images must already be at
``img_size``: the file form resizes with PIL, and PIL's resize to the
same size is a copy, so an in-memory item equals the file form's item
on the same pixels.
"""

from __future__ import annotations

import hashlib
import threading
from os import path
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ips_tpu_torch.data.loader import Dataset
from ips_tpu_torch.data.patchify import patchify
from ips_tpu_torch.utils.imagenet import IMAGENET_MEAN, IMAGENET_STD

SET1_ANNOT_MD5 = "9106a905a86209c95dc9b51d12f520d6"
SET2_ANNOT_MD5 = "09debbc67f6cd89c1e2a2688ad1d03ca"
SET1_URL = ("http://www.isy.liu.se/cvl/research/trafficSigns"
            "/swedishSignsSummer/Set1/Set1Part0.zip")
SET2_URL = ("http://www.isy.liu.se/cvl/research/trafficSigns"
            "/swedishSignsSummer/Set2/Set2Part0.zip")

VISIBILITIES = ["VISIBLE", "BLURRED", "SIDE_ROAD", "OCCLUDED"]


def file_md5_ok(filepath: str, md5sum: str) -> bool:
    try:
        md5 = hashlib.md5()
        with open(filepath, "rb") as f:
            while chunk := f.read(1 << 16):
                md5.update(chunk)
        return md5.hexdigest() == md5sum
    except FileNotFoundError:
        return False


def ensure_dataset_exists(directory: str, allow_download: bool = False
                          ) -> None:
    """Raise unless ``directory`` holds both sets: a generated corpus (its
    ``SYNTHETIC`` marker and both annotation files) or the real one (both
    annotation files pass the md5 gate)."""
    if path.exists(path.join(directory, "SYNTHETIC")):
        if (path.exists(path.join(directory, "Set1", "annotations.txt"))
                and path.exists(path.join(directory, "Set2",
                                          "annotations.txt"))):
            return
        raise FileNotFoundError(
            f"synthetic STS marker present but annotations missing under "
            f"{directory}")
    if (file_md5_ok(path.join(directory, "Set1", "annotations.txt"),
                    SET1_ANNOT_MD5)
            and file_md5_ok(path.join(directory, "Set2", "annotations.txt"),
                            SET2_ANNOT_MD5)):
        return
    if not allow_download:
        raise FileNotFoundError(
            f"STS dataset not found/corrupt under {directory}. "
            f"Download Set1/Set2 from {SET1_URL} / {SET2_URL} plus their "
            "annotations.txt files and unzip into Set1/ and Set2/.")
    raise NotImplementedError(
        "downloading STS needs the network and is left out of the port "
        "(ROADMAP.md item 8): fetch Set1/Set2 and their annotations.txt "
        f"from {SET1_URL} / {SET2_URL} by hand and unzip them under "
        f"{directory}")


class Sign(NamedTuple):
    visibility: str
    bbox: Tuple[float, float, float, float]  # (x_max, y_max, x_min, y_min)
    type: str
    name: str

    @property
    def area(self) -> float:
        x_max, y_max, x_min, y_min = self.bbox
        return (x_max - x_min) * (y_max - y_min)

    @property
    def visibility_index(self) -> int:
        return VISIBILITIES.index(self.visibility)

    def sort_key(self):
        # more visible first; among equal visibility, larger area first
        return (self.visibility_index, -self.area)


def _parse_float(x: str) -> float:
    # annotation numbers occasionally carry trailing junk characters,
    # stripped one at a time
    while x:
        try:
            return float(x)
        except ValueError:
            x = x[:-1]
    raise ValueError("unparseable bbox number")


def parse_annotation_line(line: str) -> Tuple[str, List[Sign]]:
    """One stripped ``annotations.txt`` line -> (image file name, signs);
    MISC_SIGNS entries and entries of fewer than 7 fields are dropped."""
    fname, rest = line.split(":", 1)
    signs = []
    for part in rest.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = [s.strip() for s in part.split(",")]
        if fields[0] == "MISC_SIGNS" or len(fields) < 7:
            continue
        signs.append(Sign(
            visibility=fields[0],
            bbox=tuple(_parse_float(v) for v in fields[1:5]),
            type=fields[5],
            name=fields[6]))
    return fname, signs


def parse_annotations(annot_path: str) -> List[Tuple[str, List[Sign]]]:
    """annotations.txt -> [(image filename, [Sign, ...])]."""
    with open(annot_path) as f:
        return [parse_annotation_line(ln.strip()) for ln in f if ln.strip()]


def sts_set(seed: int, train: bool) -> str:
    """The set a split reads: ``Set{1 + ((seed + 1 + train) % 2)}``."""
    return f"Set{1 + ((seed + 1 + int(train)) % 2)}"


class STS:
    """Reads one of the annotation sets as [(image path, signs)]."""

    def __init__(self, directory: str, train: bool = True, seed: int = 0,
                 allow_download: bool = False):
        ensure_dataset_exists(directory, allow_download)
        inner = sts_set(seed, train)
        records = parse_annotations(path.join(directory, inner,
                                              "annotations.txt"))
        self._data = [(path.join(directory, inner, fname), signs)
                      for fname, signs in records]

    def __len__(self):
        return len(self._data)

    def __getitem__(self, i):
        return self._data[i]

    def __iter__(self):
        return iter(self._data)


LIMITS = ["50_SIGN", "70_SIGN", "80_SIGN"]
CLASSES = ["EMPTY", *LIMITS]
IMG_SIZE = (1200, 1600)  # (H, W)


def filter_sts(data) -> List[Tuple[str, int]]:
    """Keep EMPTY images and images whose top speed-limit sign is
    VISIBLE; [(image, class index)]."""
    filtered = []
    for image, signs in data:
        if not signs:
            filtered.append((image, 0))
            continue
        limits = sorted((s for s in signs if s.name in LIMITS),
                        key=Sign.sort_key)
        if not limits:
            continue  # other signs present but no speed limit -> drop
        if limits[0].visibility != "VISIBLE":
            continue
        filtered.append((image, CLASSES.index(limits[0].name)))
    return filtered


# -- augmentations (numpy copies of the torchvision ops) ---------------------

_GRAY_WEIGHTS = np.array([0.2989, 0.587, 0.114], np.float32)


def _rgb_to_hsv(img: np.ndarray):
    """(H, W, 3) float [0,1] -> (h, s, v) planes; torchvision convention
    (h = 0 for achromatic pixels)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(axis=-1)
    minc = img.min(axis=-1)
    cr = maxc - minc
    ones = np.ones_like(maxc)
    s = cr / np.where(maxc == 0, ones, maxc)
    crd = np.where(cr == 0, ones, cr)
    rc = (maxc - r) / crd
    gc = (maxc - g) / crd
    bc = (maxc - b) / crd
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return h, s, maxc


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    # the sector is floor(h * 6) taken in float, then cast: casting first
    # would round h * 6 differently at the sector edges
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    rgb = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q]),
    ], axis=-1)
    return rgb.astype(np.float32)


def _adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """torchvision F.adjust_hue: exact HSV hue rotation by `factor` turns."""
    h, s, v = _rgb_to_hsv(img)
    return _hsv_to_rgb((h + factor) % 1.0, s, v)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 amount: float = 0.1) -> np.ndarray:
    """torchvision's ``ColorJitter(a, a, a, a)``: the four ops in a random
    order with one factor each; brightness, contrast and saturation are
    clamped blends with f ~ U(max(0, 1-a), 1+a), hue an exact RGB<->HSV
    rotation by U(-a, a). The permutation is drawn first, then the four
    factors in this order: another order changes every train item.
    img float32 (H, W, 3) in [0, 1]."""
    def blend(a, b, f):
        return np.clip(f * a + (1.0 - f) * b, 0.0, 1.0).astype(np.float32)

    order = rng.permutation(4)
    lo = max(0.0, 1.0 - amount)
    f_bright = rng.uniform(lo, 1.0 + amount)
    f_contrast = rng.uniform(lo, 1.0 + amount)
    f_sat = rng.uniform(lo, 1.0 + amount)
    f_hue = rng.uniform(-amount, amount)
    for op in order:
        if op == 0:
            img = blend(img, np.zeros((), np.float32), f_bright)
        elif op == 1:
            gray_mean = (img @ _GRAY_WEIGHTS).mean(dtype=np.float32)
            img = blend(img, gray_mean, f_contrast)
        elif op == 2:
            img = blend(img, (img @ _GRAY_WEIGHTS)[..., None], f_sat)
        else:
            img = _adjust_hue(img, f_hue)
    return img


def random_translate(img: np.ndarray, rng: np.random.Generator,
                     max_dx: int = 100, max_dy: int = 100) -> np.ndarray:
    """``RandomAffine(degrees=0, translate=...)``: an integer shift with
    zero fill."""
    dy = int(rng.integers(-max_dy, max_dy + 1))
    dx = int(rng.integers(-max_dx, max_dx + 1))
    H, W = img.shape[:2]
    h, w = H - abs(dy), W - abs(dx)
    out = np.zeros_like(img)
    src_y0, src_x0 = max(0, -dy), max(0, -dx)
    dst_y0, dst_x0 = max(0, dy), max(0, dx)
    out[dst_y0:dst_y0 + h, dst_x0:dst_x0 + w] = \
        img[src_y0:src_y0 + h, src_x0:src_x0 + w]
    return out


# set name -> [(image name, uint8 (H, W, 3), signs)]
ImageSets = Mapping[str, Sequence[Tuple[str, np.ndarray, List[Sign]]]]


class TrafficSigns(Dataset):
    """Filtered STS images -> normalized NHWC patches + class label.

    The draw rule. A train item's color jitter and shift come from
    ``default_rng([seed, i, draw])``. The dataset keeps the draw counter
    (``take_draws``), so that a loader built later goes on where the last
    one stopped. ``DataLoader`` reserves each global batch's draws
    before any thread fetches and hands each item the draw of its place
    in the epoch's global order (``item(i, draw)``); a direct
    ``dataset[i]`` takes the next draw, as the JAX package's items do.
    """

    def __init__(self, conf, train: bool = True, allow_download: bool = False,
                 images: Optional[ImageSets] = None):
        self.patch_size = conf.patch_size
        self.patch_stride = conf.patch_stride
        self.tasks = conf.task_list
        self.train = train
        self.seed = conf.seed
        self.img_size = conf.img_size or IMG_SIZE
        # up to 100 px at 1200x1600, scaled with an img_size override;
        # conf.max_shift pins it in pixels at any size
        if conf.max_shift is not None:
            self.max_shift = (conf.max_shift, conf.max_shift)
        else:
            self.max_shift = (max(1, round(100 * self.img_size[0] / 1200)),
                              max(1, round(100 * self.img_size[1] / 1600)))
        # input_norm='imagenet' normalizes on the device: uint8 patches out
        self.emit_uint8 = conf.input_norm == "imagenet"
        # one generator per item (the loader's threads share none); the
        # counter varies the augmentation across epochs
        self._next_draw = 0
        self._draw_lock = threading.Lock()
        if images is None:
            self._images = None
            self._data = filter_sts(STS(conf.data_dir, train, conf.seed,
                                        allow_download=allow_download))
        else:
            records = images[sts_set(conf.seed, train)]
            want = tuple(self.img_size) + (3,)
            for name, img, _ in records:
                if img.shape != want or img.dtype != np.uint8:
                    raise ValueError(
                        f"in-memory image {name} is {img.dtype} "
                        f"{img.shape}; this form takes uint8 {want} "
                        "(img_size), since only the file form resizes")
            self._images = {name: img for name, img, _ in records}
            self._data = filter_sts([(name, signs)
                                     for name, _, signs in records])

    def __len__(self):
        return len(self._data)

    def take_draws(self, n: int) -> int:
        """The first of n consecutive draws; the counter moves past them."""
        with self._draw_lock:
            first = self._next_draw
            self._next_draw += n
        return first

    def skip_draws(self, n: int) -> None:
        """Advance the augmentation stream by n items, so that a resumed
        run augments as the unbroken run did (``DataLoader.skip_epochs``
        calls it)."""
        self.take_draws(n)

    def _load_image(self, key: str) -> np.ndarray:
        if self._images is not None:
            return np.asarray(self._images[key], np.float32) / 255.0
        from PIL import Image
        img = Image.open(key).convert("RGB")
        img = img.resize((self.img_size[1], self.img_size[0]), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    def augment(self, img: np.ndarray, i: int, draw: int) -> np.ndarray:
        """Item i's color jitter and shift at ``draw``, from a generator
        of its own."""
        rng = np.random.default_rng([self.seed, i, draw])
        img = color_jitter(img, rng)
        return random_translate(img, rng, max_dy=self.max_shift[0],
                                max_dx=self.max_shift[1])

    def to_patches(self, img: np.ndarray) -> np.ndarray:
        """Normalized fp32 (or uint8 under input_norm: imagenet) patches."""
        if self.emit_uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        else:
            img = ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        return patchify(img, self.patch_size, self.patch_stride)

    def item(self, i: int, draw: int) -> Dict[str, np.ndarray]:
        """Item i, augmented at ``draw`` when it is a train item."""
        key, category = self._data[i]
        img = self._load_image(key)
        if self.train:
            img = self.augment(img, i, draw)
        out = {"input": self.to_patches(img)}
        for t in self.tasks:
            out[t.name] = np.int64(category)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.item(i, self.take_draws(1))
