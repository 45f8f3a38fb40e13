"""The port's slide-preprocessing pipeline against ips_tpu's:
synthetic corpus -> otsu -> foreground -> extract_feat, and viz.

Every comparison here is exact:
- ``methods``: grayscale, histogram Otsu, the component mask, the chunked
  threshold, tile splitting and the tumour mask equal JAX's; the port's
  polygon fill, which needs no OpenCV, equals ``cv2.fillPoly`` bitwise on
  random and hypothesis-drawn polygons and on the corpus's lesions;
- the synthetic corpus: PNG pixels and ASAP XML bytes equal
  ``generate_synth_camelyon``'s at one seed, and the in-memory slides
  equal the files;
- the otsu CSV bytes, the foreground pickles (``DataFrame.equals``, the
  blank-slide skip included) and the HDF5 features of a toy encoder
  (datasets and attributes) equal JAX's; the in-memory forms equal the
  file forms;
- the viz images are pixel-equal.
"""

import csv
import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ips_tpu.data.camelyon import extract_feat as j_ex
from ips_tpu.data.camelyon import foreground as j_fg
from ips_tpu.data.camelyon import methods as j_m
from ips_tpu.data.camelyon import otsu as j_otsu
from ips_tpu.data.camelyon import slide as j_slide
from ips_tpu.data.camelyon import synth as j_synth
from ips_tpu.data.camelyon import viz as j_viz
from ips_tpu_torch.data.camelyon import extract_feat as t_ex
from ips_tpu_torch.data.camelyon import foreground as t_fg
from ips_tpu_torch.data.camelyon import methods as t_m
from ips_tpu_torch.data.camelyon import otsu as t_otsu
from ips_tpu_torch.data.camelyon import slide as t_slide
from ips_tpu_torch.data.camelyon import synth as t_synth
from ips_tpu_torch.data.camelyon import viz as t_viz

from test_camelyon import _tissue_image

CORPUS = dict(n_normal=2, n_tumor=2, n_test=2, height=320, width=288,
              seed=3, contrast=0.6, contrast_min=0.2)
TILE = 32


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX package's corpus on disk, with its otsu CSV and foreground
    pickles, and the port's in-memory slides from the same seed."""
    root = tmp_path_factory.mktemp("cam16")
    jdir = str(root / "jax")
    j_synth.generate_synth_camelyon(jdir, **CORPUS)
    j_otsu.compute_thresholds(jdir, "otsu.csv", n_worker=1)
    for train in (True, False):
        j_fg.compute_foreground(jdir, "otsu.csv", os.path.join(jdir, "fg"),
                                train=train, tile_size=TILE, n_worker=1)
    mem = list(t_synth.synth_camelyon_slides(**CORPUS))
    return root, jdir, mem


# ---------------------------------------------------------------- methods
def test_rgb2gray_and_alpha_equal_jax():
    rgba = np.random.default_rng(0).integers(0, 256, (17, 23, 4), np.uint8)
    np.testing.assert_array_equal(t_m.remove_alpha_channel(rgba),
                                  j_m.remove_alpha_channel(rgba))
    rgb = t_m.remove_alpha_channel(rgba)
    np.testing.assert_array_equal(t_m.rgb2gray(rgb), j_m.rgb2gray(rgb))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_by_hist_and_component_mask_equal_jax(seed):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.choice(500, 60, replace=False)).astype(np.float64)
    hist = rng.integers(1, 1000, 60)
    assert t_m.otsu_by_hist(hist, vals) == j_m.otsu_by_hist(hist, vals)
    img = rng.random((40, 50)) * 100
    np.testing.assert_array_equal(
        t_m.create_otsu_mask_by_threshold(img, 60.0),
        j_m.create_otsu_mask_by_threshold(img, 60.0))


@pytest.mark.parametrize("level,step", [(0, 128), (0, 1000), (1, 100)])
def test_chunked_otsu_equal_jax(level, step):
    img = _tissue_image(300, 260, seed=4)
    got = t_m.get_otsu_threshold(t_slide.ArraySlide(img), level, step)
    assert got == j_m.get_otsu_threshold(j_slide.ArraySlide(img), level,
                                         step)


def _both_slides(img, polygon, name="s"):
    ann = [(float(x), float(y)) for x, y in polygon]
    t = t_slide.Slide.from_array(name, img, ann)
    j = j_slide.Slide(name, "unused")
    j._reader = j_slide.ArraySlide(img)
    j.annotation_filename = "x"
    j._annotations = [j_slide.Annotation("_0", "Polygon", "Tumor", "",
                                         ann)]
    return t, j


@pytest.mark.parametrize("lvl,tile,overlap", [(0, 64, 0), (0, 50, 10),
                                              (1, 32, 0)])
def test_split_slide_equal_jax(lvl, tile, overlap):
    img = _tissue_image(320, 300, seed=5)
    t, j = _both_slides(img, [(60, 90), (200, 80), (230, 250), (70, 260)])
    th = j_m.get_otsu_threshold(j, 0, 1000)
    got = list(t_m.split_slide(t, lvl, th, 0.05, tile, overlap))
    want = list(j_m.split_slide(j, lvl, th, 0.05, tile, overlap))
    assert [b for _, b in got] == [b for _, b in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Overlap"):
        list(t_m.split_slide(t, 0, th, 0.05, 32, 32))


def _cv2_fill(shape, polys):
    import cv2
    want = np.zeros(shape, np.uint8)
    cv2.fillPoly(want, [np.asarray(p, np.int32) for p in polys], 1)
    return want


@pytest.mark.parametrize("span", [10, 60, 300, 6000])
def test_fill_poly_is_cv2_fill_poly(span):
    """``fill_poly`` against ``cv2.fillPoly`` bitwise on random int32
    polygons (1-3 contours of 1-11 points, self-intersecting ones
    included) around and across the border of random masks."""
    rng = np.random.default_rng(span)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        polys = [rng.integers(-span, span + max(h, w), (rng.integers(1, 12),
                                                       2)).astype(np.int32)
                 for _ in range(rng.integers(1, 4))]
        got = t_m.fill_poly(np.zeros((h, w), np.uint8), polys)
        np.testing.assert_array_equal(got, _cv2_fill((h, w), polys))


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.floats(-80, 200), st.floats(-80, 200)),
                min_size=1, max_size=14),
       st.integers(0, 1), st.integers(-40, 120), st.integers(-40, 120),
       st.integers(1, 90), st.integers(1, 90))
def test_tumor_mask_is_cv2_fill_poly(poly, level, x, y, w, h):
    """The tumour mask equals OpenCV's fill of the rounded polygon (the
    JAX package's), bitwise, for a whole level and for a window."""
    img = np.zeros((128, 112, 3), np.uint8)
    t, j = _both_slides(img, poly)
    for bounds in (None, ((x, y), (w, h))):
        got = t_m.create_tumor_mask(t, level, bounds)
        np.testing.assert_array_equal(got, j_m.create_tumor_mask(j, level,
                                                                 bounds))
        start, size = bounds or ((0, 0), t.level_dimensions[level])
        ds = t.level_downsamples[level]
        pts = np.asarray(poly, np.float64)
        pts = np.round(np.stack([(pts[:, 0] - start[0]) / ds,
                                 (pts[:, 1] - start[1]) / ds], 1))
        np.testing.assert_array_equal(got, _cv2_fill((size[1], size[0]),
                                                     [pts]))


@pytest.mark.parametrize("scale", [1.0, 17.5])
def test_tumor_masks_of_the_corpus_equal_jax(corpus, scale):
    """The synthetic corpus's lesion polygons (and the same polygons at
    the 5600-px slide scale), as ``split_slide`` asks for them: the whole
    level and every tile row of 32 (or 256) px, levels 0 and 1."""
    _, _, mem = corpus
    tile = 32 if scale == 1.0 else 256
    for s in mem:
        if s.polygon is None:
            continue
        poly = [(round(x * scale, 1), round(y * scale, 1))
                for x, y in s.polygon]
        H, W = (int(v * scale) for v in s.img.shape[:2])
        img = np.zeros((H, W, 3), np.uint8)
        t, j = _both_slides(img, poly, s.name)
        for level in (0, 1):
            rows = [None] + [((0, y), (W, tile)) for y in range(0, H, tile)]
            for bounds in rows:
                np.testing.assert_array_equal(
                    t_m.create_tumor_mask(t, level, bounds),
                    j_m.create_tumor_mask(j, level, bounds))


# ----------------------------------------------------------------- corpus
def test_synth_files_equal_jax(corpus, tmp_path):
    _, jdir, mem = corpus
    tdir = str(tmp_path / "port")
    t_synth.generate_synth_camelyon(tdir, **CORPUS)
    jfiles = [f for f in _files(jdir) if f.endswith((".png", ".xml"))]
    assert _files(tdir) == jfiles
    for f in jfiles:
        a, b = os.path.join(tdir, f), os.path.join(jdir, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)))
        else:
            assert open(a).read() == open(b).read(), f
    # the in-memory slides are the files, their polygons the XML's
    man = j_slide.SlideManager(data_dir=jdir, otsu_fname="otsu.csv")
    assert [s.name for s in mem] == sorted(man.slide_names,
                                           key=lambda n: (
                                               ("normal", "tumor",
                                                "test").index(
                                                   n.split("_")[0]), n))
    for s in mem:
        js = man.get_slide(s.name)
        np.testing.assert_array_equal(s.img, js.read_region(
            (0, 0), 0, js.level_dimensions[0]))
        assert s.label == int(js.has_tumor)
        assert s.polygon == (js.annotations[0].polygon if js.annotations
                             else None)
        js.close()


def test_synth_cli_writes_the_corpus(tmp_path):
    t_synth.main(["--n_normal", "1", "--n_tumor", "1", "--n_test", "0",
                  "--height", "64", "--width", "64", str(tmp_path)])
    assert _files(str(tmp_path)) == [
        "training/lesion_annotations/tumor_000.xml",
        "training/normal/normal_000.png", "training/tumor/tumor_000.png"]


def _mem_slides(mem, otsu=None):
    return {s.name: t_slide.Slide.from_array(
        s.name, s.img, s.polygon,
        otsu_thresholds=None if otsu is None else {0: otsu[s.name]})
        for s in mem}


@pytest.mark.parametrize("n_worker", [1, 2])
def test_otsu_csv_equal_jax(corpus, tmp_path, n_worker):
    root, jdir, mem = corpus
    tdir = str(tmp_path / "port")
    t_synth.generate_synth_camelyon(tdir, **CORPUS)
    out = t_otsu.compute_thresholds(tdir, "otsu.csv", n_worker=n_worker)
    assert open(out).read() == open(os.path.join(jdir, "otsu.csv")).read()
    rows = t_otsu.otsu_thresholds({s.name: s.img for s in mem},
                                  n_worker=n_worker)
    with open(out) as f:
        want = {r["name"]: float(r["threshold"]) for r in csv.DictReader(f)}
    assert {n: t for n, _, t in rows} == want
    assert [n for n, _, _ in rows] == [s.name for s in mem]


def _otsu(jdir):
    with open(os.path.join(jdir, "otsu.csv")) as f:
        return {r["name"]: float(r["threshold"]) for r in csv.DictReader(f)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_foreground_pickles_equal_jax(corpus, tmp_path, train):
    _, jdir, mem = corpus
    sub = "train" if train else "test"
    out = str(tmp_path / "fg")
    c_p, b_p = t_fg.compute_foreground(jdir, "otsu.csv", out, train=train,
                                       tile_size=TILE, n_worker=2)
    for got, name in ((c_p, "coords"), (b_p, "bounds")):
        want = pd.read_pickle(os.path.join(jdir, "fg", f"{name}_{sub}.pkl"))
        assert pd.read_pickle(got).equals(want), name
    # the in-memory form: the same columns
    slides = {n: s for n, s in _mem_slides(mem, _otsu(jdir)).items()
              if ("test" in n) != train}
    coords, bounds = t_fg.foreground_tables(slides, tile_size=TILE)
    want_c = pd.read_pickle(c_p)
    want_b = pd.read_pickle(b_p)
    for col in want_c:
        np.testing.assert_array_equal(coords[col], want_c[col].to_numpy())
    for col in want_b:
        np.testing.assert_array_equal(bounds[col], want_b[col].to_numpy())


def test_foreground_skips_a_blank_slide_as_jax(tmp_path, capsys):
    d = str(tmp_path / "blank")
    t_synth.generate_synth_camelyon(d, n_normal=1, n_tumor=1, n_test=0,
                                    height=128, width=128, seed=1)
    Image.fromarray(np.full((128, 128, 3), 250, np.uint8)).save(
        os.path.join(d, "training/normal/normal_009.png"))
    with open(os.path.join(d, "otsu.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "level", "threshold"])
        for n in ("normal_000", "normal_009", "tumor_000"):
            w.writerow([n, 0, 12.5])
    got = t_fg.compute_foreground(d, "otsu.csv", os.path.join(d, "t"),
                                  tile_size=TILE, n_worker=1)
    want = j_fg.compute_foreground(d, "otsu.csv", os.path.join(d, "j"),
                                   tile_size=TILE, n_worker=1)
    for g, w in zip(got, want):
        assert pd.read_pickle(g).equals(pd.read_pickle(w))
    assert "normal_009" not in set(pd.read_pickle(got[1])["name"])
    assert "slide normal_009 produced no foreground tiles" in \
        capsys.readouterr().err
    blank = t_slide.Slide.from_array(
        "normal_009", np.full((128, 128, 3), 250, np.uint8),
        otsu_thresholds={0: 20.0})
    coords, bounds = t_fg.foreground_tables({"normal_009": blank},
                                            tile_size=TILE)
    assert len(coords["x"]) == 0 and len(bounds["name"]) == 0
    with pytest.raises(ValueError, match="no otsu threshold"):
        t_fg.foreground_tables({"x": t_slide.Slide.from_array(
            "x", np.zeros((64, 64, 3), np.uint8))})


# -------------------------------------------------------------- extraction
def toy(batch):          # (B, h, w, 3) float -> (B, 8)
    return batch.mean(axis=(1, 2)).repeat(3, axis=-1)[:, :8]


class AsyncToy:
    """Pipeline-API encoder whose fetch is deferred, so that a misordered
    dispatch/fetch pairing would show in the output."""

    def dispatch(self, tiles_u8):
        return np.array(tiles_u8)

    def fetch(self, handle):
        return toy(handle.astype(np.float32) / 255.0)


def _h5(path):
    with h5py.File(path) as f:
        return {n: (f[n]["img"][:], f[n]["pos"][:], f[n].attrs["label"],
                    f[n]["img"].dtype, f[n]["pos"].dtype,
                    f[n]["img"].compression) for n in f}


@pytest.mark.parametrize("sub", ["train", "test"])
def test_extract_features_toy_equal_jax(corpus, tmp_path, sub):
    """The fast counterpart of the JAX package's slow pipeline test: the
    same HDF5 datasets and attributes from the same toy encoder, eager
    or pipelined; the in-memory form returns the same fields."""
    _, jdir, mem = corpus
    fg = os.path.join(jdir, "fg")
    args = (jdir, "otsu.csv", os.path.join(fg, f"bounds_{sub}.pkl"),
            os.path.join(fg, f"coords_{sub}.pkl"))
    kw = dict(tile_size=TILE, batch_size=5)
    want = _h5(j_ex.extract_features(*args, str(tmp_path / "j.h5"),
                                     encoder=toy, **kw))
    got = _h5(t_ex.extract_features(*args, str(tmp_path / "t.h5"),
                                    encoder=toy, **kw))
    piped = _h5(t_ex.extract_features(*args, str(tmp_path / "p.h5"),
                                      encoder=AsyncToy(), **kw))
    assert list(got) == list(want) == list(piped)
    for n in want:
        for g, p, w in zip(got[n], piped[n], want[n]):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(p, w)
    coords = pd.read_pickle(args[3])
    bounds = pd.read_pickle(args[2])
    mem_out = t_ex.extract_slide_features(
        _mem_slides(mem), {c: coords[c].to_numpy() for c in coords},
        {c: bounds[c].to_numpy() for c in bounds}, encoder=toy, **kw)
    assert list(mem_out) == list(want)
    for n, (img, pos, label, *_) in want.items():
        np.testing.assert_array_equal(mem_out[n]["img"], img)
        np.testing.assert_array_equal(mem_out[n]["pos"], pos)
        assert mem_out[n]["pos"].dtype == np.int64
        assert mem_out[n]["label"] == label


def test_extract_writer_error_is_raised(corpus, tmp_path):
    _, jdir, _ = corpus
    fg = os.path.join(jdir, "fg")
    with pytest.raises(Exception):
        t_ex.extract_features(
            jdir, "otsu.csv", os.path.join(fg, "bounds_train.pkl"),
            os.path.join(fg, "coords_train.pkl"), str(tmp_path / "bad.h5"),
            tile_size=TILE, batch_size=4,
            encoder=lambda b: np.zeros((), np.float32))


def test_pipelined_encoder_on_cpu_is_the_encoder(tmp_path):
    """The CLI's encoder on the CPU: ResNet-50 with 4 stages, bf16,
    uint8 tiles normalized as x / 255, the tail batch padded; its rows
    equal the encoder's forward on the same tiles."""
    from ips_tpu_torch.models.pretrained import (save_npz,
                                                 seeded_state_dict,
                                                 torch_resnet_to_flat)
    npz = str(tmp_path / "w.npz")
    save_npz(npz, torch_resnet_to_flat(seeded_state_dict("resnet50", 1),
                                       "resnet50"))
    enc = t_ex.PipelinedEncoder(pretrained_path=npz, batch_size=4,
                                device="cpu")
    tiles = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3),
                                              np.uint8)
    got = enc.fetch(enc.dispatch(tiles))
    assert got.shape == (3, 2048) and got.dtype == np.float32
    x = torch.zeros((4, 32, 32, 3))
    x[:3] = torch.from_numpy(tiles).float() / 255.0
    with torch.no_grad():
        want = enc.model(x)[:3].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(enc(tiles.astype(np.float32) / 255.0),
                                  got)
    with pytest.raises(ValueError, match="batch_size"):
        enc.dispatch(np.zeros((5, 32, 32, 3), np.uint8))
    assert enc.model.conv1.dtype == torch.bfloat16
    assert t_ex.center_crop(np.zeros((256, 250, 3)), 224).shape == \
        (224, 224, 3)


# --------------------------------------------------------------------- viz
def _ann(mod):
    return mod.Annotation("a", "Polygon", "Tumor", "#F4FA58",
                          [(100.0, 120.0), (250.0, 120.0), (250.0, 300.0),
                           (100.0, 300.0)])


@pytest.mark.parametrize("level,padding", [(0, 20), (1, 0), (4, 100)])
def test_viz_images_equal_jax(level, padding):
    img = _tissue_image(400, 400, seed=7)
    ts = t_slide.Slide.from_array("s", img)
    js = j_slide.Slide("s", "unused")
    js._reader = j_slide.ArraySlide(img)
    lv = min(level, 2)            # annotation_image clamps to the pyramid
    assert t_viz.annotation_boundaries(_ann(t_slide), ts, lv, padding) \
        == j_viz.annotation_boundaries(_ann(j_slide), js, lv, padding)
    got = t_viz.annotation_image(_ann(t_slide), ts, level=level,
                                 padding=padding)
    want = j_viz.annotation_image(_ann(j_slide), js, level=level,
                                  padding=padding)
    assert got.mode == want.mode
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    poly = [(10, 20), (30, 40), (5, 44)]
    assert t_viz.get_relative_polygon(poly, (3, 4), 2.0) == \
        j_viz.get_relative_polygon(poly, (3, 4), 2.0)
    base = Image.new("RGB", (50, 50), (255, 255, 255))
    np.testing.assert_array_equal(
        np.asarray(t_viz.draw_polygon(base, poly, fill=(0, 0, 0, 120),
                                      outline="#FF0000")),
        np.asarray(j_viz.draw_polygon(base, poly, fill=(0, 0, 0, 120),
                                      outline="#FF0000")))
