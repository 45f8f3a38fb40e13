"""The port's camelyon_e2e path (raw slide tiles) against ips_tpu's.

``data/camelyon/slide.py``: the in-memory pyramid's levels, the grid
``read_tiles`` against the per-tile loop on every path (and against the
JAX package's), ASAP annotation parsing and the ``SlideManager`` index.
``CamelyonPatches``: items byte-equal to the JAX package's on a corpus
that its otsu and foreground CLIs write to a temp dir (as
tests/test_camelyon.py:507-523 does), and the in-memory ``slides=`` form
byte-equal to the pickle form. Then a tiny ``python -m ips_tpu_torch.main
--dataset camelyon_e2e`` run on the CPU: streaming selection, the
chunked gradient re-encode, finite metrics.
"""

import json
import os

import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.camelyon import patches as jpatches
from ips_tpu.data.camelyon import slide as jslide
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.camelyon import patches as tpatches
from ips_tpu_torch.data.camelyon import slide as tslide
from ips_tpu_torch.main import build_datasets, main

from test_camelyon import ASAP_XML, _tissue_image

TASKS = {"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                   "metric": "auc"}}


def e2e_conf(data_dir, **over):
    d = dict(n_epoch=2, B=2, B_seq=1, n_epoch_warmup=1, lr=1e-3, wd=0.1,
             n_class=1, data_dir=data_dir, n_worker=2, eager=False,
             stream_chunk_group=2, is_image=True, enc_type="resnet50",
             n_chan_in=3, n_res_blocks=2, shuffle=True, n_token=1, N=0,
             M=4, I=4, patch_size=[64, 64], patch_stride=[64, 64],
             use_pos=False, H=2, D=512, D_k=8, D_v=8, D_inner=32,
             compute_dtype="float32", grad_encode_chunk=2, tasks=TASKS)
    d.update(over)
    return d


# ------------------------------------------------------------ slide model
def test_array_slide_levels_match_jax():
    img = _tissue_image(400, 336)
    t, j = tslide.ArraySlide(img, n_levels=3), jslide.ArraySlide(img, 3)
    assert t.level_dimensions == j.level_dimensions == [
        (336, 400), (168, 200), (84, 100)]
    assert t.level_downsamples == j.level_downsamples
    for lvl in range(3):
        np.testing.assert_array_equal(
            t.read_region((100, 60), lvl, (50, 40)),
            j.read_region((100, 60), lvl, (50, 40)))


@pytest.mark.parametrize("xys,lvl", [
    ([(0, 0), (32, 64), (352, 320), (64, 32), (320, 352)], 0),  # the grid
    ([(7, 13), (100, 50)], 0),                         # misaligned
    ([(0, 0), (64, 64)], 1),                           # a strided level
    ([(384, 352), (400, 368)], 0),                     # partly outside
    ([], 0)], ids=["grid", "misaligned", "level1", "out_of_bounds", "empty"])
def test_read_tiles_matches_loop_and_jax(xys, lvl):
    img = _tissue_image(416, 384)
    t = tslide.ArraySlide(img, n_levels=3)
    loop = np.zeros((len(xys), 32, 32, 3), np.uint8)
    for k, (x, y) in enumerate(xys):
        loop[k] = t.read_region((x, y), lvl, (32, 32))
    got = t.read_tiles(xys, lvl, (32, 32))
    np.testing.assert_array_equal(got, loop)
    np.testing.assert_array_equal(
        got, jslide.ArraySlide(img, 3).read_tiles(xys, lvl, (32, 32)))
    out = np.ones_like(loop)
    assert t.read_tiles(xys, lvl, (32, 32), out=out) is out
    np.testing.assert_array_equal(out, loop)


def test_parse_asap_matches_jax(tmp_path):
    p = tmp_path / "a.xml"
    p.write_text(ASAP_XML)
    got = tslide.parse_asap_annotations(str(p))
    want = jslide.parse_asap_annotations(str(p))
    assert [vars(a) for a in got] == [vars(a) for a in want]
    assert got[0].polygon == [(100.5, 200.5), (300.0, 200.5),
                              (300.0, 400.0)]
    assert got[0].part_of_group == "Tumor"


def _write_cam16(d, n_normal=1):
    from PIL import Image
    for sub in ["training/normal", "training/tumor",
                "training/lesion_annotations", "testing/images",
                "testing/lesion_annotations"]:
        (d / sub).mkdir(parents=True)
    for i in range(n_normal):
        Image.fromarray(_tissue_image(300, 300, seed=i)).save(
            d / f"training/normal/normal_{i + 1:03d}.png")
    img = _tissue_image(320, 300, seed=7)
    img[60:120, 60:130, 0] = 250                  # a brighter lesion
    Image.fromarray(img).save(d / "training/tumor/tumor_001.png")
    (d / "training/lesion_annotations/tumor_001.xml").write_text(ASAP_XML)
    np.save(d / "testing/images/test_001.npy", _tissue_image(256, 384, 3))
    Image.fromarray(_tissue_image(300, 300, 4)).save(
        d / "testing/images/test_002.png")
    (d / "testing/lesion_annotations/test_002.xml").write_text(ASAP_XML)


def test_slide_manager_matches_jax(tmp_path):
    _write_cam16(tmp_path)
    with open(tmp_path / "otsu.csv", "w") as f:
        f.write("name,level,threshold\nnormal_001,0,12.5\n")
    t = tslide.SlideManager(data_dir=str(tmp_path), otsu_fname="otsu.csv")
    j = jslide.SlideManager(data_dir=str(tmp_path), otsu_fname="otsu.csv")
    assert t.slide_names == j.slide_names == (
        "normal_001", "tumor_001", "test_001", "test_002")
    for name in t.slide_names:
        a, b = t.get_slide(name), j.get_slide(name)
        assert (a.has_tumor, a.otsu_thresholds, a.level_dimensions) == (
            b.has_tumor, b.otsu_thresholds, b.level_dimensions)
    assert isinstance(t.get_slide("test_001").reader, tslide.ArraySlide)
    assert t.get_slide_names_subset(False) == ("test_001", "test_002")


# ------------------------------------------------------------- the dataset
@pytest.fixture(scope="module")
def e2e_dir(tmp_path_factory):
    """A small CAMELYON16 layout, indexed by the JAX package's otsu and
    foreground CLIs at 64-pixel tiles."""
    from ips_tpu.data.camelyon.foreground import compute_foreground
    from ips_tpu.data.camelyon.otsu import compute_thresholds
    d = tmp_path_factory.mktemp("cam16_e2e")
    _write_cam16(d, n_normal=2)
    compute_thresholds(str(d), "otsu.csv", n_worker=1)
    for train in (True, False):
        compute_foreground(str(d), "otsu.csv", str(d / "fg"), train=train,
                           tile_size=64, fg_perc_thresh=0.05, n_worker=1)
    return str(d)


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("max_tiles", [None, 5])
def test_patches_match_jax(e2e_dir, train, max_tiles):
    c = e2e_conf(e2e_dir)
    t = tpatches.CamelyonPatches(t_config(c), train=train,
                                 max_tiles=max_tiles)
    j = jpatches.CamelyonPatches(j_config(c), train=train,
                                 max_tiles=max_tiles)
    assert len(t) == len(j) == (3 if train else 2)
    assert t.buckets == j.buckets
    assert t._ns == j._ns
    for i in range(len(j)):
        assert t.bucket_of(i) == j.bucket_of(i)
        item = t[i]
        _assert_items_equal(item, j[i])
        assert item["input"].dtype == np.uint8
        assert item["input"].shape == (t.bucket_of(i), 64, 64, 3)
    labels = [int(t[i]["metastases"]) for i in range(len(t))]
    assert labels == ([0, 0, 1] if train else [0, 1])


def test_slides_form_matches_pickles(e2e_dir):
    """The in-memory form of the same slides gives every item byte for
    byte, in the same order."""
    conf = t_config(e2e_conf(e2e_dir))
    for train in (True, False):
        ds = tpatches.CamelyonPatches(conf, train=train)
        slides = {ds.slide_names[i]: (ds[i]["input"][:ds._ns[i]],
                                      int(ds[i]["metastases"]))
                  for i in range(len(ds))}
        mem = tpatches.CamelyonPatches(conf, train=train, slides=slides)
        assert mem.slide_names == ds.slide_names
        assert mem.buckets == ds.buckets
        for i in range(len(ds)):
            _assert_items_equal(mem[i], ds[i])


def test_slides_form_checks_tile_shape():
    conf = t_config(e2e_conf("unused"))
    ds = tpatches.CamelyonPatches(
        conf, slides={"s": (np.zeros((3, 32, 32, 3), np.uint8), 1)})
    with pytest.raises(ValueError, match="tiles"):
        ds[0]


def test_synth_tile_slides():
    slides = tpatches.synth_tile_slides([5, 9, 3], tile_hw=(8, 8), seed=2,
                                        pool=4)
    assert list(slides) == ["slide_000", "slide_001", "slide_002"]
    assert [(v[0].shape, v[1]) for v in slides.values()] == [
        ((5, 8, 8, 3), 0), ((9, 8, 8, 3), 1), ((3, 8, 8, 3), 0)]
    again = tpatches.synth_tile_slides([5, 9, 3], tile_hw=(8, 8), seed=2,
                                       pool=4)
    for k in slides:
        np.testing.assert_array_equal(slides[k][0], again[k][0])
    # only the tumour slide has tiles shifted towards red
    def red_excess(tiles):
        t = tiles.astype(np.float64)
        return (t[..., 0] - t[..., 1]).mean(axis=(1, 2))
    assert red_excess(slides["slide_001"][0]).max() > 20
    assert red_excess(slides["slide_000"][0]).max() < 20


def test_build_datasets(e2e_dir):
    train, test = build_datasets(t_config(e2e_conf(e2e_dir)),
                                 "camelyon_e2e")
    assert isinstance(train, tpatches.CamelyonPatches)
    assert (len(train), len(test)) == (3, 2)


def test_cli_runs_on_cpu(e2e_dir, tmp_path):
    """Two epochs of the driver at tiny widths: the lazy schedules, every
    metric line finite and in range, the parameters finite."""
    metrics = str(tmp_path / "m.jsonl")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(e2e_conf(e2e_dir, metrics_path=metrics)))
    torch.manual_seed(0)
    trainer, _, _ = main(["--dataset", "camelyon_e2e", "--config", str(cfg),
                          "--device", "cpu"])
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["epoch"], r["split"]) for r in rows] == [
        (0, "train"), (0, "test"), (1, "train"), (1, "test")]
    for r in rows:
        assert np.isfinite(r["metastases_loss"]) and r["metastases_loss"] > 0
        assert 0.0 <= r["metastases_auc"] <= 1.0
    assert trainer.step == 4
    assert all(bool(torch.isfinite(p).all())
               for p in trainer.model.parameters())
