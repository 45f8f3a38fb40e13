"""The traffic-sign data path of the port against ips_tpu's: annotation
parsing and the class filter, the augmentations, the synthetic corpus,
``TrafficSigns`` items (file and in-memory forms), the resume draws and
``python -m ips_tpu_torch.main --dataset traffic``.

Same numpy-seeded inputs on both sides. Every comparison is exact:
parsed records, filter output, augmented arrays and items bitwise, the
generated files byte for byte, since the port does the JAX package's
numpy operations in the same order on the same data.
"""

import filecmp
import json
import os

import numpy as np
import pytest

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data import loader as j_loader
from ips_tpu.data import traffic as jt
from ips_tpu.data import traffic_synth as js
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data import loader as t_loader
from ips_tpu_torch.data import traffic as tt
from ips_tpu_torch.data import traffic_synth as ts

from test_traffic import ANNOTATIONS

TASKS = {"task0": {"id": 0, "name": "sign", "act_fn": "softmax",
                   "metric": "accuracy"}}
SYNTH = dict(n_per_set=12, height=120, width=160, seed=0)


def conf_dict(data_dir, **over):
    """A tiny traffic config: 120x160 images cut into 20-px patches."""
    d = dict(n_epoch=1, B=4, B_seq=4, n_epoch_warmup=1, lr=1e-3, wd=0.1,
             n_class=4, data_dir=data_dir, n_worker=0, is_image=True,
             enc_type="resnet18", n_chan_in=3, n_res_blocks=4,
             shuffle=False, n_token=1, N=48, M=4, I=8,
             patch_size=[20, 20], patch_stride=[20, 20], img_size=[120, 160],
             use_pos=False, H=2, D=512, D_k=8, D_v=8, D_inner=64,
             compute_dtype="float32", donate_buffers=False, tasks=TASKS)
    d.update(over)
    return d


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sts"))
    js.generate_synth_sts(d, **SYNTH)
    return d


# ------------------------------------------------------ parsing and filter
def test_parse_and_filter_fixture_as_jax(tmp_path):
    p = tmp_path / "annotations.txt"
    p.write_text(ANNOTATIONS + "\n")
    got, want = tt.parse_annotations(str(p)), jt.parse_annotations(str(p))
    assert got == want and len(got) == 5
    for (_, gs), (_, ws) in zip(got, want):
        assert [s.sort_key() for s in gs] == [s.sort_key() for s in ws]
    assert tt.filter_sts(got) == jt.filter_sts(want)


def test_sign_order_and_filter_as_jax():
    rows = [
        ("a", []),
        ("b", [("VISIBLE", (85, 175, 35, 135), "t", "50_SIGN")]),
        ("c", [("OCCLUDED", (90, 180, 40, 140), "t", "50_SIGN")]),
        ("d", [("VISIBLE", (60, 160, 20, 120), "t", "PED")]),
        ("e", [("BLURRED", (80, 170, 30, 130), "t", "80_SIGN"),
               ("VISIBLE", (85, 175, 35, 135), "t", "50_SIGN")]),
        ("f", [("SIDE_ROAD", (500, 500, 0, 0), "t", "70_SIGN"),
               ("SIDE_ROAD", (10, 10, 0, 0), "t", "80_SIGN"),
               ("VISIBLE", (10, 10, 0, 0), "t", "70_SIGN"),
               ("VISIBLE", (100, 100, 0, 0), "t", "80_SIGN")]),
    ]
    out = {}
    for mod in (tt, jt):
        data = [(n, [mod.Sign(*s) for s in signs]) for n, signs in rows]
        ranked = sorted(data[-1][1], key=mod.Sign.sort_key)
        out[mod] = (mod.filter_sts(data), [tuple(s) for s in ranked],
                    [s.sort_key() for s in ranked])
    assert out[tt] == out[jt]
    assert out[tt][0] == [("a", 0), ("b", 1), ("e", 1), ("f", 3)]


def test_parse_synth_annotations_as_jax(synth_dir):
    for s in ("Set1", "Set2"):
        p = os.path.join(synth_dir, s, "annotations.txt")
        got, want = tt.parse_annotations(p), jt.parse_annotations(p)
        assert got == want and len(got) == SYNTH["n_per_set"]
        assert tt.filter_sts(got) == jt.filter_sts(want)


@pytest.mark.parametrize("seed,train", [(0, True), (0, False), (1, True),
                                        (1, False), (4, True)])
def test_sts_reads_the_jax_set(synth_dir, seed, train):
    got = list(tt.STS(synth_dir, train, seed))
    assert got == list(jt.STS(synth_dir, train, seed))
    assert got[0][0].startswith(os.path.join(synth_dir,
                                             tt.sts_set(seed, train)))


def test_missing_or_broken_dataset_raises_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="STS dataset"):
        tt.ensure_dataset_exists(str(tmp_path / "none"))
    d = tmp_path / "broken"
    d.mkdir()
    (d / "SYNTHETIC").write_text("x")
    for mod in (tt, jt):
        with pytest.raises(FileNotFoundError, match="annotations missing"):
            mod.ensure_dataset_exists(str(d), allow_download=False)
    # the download needs the network: the port leaves it out
    with pytest.raises(NotImplementedError, match="network"):
        tt.ensure_dataset_exists(str(tmp_path / "none"),
                                 allow_download=True)
    assert not tt.file_md5_ok(str(tmp_path / "none"), tt.SET1_ANNOT_MD5)


# ------------------------------------------------------------ augmentation
@pytest.mark.parametrize("seed", range(6))
def test_color_jitter_and_translate_bitwise_jax(seed):
    img = np.random.default_rng(seed).random((37, 53, 3)).astype(np.float32)
    got = tt.color_jitter(img, np.random.default_rng([seed, 1]))
    want = jt.color_jitter(img, np.random.default_rng([seed, 1]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            tt.random_translate(img, r_t, max_dx=20, max_dy=9),
            jt.random_translate(img, r_j, max_dx=20, max_dy=9))


def _sector_edge_pixels():
    """Pixels whose hue is each of the six sector edges k/6, and float32
    neighbours on both sides of each edge, at several s and v."""
    hs = []
    for k in range(7):
        e = np.float32(k / 6)
        hs += [np.nextafter(e, np.float32(-1)), e,
               np.nextafter(e, np.float32(2))]
    h = np.clip(np.asarray(hs, np.float32), 0, np.float32(1)) % 1
    s = np.asarray([1.0, 0.5, 0.0], np.float32)
    v = np.asarray([1.0, 0.3], np.float32)
    H, S, V = np.meshgrid(h, s, v, indexing="ij")
    return H.ravel()[:, None], S.ravel()[:, None], V.ravel()[:, None]


def test_hsv_bitwise_jax_at_sector_edges():
    h, s, v = _sector_edge_pixels()
    rgb = tt._hsv_to_rgb(h, s, v)
    np.testing.assert_array_equal(rgb, jt._hsv_to_rgb(h, s, v))
    for a, b in zip(tt._rgb_to_hsv(rgb), jt._rgb_to_hsv(rgb)):
        np.testing.assert_array_equal(a, b)
    # pure and mixed primaries sit on the edges; shifts that land on and
    # next to them
    for f in (0.0, 1 / 6, -1 / 6, 0.5, 1e-8, -1e-8, 0.1, -0.1, 0.0999):
        np.testing.assert_array_equal(tt._adjust_hue(rgb, f),
                                      jt._adjust_hue(rgb, f))


@pytest.mark.parametrize("seed", range(4))
def test_adjust_hue_bitwise_jax(seed):
    img = np.random.default_rng(seed).random((16, 24, 3)).astype(np.float32)
    img[0] = 0.0                   # achromatic rows: h = 0
    img[1] = img[1, :, :1]
    f = np.random.default_rng(seed + 100).uniform(-0.1, 0.1)
    np.testing.assert_array_equal(tt._adjust_hue(img, f),
                                  jt._adjust_hue(img, f))


# --------------------------------------------------------- synthetic corpus
@pytest.mark.parametrize("kw", [dict(), dict(contrast=0.9, contrast_min=0.1),
                                dict(occluded_frac=0.5, seed=3)],
                         ids=["default", "contrast_min", "occluded"])
def test_synth_files_byte_equal_jax(tmp_path, kw):
    args = dict(SYNTH, n_per_set=8, **kw)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    ts.generate_synth_sts(a, **args)
    js.generate_synth_sts(b, **args)
    for sub in ("", "Set1", "Set2"):
        names = sorted(f for f in os.listdir(os.path.join(b, sub))
                       if not os.path.isdir(os.path.join(b, sub, f)))
        assert sorted(f for f in os.listdir(os.path.join(a, sub))
                      if not os.path.isdir(os.path.join(a, sub, f))) == names
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(a, sub), os.path.join(b, sub), names, shallow=False)
        assert not mismatch and not errors


@pytest.mark.parametrize("kw", [dict(), dict(contrast=0.9, contrast_min=0.1)],
                         ids=["default", "contrast_min"])
def test_in_memory_images_are_what_the_writers_encode(tmp_path, monkeypatch,
                                                      kw):
    """``synth_sts_images`` yields the arrays both packages' writers hand
    to PIL, with the lines they write."""
    from PIL import Image
    encoded = []
    fromarray = Image.fromarray

    def record(arr, *a, **k):
        encoded.append(np.array(arr))
        return fromarray(arr, *a, **k)
    monkeypatch.setattr(Image, "fromarray", record)
    args = dict(SYNTH, n_per_set=8, **kw)
    mem = list(ts.synth_sts_images(**args))
    for mod, name in ((ts, "port"), (js, "jax")):
        encoded.clear()
        mod.generate_synth_sts(str(tmp_path / name), **args)
        assert len(encoded) == len(mem) == 16
        for arr, (_, _, img, _) in zip(encoded, mem):
            assert img.dtype == np.uint8 and img.shape == (120, 160, 3)
            np.testing.assert_array_equal(img, arr)
    for s in ("Set1", "Set2"):
        with open(tmp_path / "jax" / s / "annotations.txt") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        assert lines == [line for st, _, _, line in mem if st == s]
    sets = ts.synth_sts_sets(**args)
    assert [n for n, _, _ in sets["Set2"]] == [
        n for st, n, _, _ in mem if st == "Set2"]
    assert [sg for _, _, sg in sets["Set1"]] == [
        sg for _, sg in jt.parse_annotations(
            str(tmp_path / "jax" / "Set1" / "annotations.txt"))]


# ------------------------------------------------------------------- items
def _pair(synth_dir, train, **over):
    c = conf_dict(synth_dir, **over)
    return (tt.TrafficSigns(t_config(c), train),
            jt.TrafficSigns(j_config(c), train))


def _assert_items_equal(a, b, idx):
    for i in idx:
        got, want = a[i], b[i]
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("over", [
    dict(), dict(input_norm="imagenet"), dict(img_size=[100, 140]),
    dict(max_shift=30, seed=1)], ids=["float", "uint8", "resized",
                                      "max_shift"])
def test_items_bitwise_jax(synth_dir, train, over):
    port, jax_ds = _pair(synth_dir, train, **over)
    assert len(port) == len(jax_ds) > 4
    assert port._data == jax_ds._data
    assert port.max_shift == jax_ds.max_shift
    # every item, then the first again: the draw counter moved on
    _assert_items_equal(port, jax_ds, list(range(len(port))) + [0])
    x = port[1]["input"]
    assert x.dtype == (np.uint8 if over.get("input_norm") else np.float32)
    assert x.shape[1:] == (20, 20, 3)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("over", [dict(), dict(input_norm="imagenet")],
                         ids=["float", "uint8"])
def test_in_memory_items_equal_jax_files(tmp_path, train, over):
    """The in-memory form against the JAX reader on PNGs (lossless)
    written from the same arrays at img_size."""
    from PIL import Image
    args = dict(SYNTH, n_per_set=8, occluded_frac=0.3)
    sets = ts.synth_sts_sets(**args)
    for s, records in sets.items():
        os.makedirs(tmp_path / s)
        lines = []
        for (_, fname, img, line) in (
                r for r in ts.synth_sts_images(**args) if r[0] == s):
            png = fname.replace(".jpg", ".png")
            Image.fromarray(img).save(tmp_path / s / png)
            lines.append(line.replace(fname, png, 1))
        (tmp_path / s / "annotations.txt").write_text("\n".join(lines))
    (tmp_path / "SYNTHETIC").write_text("x")
    c = conf_dict(str(tmp_path), **over)
    port = tt.TrafficSigns(t_config(c), train, images=sets)
    jax_ds = jt.TrafficSigns(j_config(c), train)
    assert [n.replace(".jpg", "") for n, _ in port._data] == [
        os.path.basename(p).replace(".png", "") for p, _ in jax_ds._data]
    _assert_items_equal(port, jax_ds, range(len(port)))


def test_in_memory_wrong_size_raises():
    sets = ts.synth_sts_sets(n_per_set=4, height=60, width=80, seed=0)
    conf = t_config(conf_dict(""))
    with pytest.raises(ValueError, match="img_size"):
        tt.TrafficSigns(conf, True, images=sets)
    sets = ts.synth_sts_sets(**dict(SYNTH, n_per_set=4))
    name, img, signs = sets["Set1"][1]     # the train split's set
    sets["Set1"][1] = (name, img.astype(np.float32), signs)
    with pytest.raises(ValueError, match="uint8"):
        tt.TrafficSigns(conf, True, images=sets)
    assert len(tt.TrafficSigns(conf, False, images=sets)) > 0


# ------------------------------------------------------------------ resume
@pytest.mark.parametrize("rank", [None, 0, 1],
                         ids=["one_process", "rank0of2", "rank1of2"])
@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_resumed_loader_draws_as_unbroken(synth_dir, k, workers, rank):
    """A run resumed at epoch k (``skip_epochs`` -> ``skip_draws``) loads
    the train batches the unbroken run loaded in epoch k, augmentation
    included, in both packages; the port at ``workers`` threads, in one
    process or as data rank ``rank`` of 2, whose rows are those of one
    drop_last process. The JAX package's loader runs without threads in
    one process (its draws depend on thread timing with threads)."""
    c = conf_dict(synth_dir, shuffle=True, seed=2)
    ranks = {} if rank is None else dict(process_index=rank,
                                         process_count=2)
    batches = {}
    for ds_mod, ld_mod, cfg, kw in (
            (tt, t_loader, t_config, dict(num_workers=workers, **ranks)),
            (jt, j_loader, j_config, dict(drop_last=rank is not None))):
        def loader():
            return ld_mod.DataLoader(ds_mod.TrafficSigns(cfg(c), True),
                                     batch_size=4, shuffle=True, seed=2,
                                     **kw)
        unbroken = loader()
        for _ in range(k):
            list(unbroken)
        want = list(unbroken)
        resumed = loader()
        resumed.skip_epochs(k)
        got = list(resumed)
        assert len(got) == len(want) == len(resumed) >= 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["input"], w["input"])
            np.testing.assert_array_equal(g["sign"], w["sign"])
        batches[ld_mod] = got
    rows = slice(None) if rank is None else slice(2 * rank, 2 * rank + 2)
    assert len(batches[t_loader]) == len(batches[j_loader])
    for g, w in zip(batches[t_loader], batches[j_loader]):
        np.testing.assert_array_equal(g["input"], w["input"][rows])
        np.testing.assert_array_equal(g["sign"], w["sign"][rows])


# -------------------------------------------------------------------- main
def test_main_trains_traffic_from_synth_dir(synth_dir, tmp_path):
    """``--dataset traffic --device cpu`` builds both datasets from a
    synthetic corpus and trains an epoch with an eval."""
    from ips_tpu_torch.main import build_datasets, main
    train, test = build_datasets(t_config(conf_dict(synth_dir)), "traffic")
    assert isinstance(train, tt.TrafficSigns) and train.train
    assert not test.train and len(train) > 4 and len(test) > 4
    cfg = tmp_path / "c.json"
    metrics = str(tmp_path / "m.jsonl")
    cfg.write_text(json.dumps(conf_dict(
        synth_dir, D=128, n_res_blocks=2, N=48, M=4, I=16, n_worker=2,
        metrics_path=metrics)))
    trainer, _, _ = main(["--dataset", "traffic", "--config", str(cfg),
                          "--device", "cpu"])
    assert trainer.device.type == "cpu" and trainer.step == 3
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [r["split"] for r in rows] == ["train", "test"]
    assert all(np.isfinite(r["sign_loss"]) for r in rows)
