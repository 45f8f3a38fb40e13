"""The data path of the port against ips_tpu's: host ops, DataLoader batch
order, the megapixel-MNIST generator and dataset, on-device densify and
the metrics. Same numpy-seeded inputs on both sides; every comparison is
exact except AUC (within 1e-12)."""

import filecmp
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu import native as j_native
from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data import loader as j_loader
from ips_tpu.data import mnist as j_mnist
from ips_tpu.ops.densify import densify_patches as j_densify
from ips_tpu.train import metrics as j_metrics
from ips_tpu_torch import native as t_native
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data import loader as t_loader
from ips_tpu_torch.data import mnist as t_mnist
from ips_tpu_torch.ops.densify import densify_patches
from ips_tpu_torch.train import metrics as t_metrics

TASKS = {"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                   "metric": "accuracy"},
         "task1": {"id": 1, "name": "max", "act_fn": "softmax",
                   "metric": "accuracy"},
         "task2": {"id": 2, "name": "top", "act_fn": "softmax",
                   "metric": "accuracy"},
         "task3": {"id": 3, "name": "multi", "act_fn": "sigmoid",
                   "metric": "multilabel_accuracy"}}


def conf_dict(data_dir, **over):
    """tests/test_sparse_input.py's tiny MNIST config."""
    d = dict(n_epoch=1, B=4, B_seq=4, n_epoch_warmup=1, lr=1e-3, wd=0.1,
             n_class=10, data_dir=data_dir, is_image=True,
             enc_type="resnet18", n_chan_in=1, n_res_blocks=2, shuffle=True,
             n_token=4, N=16, M=4, I=4, patch_size=[50, 50],
             patch_stride=[50, 50], use_pos=True, H=4, D=128, D_k=16,
             D_v=16, D_inner=128, compute_dtype="float32",
             donate_buffers=False, sparse_input=True, tasks=TASKS)
    d.update(over)
    return d


# ----------------------------------------------------------------- host ops
def _sparse_case(rng, H, W, C, nnz):
    idx = rng.choice(H * W * C, size=nnz, replace=False).astype(np.int64)
    return idx, rng.random(nnz).astype(np.float32)


@pytest.mark.parametrize("H,W,C,ps,st", [
    (60, 40, 1, (20, 20), (20, 20)),      # exact tiling
    (60, 40, 1, (20, 20), (10, 10)),      # 50% overlap
    (30, 30, 3, (10, 10), (10, 10)),      # multi-channel
    (64, 64, 1, (16, 16), (12, 12)),      # non-divisible stride
])
def test_densify_patchify_matches_jax(H, W, C, ps, st):
    idx, vals = _sparse_case(np.random.default_rng(0), H, W, C, 200)
    got = t_native.densify_patchify(idx, vals, (H, W, C), ps, st)
    want = j_native.densify_patchify(idx, vals, (H, W, C), ps, st)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    empty = t_native.densify_patchify(np.zeros(0, np.int64),
                                      np.zeros(0, np.float32), (H, W, C),
                                      ps, st)
    assert empty.shape == want.shape and not empty.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_patchify_and_gather_match_jax(dtype):
    rng = np.random.default_rng(1)
    img = rng.random((50, 70, 3)).astype(dtype)
    for ps, st in [((10, 10), (10, 10)), ((20, 14), (10, 7))]:
        np.testing.assert_array_equal(t_native.patchify_dense(img, ps, st),
                                      j_native.patchify_dense(img, ps, st))
    src = rng.random((3, 40, 8, 8, 1)).astype(dtype)
    idx = rng.integers(0, 40, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(t_native.gather_patches(src, idx),
                                  j_native.gather_patches(src, idx))


# --------------------------------------------------------------- DataLoader
class Indexed:
    """Each item is its own index, so a batch shows which items it holds."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full(3, i, np.float32)}


def _epochs(mod, n_epochs, skip, **kw):
    ld = mod.DataLoader(Indexed(23), **kw)
    ld.skip_epochs(skip)
    return [[b["i"].tolist() for b in ld] for _ in range(n_epochs)], len(ld)


@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=4, shuffle=True, seed=3, drop_last=True),
    dict(batch_size=5, shuffle=False),
    dict(batch_size=3, shuffle=True, seed=7, bucket_fn=lambda i: i % 3),
    dict(batch_size=3, shuffle=True, seed=7, bucket_fn=lambda i: i % 3,
         drop_last=True),
    dict(batch_size=4, shuffle=True, seed=5, num_workers=3, prefetch=2),
], ids=["shuffle", "drop_last", "ordered", "bucket", "bucket_drop_last",
        "threaded"])
def test_loader_batch_order_matches_jax(kw, skip):
    got = _epochs(t_loader, 3, skip, **kw)
    want = _epochs(j_loader, 3, skip, **kw)
    assert got == want
    if kw.get("shuffle"):
        assert got[0][0] != got[0][1]     # the epochs really reshuffle


def test_loader_skip_epochs_continues_the_stream():
    run, _ = _epochs(t_loader, 4, 0, batch_size=4, shuffle=True, seed=11)
    resumed, _ = _epochs(t_loader, 2, 2, batch_size=4, shuffle=True,
                         seed=11)
    assert resumed == run[2:]


class Drawing(Indexed):
    """Draws from a stream of its own per item, as an augmenting dataset
    does, and can skip draws (the loader's ``skip_draws`` hook)."""

    def __init__(self, n):
        super().__init__(n)
        self.draws = 0
        self.skipped = []

    def __getitem__(self, i):
        self.draws += 1
        return super().__getitem__(i)

    def skip_draws(self, n):
        self.skipped.append(n)
        self.draws += n


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=4, shuffle=True, seed=3, drop_last=True),
    dict(batch_size=3, shuffle=True, seed=7, bucket_fn=lambda i: i % 3,
         drop_last=True)], ids=["shuffle", "drop_last", "bucket_drop_last"])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_loader_skip_epochs_calls_skip_draws_as_jax(kw, k):
    """A run resumed at epoch k has had its dataset skip the draws an
    unbroken run made in epochs 0..k-1, as the JAX loader does."""
    unbroken = Drawing(23)
    ld = t_loader.DataLoader(unbroken, **kw)
    for _ in range(k):
        list(ld)
    skips = {}
    for mod in (t_loader, j_loader):
        resumed = Drawing(23)
        mod.DataLoader(resumed, **kw).skip_epochs(k)
        skips[mod] = resumed.skipped
        assert resumed.draws == unbroken.draws
    assert skips[t_loader] == skips[j_loader] == (
        [unbroken.draws] if k else [])


def test_loader_collates_and_raises_worker_errors():
    class Bad(Indexed):
        def __getitem__(self, i):
            if i == 9:
                raise KeyError("item 9")
            return super().__getitem__(i)

    b = next(iter(t_loader.DataLoader(Indexed(8), batch_size=4)))
    assert b["x"].shape == (4, 3) and b["x"].dtype == np.float32
    with pytest.raises(KeyError, match="item 9"):
        list(t_loader.DataLoader(Bad(12), batch_size=4, num_workers=2))


# --------------------------------------------------------------- generator
def _fake_mnist_npz(path):
    rng = np.random.default_rng(5)
    np.savez(path, x_train=rng.integers(0, 256, (300, 28, 28), np.uint8),
             y_train=np.arange(300) % 10,
             x_test=rng.integers(0, 256, (100, 28, 28), np.uint8),
             y_test=np.arange(100) % 10)


@pytest.mark.parametrize("source", ["synthetic", "sklearn", "mnist"])
def test_generator_files_match_jax(tmp_path, source):
    npz = None
    if source == "mnist":
        npz = str(tmp_path / "mnist.npz")
        _fake_mnist_npz(npz)
    # H != W, and room for 5 digits 28 px apart (smaller images can
    # leave the generator no place for the last one)
    kw = dict(n_train=5, n_test=3, width=200, height=160, n_noise=6, seed=4,
              digit_source=source, mnist_path=npz)
    j_mnist.generate_megapixel_mnist(str(tmp_path / "j"), **kw)
    t_mnist.generate_megapixel_mnist(str(tmp_path / "t"), **kw)
    for f in ("parameters.json", "train.npy", "test.npy"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f


def test_generator_cli(tmp_path):
    t_mnist.main(["--n_train", "3", "--n_test", "2", "--width", "150",
                  "--height", "150", "--n_noise", "3", "--digit_source",
                  "synthetic", "--dataset_seed", "2", str(tmp_path / "c")])
    t_mnist.generate_megapixel_mnist(str(tmp_path / "f"), n_train=3,
                                     n_test=2, width=150, height=150,
                                     n_noise=3, seed=2,
                                     digit_source="synthetic")
    for f in ("parameters.json", "train.npy", "test.npy"):
        assert filecmp.cmp(tmp_path / "c" / f, tmp_path / "f" / f,
                           shallow=False), f


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist"))
    t_mnist.generate_megapixel_mnist(d, n_train=6, n_test=3, width=200,
                                     height=200, n_noise=4,
                                     digit_source="sklearn")
    return d


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_dataset_items_match_jax(mnist_dir, sparse, train):
    c = conf_dict(mnist_dir, sparse_input=sparse)
    got = t_mnist.MegapixelMNIST(t_config(c), train=train)
    want = j_mnist.MegapixelMNIST(j_config(c), train=train)
    assert len(got) == len(want) and got.img_hw == want.img_hw
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if sparse:
        assert got.nnz_pad % 512 == 0 and "input_idx" in got[0]
    else:
        assert got[0]["input"].shape == (16, 50, 50, 1)


# ------------------------------------------------------------------ densify
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W,C,ph", [(60, 40, 1, 20), (30, 20, 3, 10)])
def test_densify_matches_jax(dtype, H, W, C, ph):
    rng = np.random.default_rng(2)
    B, nnz, n_pad = 3, 150, 50
    idx = np.zeros((B, nnz + n_pad), np.int32)
    vals = np.zeros((B, nnz + n_pad), np.float32)
    for b in range(B):
        idx[b, :nnz] = np.sort(rng.choice(H * W * C, nnz, replace=False))
        vals[b, :nnz] = rng.random(nnz)
    idx[:, nnz:] = idx[:, :1]          # padding aimed at a real pixel
    got = densify_patches(torch.from_numpy(idx), torch.from_numpy(vals),
                          (H, W), (ph, ph), C, getattr(torch, dtype))
    want = j_densify(jnp.asarray(idx), jnp.asarray(vals), (H, W), (ph, ph),
                     C, getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    host = np.stack([j_native.densify_patchify(
        idx[b, :nnz].astype(np.int64), vals[b, :nnz], (H, W, C), (ph, ph),
        (ph, ph)) for b in range(B)])
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), host)


def test_densify_padded_entries_and_tiling():
    # padded (idx 0, val 0) entries leave a real value at index 0 as it is
    out = densify_patches(torch.tensor([[0, 5, 0, 0]]),
                          torch.tensor([[0.7, 0.3, 0.0, 0.0]]), (4, 4),
                          (2, 2))
    assert out.shape == (1, 4, 2, 2, 1)
    assert out[0, 0, 0, 0, 0].item() == pytest.approx(0.7)
    assert out[0, 0, 1, 1, 0].item() == pytest.approx(0.3)   # pixel (1, 1)
    assert out.sum().item() == pytest.approx(1.0)
    with pytest.raises(ValueError, match="exact tiling"):
        densify_patches(torch.zeros((1, 4), dtype=torch.int32),
                        torch.zeros((1, 4)), (10, 10), (3, 3))


# ------------------------------------------------------------------ metrics
METRIC_TASKS = [
    {"name": "majority", "metric": "accuracy"},
    {"name": "multi", "metric": "multilabel_accuracy"},
    {"name": "tumor", "metric": "auc"},
]


def _feed(logger, seed):
    rng = np.random.default_rng(seed)
    for step in range(3):
        B = 5
        preds = {"majority": rng.random((B, 10)),
                 "multi": rng.random((B, 10)),
                 # rounded so that scores tie across rows
                 "tumor": np.round(rng.random((B, 1)), 1)}
        labels = {"majority": rng.integers(0, 10, B),
                  "multi": (rng.random((B, 10)) < 0.5).astype(np.float32),
                  "tumor": np.array([0, 1, 1, 0, step % 2])}
        losses = {k: float(rng.random()) for k in preds}
        w = np.array([1, 1, 1, 1, 0 if step == 2 else 1], np.float32)
        logger.update(losses, preds, labels, weights=w)


@pytest.mark.parametrize("sklearn", [True, False],
                         ids=["sklearn", "fallback"])
def test_metrics_match_jax(monkeypatch, tmp_path, capsys, sklearn):
    if not sklearn:
        monkeypatch.setattr(t_metrics, "_HAVE_SKLEARN", False)
        monkeypatch.setattr(j_metrics, "_HAVE_SKLEARN", False)
    logs = {}
    for name, mod in (("j", j_metrics), ("t", t_metrics)):
        lg = mod.MetricsLogger(METRIC_TASKS)
        for epoch in range(2):
            _feed(lg, seed=epoch)
            lg.compute_metric()
            lg.print_stats(epoch, train=bool(epoch), lr=0.5)
            lg.write_jsonl(str(tmp_path / f"{name}.jsonl"), epoch, "train",
                           lr=0.5)
        logs[name] = (lg, capsys.readouterr().out)
    (j, j_out), (t, t_out) = logs["j"], logs["t"]
    assert t_out == j_out
    assert t.losses_epoch == j.losses_epoch
    for task in ("majority", "multi"):
        assert t.metrics[task] == j.metrics[task]
    np.testing.assert_allclose(t.metrics["tumor"], j.metrics["tumor"],
                               rtol=0, atol=1e-12)
    assert t.latest().keys() == j.latest().keys()
    t_lines = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    j_lines = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert [sorted(x) for x in t_lines] == [sorted(x) for x in j_lines]


def test_auc_fallback_equals_sklearn():
    from sklearn.metrics import roc_auc_score
    rng = np.random.default_rng(4)
    y = rng.integers(0, 2, 200)
    s = np.round(rng.random(200), 2)          # many ties
    assert t_metrics._HAVE_SKLEARN
    assert abs(t_metrics._auc(y, s) - roc_auc_score(y, s)) < 1e-12
    t_metrics._HAVE_SKLEARN = False
    try:
        assert abs(t_metrics._auc(y, s) - roc_auc_score(y, s)) < 1e-12
        with pytest.raises(ValueError, match="single class"):
            t_metrics._auc(np.ones(4), np.arange(4.0))
    finally:
        t_metrics._HAVE_SKLEARN = True
