"""The camelyon feature-mode path of the port against ips_tpu's: the
feature projector, the feature dataset and its synthetic corpus, selection
on masked bucket-padded features, the Predictor, and the driver CLI.

Tiny feature config (F = 32 feature dims projected to D = 16, H = 2,
M = I = 8, one sigmoid task with AUC); the features come from
``make_synth_features`` (numpy only). The JAX side's weights reach the port
through the weight bridge, with non-trivial BatchNorm statistics. Stated
bounds, with the values measured on the CPU:

  * ``FeatureProjector`` in fp32, exact and ``ln_fold``, eval and
    row-weighted train mode: elementwise within 1e-5 (measured 9.5e-7),
    the running statistics of training within 1e-6;
  * in bf16: elementwise within 2^-7 of the output's largest magnitude,
    and a relative Frobenius distance under BF16_STAGE = 1e-4 (measured
    7e-8: both round the same tensors, flax's ``Dense`` rounding its
    product before adding the bias); the port in fp32 against the bf16
    reference misses that bound (measured 2.9e-3), so the check catches a
    missing cast;
  * selection: equal indices and masks;
  * Predictor probabilities: rtol 1e-4 / atol 1e-5.
"""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.camelyon import dataset as jds
from ips_tpu.data.loader import DataLoader as JLoader
from ips_tpu.infer import Predictor as JPredictor
from ips_tpu.models import encoders as je
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.camelyon import dataset as tds
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.infer import Predictor
from ips_tpu_torch.main import main, run
from ips_tpu_torch.models import encoders as te
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_loop import few_torch_threads  # noqa: F401

F_IN, D = 32, 16
FP32_ATOL = 1e-5
BF16_REL = 2.0 ** -7
BF16_STAGE = 1e-4
TOL = dict(rtol=1e-4, atol=1e-5)


def feat_conf(data_dir="", **over):
    """camelyon_config.yml's schema at tiny widths, deterministic
    selection and no dropout."""
    d = dict(n_epoch=1, B=4, B_seq=1, n_epoch_warmup=1, lr=1e-3, wd=0.1,
             n_class=1, data_dir=data_dir, train_fname="train.h5",
             test_fname="test.h5", n_worker=0, is_image=False,
             enc_type="resnet50", n_chan_in=F_IN, shuffle=False,
             shuffle_style="batch", n_token=1, M=8, I=8, use_pos=False,
             H=2, D=D, D_k=8, D_v=8, D_inner=32, attn_dropout=0.0,
             dropout=0.0, compute_dtype="float32", ln_fold=False,
             steps_per_dispatch=2, donate_buffers=False,
             tasks={"task0": {"id": 0, "name": "metastases",
                              "act_fn": "sigmoid", "metric": "auc"}})
    d.update(over)
    return d


def _perturb_stats(tree, rng):
    return {k: (_perturb_stats(v, rng) if hasattr(v, "items") else
                (rng.normal(0, 0.2, np.shape(v)) if k == "mean" else
                 rng.uniform(0.5, 2.0, np.shape(v))).astype(np.float32))
            for k, v in tree.items()}


def rel_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A train and a test file: slides of 9..24 rows (buckets 16 and 24)
    and of 4..39 rows (buckets 8 to 40, the M >= N shortcut included)."""
    d = str(tmp_path_factory.mktemp("camelyon"))
    jds.make_synth_features(os.path.join(d, "train.h5"), n_slides=12,
                            feat_dim=F_IN, n_range=(9, 25), seed=0)
    jds.make_synth_features(os.path.join(d, "test.h5"), n_slides=8,
                            feat_dim=F_IN, n_range=(4, 40), seed=4)
    return d


# ------------------------------------------------------------- projector
def _projector_pair(ln_fold, dtype, x, seed=0):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = je.FeatureProjector(n_chan_in=F_IN, D=D, dtype=jd, ln_fold=ln_fold)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                     train=False)["params"]
    stats = _perturb_stats({"bn": {"mean": np.zeros(D), "var": np.ones(D)}},
                           np.random.default_rng(seed + 1))
    return jm, params, stats


def _projector_inputs(seed=2, n=40):
    """Rows with an offset mean, so the fold's mean term matters, and row
    weights with zeros (padded rows of a partial batch)."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, F_IN)) + 0.5).astype(np.float32)
    w = (rng.random(n) > 0.3).astype(np.float32)
    return x, w


def _run_projector(jm, params, stats, x, w, train, ln_fold, port_dtype):
    if train:
        ref, upd = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            row_weights=jnp.asarray(w),
                            mutable=["batch_stats"])
        ref_stats = upd["batch_stats"]["bn"]
    else:
        ref = jm.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=False)
        ref_stats = stats["bn"]
    tm = te.FeatureProjector(F_IN, D, getattr(torch, port_dtype), ln_fold)
    weights.load_jax(tm, params, stats)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train,
                 torch.from_numpy(w) if train else None)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], D)
    return got.numpy(), np.asarray(ref, np.float32), tm, ref_stats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("ln_fold", [False, True], ids=["exact", "ln_fold"])
def test_projector_fp32_matches_flax(ln_fold, train):
    x, w = _projector_inputs()
    jm, params, stats = _projector_pair(ln_fold, "float32", x)
    got, ref, tm, ref_stats = _run_projector(jm, params, stats, x, w, train,
                                             ln_fold, "float32")
    np.testing.assert_allclose(got, ref, rtol=0, atol=FP32_ATOL)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(ref_stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(ref_stats["var"]), atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("ln_fold", [False, True], ids=["exact", "ln_fold"])
def test_projector_bf16_matches_flax(ln_fold, train):
    x, w = _projector_inputs()
    jm, params, stats = _projector_pair(ln_fold, "bfloat16", x)
    got, ref, _, _ = _run_projector(jm, params, stats, x, w, train, ln_fold,
                                    "bfloat16")
    assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()
    assert rel_dist(got, ref) < BF16_STAGE
    # the same stage without its casts misses the bound
    got32, _, _, _ = _run_projector(jm, params, stats, x, w, train, ln_fold,
                                    "float32")
    assert rel_dist(got32, ref) > BF16_STAGE


def test_projector_params_share_one_tree():
    """Exact and folded projectors hold the same parameters, so one
    checkpoint loads into both; the bridge carries no LayerNorm
    parameters and keeps failing on a stray key."""
    x, _ = _projector_inputs()
    _, params, stats = _projector_pair(True, "float32", x)
    keys = set(weights.flatten_variables(params, stats))
    assert keys == {"params/fc/kernel", "params/fc/bias", "params/bn/scale",
                    "params/bn/bias", "batch_stats/bn/mean",
                    "batch_stats/bn/var"}
    for fold in (False, True):
        tm = te.FeatureProjector(F_IN, D, ln_fold=fold)
        weights.load_jax(tm, params, stats)
        np.testing.assert_array_equal(tm.fc.weight.detach().numpy(),
                                      np.asarray(params["fc"]["kernel"]).T)
        assert set(weights.to_flat(tm)) == keys
    with pytest.raises(KeyError, match="no counterpart"):
        weights.load_jax(tm, dict(params, ln={"scale": np.ones(F_IN)}),
                         stats)


# ---------------------------------------------------------------- dataset
def test_buckets_and_padding():
    for args in [(100, 10, 20), (5, 8, 8), (15000, 5000, 5000),
                 (10000, 5000, 5000)]:
        assert tds.default_buckets(*args) == jds.default_buckets(*args)
    assert tds.default_buckets(100, 10, 20) == [10, 30, 50, 90, 170]
    x = np.random.default_rng(0).random((37, 4)).astype(np.float32)
    for got, want in zip(tds.pad_to_bucket(x, [10, 50, 100]),
                         jds.pad_to_bucket(x, [10, 50, 100])):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        tds.pad_to_bucket(np.ones((200, 4)), [100])


def _h5_contents(path):
    with h5py.File(path, "r") as f:
        return {name: (f[name]["img"][:], f[name]["pos"][:],
                       int(f[name].attrs["label"])) for name in f.keys()}


def test_synth_features_equal_to_jax(tmp_path):
    args = dict(n_slides=7, feat_dim=12, n_range=(5, 30), seed=4)
    ours = tds.make_synth_features(str(tmp_path / "t.h5"), **args)
    ref = jds.make_synth_features(str(tmp_path / "j.h5"), **args)
    a, b = _h5_contents(ours), _h5_contents(ref)
    assert list(a) == list(b)
    for name in b:
        for got, want in zip(a[name][:2], b[name][:2]):
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), name
        assert a[name][2] == b[name][2]
    # the in-memory corpus is the file's content
    mem = dict(tds.synth_slides(**args))
    assert sorted(mem) == list(b)
    for name, (feats, label) in mem.items():
        assert feats.tobytes() == b[name][0].tobytes()
        assert label == b[name][2]


@pytest.mark.parametrize("source", ["hdf5", "memory"])
def test_dataset_items_match_jax(corpus, source):
    conf = feat_conf(corpus)
    slides = (dict(tds.synth_slides(12, F_IN, (9, 25), seed=0))
              if source == "memory" else None)
    ours = tds.CamelyonFeatures(t_config(conf), train=True, slides=slides)
    ref = jds.CamelyonFeatures(j_config(conf), train=True)
    assert len(ours) == len(ref) == 12
    assert ours.slide_names == ref.slide_names
    assert ours.buckets == ref.buckets == [8, 16, 24]
    for i in range(len(ref)):
        assert ours.bucket_of(i) == ref.bucket_of(i)
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys() == {"input", "mask", "metastases"}
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    small = dict(conf, bucket_sizes=[16])
    for ds in (tds.CamelyonFeatures(t_config(small), train=True,
                                    slides=slides),
               jds.CamelyonFeatures(j_config(small), train=True)):
        big = max(range(len(ds)), key=lambda i: ds._ns[i])
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            ds.bucket_of(big)


@pytest.mark.parametrize("B_seq", [1, 2], ids=["slides", "bucketed"])
def test_loader_order_matches_jax(corpus, B_seq):
    """The same batches in the same order, with threads; B_seq = 2 groups
    same-bucket slides through ``bucket_of``."""
    conf = feat_conf(corpus, B_seq=B_seq)
    ours = tds.CamelyonFeatures(t_config(conf), train=True)
    ref = jds.CamelyonFeatures(j_config(conf), train=True)
    kw = dict(batch_size=B_seq, shuffle=True, num_workers=2, seed=3,
              bucket_fn=(lambda d: d.bucket_of) if B_seq > 1 else
              (lambda d: None))
    a = list(DataLoader(ours, **dict(kw, bucket_fn=kw["bucket_fn"](ours))))
    b = list(JLoader(ref, **dict(kw, bucket_fn=kw["bucket_fn"](ref))))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------------------------- selection, Predictor
@pytest.fixture(scope="module")
def trained_pair():
    """A JAX trainer with perturbed BatchNorm statistics, for both fp32
    projector forms."""
    out = {}
    for fold in (False, True):
        tr = JTrainer(j_config(feat_conf(ln_fold=fold)),
                      rng=jax.random.PRNGKey(0), init_opt=False)
        stats = _perturb_stats(tr.state.batch_stats,
                               np.random.default_rng(1))
        tr.state = tr.state.replace(
            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        out[fold] = tr
    return out


def _bucket_batches(corpus, name="test.h5"):
    """Every bucket of the file as one (B, bucket, F) batch with its
    masks: rows padded to several lengths, the M >= N shortcut among
    them."""
    conf = t_config(feat_conf(corpus, test_fname=name))
    ds = tds.CamelyonFeatures(conf, train=False)
    by_bucket = {}
    for i in range(len(ds)):
        by_bucket.setdefault(ds.bucket_of(i), []).append(ds[i])
    return {b: (np.stack([it["input"] for it in items]),
                np.stack([it["mask"] for it in items]))
            for b, items in sorted(by_bucket.items())}


@pytest.mark.parametrize("preencode", [False, True],
                         ids=["per_chunk", "jax_preencoded"])
@pytest.mark.parametrize("ln_fold", [False, True], ids=["exact", "ln_fold"])
def test_selection_matches_jax(corpus, trained_pair, ln_fold, preencode):
    """The port's per-chunk selection against JAX's per-chunk one and
    against its pre-encoded one (what 'auto' resolves to at camelyon's
    size): equal indices and masks on every bucket."""
    jtr = trained_pair[ln_fold]
    if preencode:
        jtr = JTrainer(j_config(feat_conf(ln_fold=ln_fold,
                                          preencode_select=True)),
                       rng=jax.random.PRNGKey(0), init_opt=False)
        jtr.state = trained_pair[ln_fold].state
    port = IPSTrainer(t_config(feat_conf(ln_fold=ln_fold)), device="cpu",
                      init_opt=False)
    weights.load_jax(port.model, jtr.state.params, jtr.state.batch_stats)
    batches = _bucket_batches(corpus)
    assert len(batches) >= 3 and min(batches) == 8
    for bucket, (x, m) in batches.items():
        _, _, j_idx, j_mask = jtr.select(jnp.asarray(x), jnp.asarray(m))
        _, _, t_idx, t_mask = port.select(torch.from_numpy(x),
                                          torch.from_numpy(m))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx),
                                      err_msg=str(bucket))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask),
                                      err_msg=str(bucket))


@pytest.mark.parametrize("ln_fold", [False, True], ids=["exact", "ln_fold"])
def test_predictor_on_features_matches_jax(corpus, trained_pair, ln_fold):
    jtr = trained_pair[ln_fold]
    conf = feat_conf(ln_fold=ln_fold)
    jp = JPredictor(j_config(conf), trainer=jtr)
    tp = Predictor(t_config(conf), device="cpu")
    weights.load_jax(tp.trainer.model, jtr.state.params,
                     jtr.state.batch_stats)
    for bucket, (x, m) in _bucket_batches(corpus).items():
        a, b = jp.predict(x, m), tp.predict(x, m)
        np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
        assert b["metastases"].shape == (x.shape[0], 1)
        np.testing.assert_allclose(b["metastases"], a["metastases"], **TOL)


# ---------------------------------------------------------------- the CLI
def _cli_config(corpus, tmp_path, **over):
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(feat_conf(corpus, n_epoch=2, n_worker=2, shuffle=True,
                            dropout=0.1, attn_dropout=0.1, ln_fold=True,
                            compute_dtype="bfloat16",
                            metrics_path=str(tmp_path / "m.jsonl"), **over),
                  f)
    return path


def test_cli_trains_camelyon(corpus, tmp_path, capsys):
    """``python -m ips_tpu_torch.main --dataset camelyon --device cpu``:
    two epochs at the shipped config's settings (bf16, ln_fold, dropout,
    shuffle, B_seq = 1 assembled into B = 4, K = 2), metrics lines finite
    with the AUC in [0, 1]."""
    trainer, log_train, _ = main(["--dataset", "camelyon", "--config",
                                  _cli_config(corpus, tmp_path), "--device",
                                  "cpu"])
    out = capsys.readouterr().out
    assert "Test Epoch: 2" in out and trainer.device.type == "cpu"
    assert trainer.step == 2 * 3                 # 12 slides, B = 4
    with open(tmp_path / "m.jsonl") as f:
        rows = [json.loads(x) for x in f]
    assert [(r["epoch"], r["split"]) for r in rows] == [
        (0, "train"), (0, "test"), (1, "train"), (1, "test")]
    for r in rows:
        assert np.isfinite(r["metastases_loss"])
        assert 0.0 <= r["metastases_auc"] <= 1.0


def test_run_takes_slides_in_memory(corpus, tmp_path):
    """``run`` with in-memory datasets of the same slides makes the run
    the HDF5 files make, bitwise."""
    with open(_cli_config(corpus, tmp_path)) as f:
        conf = t_config(json.load(f))
    a, _, _ = run(conf.replace(metrics_path=""), "camelyon", "cpu")
    mem = [tds.CamelyonFeatures(conf, train=t, slides=dict(
        tds.synth_slides(n, F_IN, rng, seed=s)))
        for t, n, rng, s in ((True, 12, (9, 25), 0), (False, 8, (4, 40), 4))]
    b, _, _ = run(conf.replace(metrics_path=""), "camelyon", "cpu",
                  datasets=mem)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
