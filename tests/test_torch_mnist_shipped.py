"""The flagship MNIST configuration as shipped, against ips_tpu on the CPU:
the port's ``sklearn`` digit bank (bundled, read without scikit-learn)
bitwise the JAX package's, its stores byte for byte, the smoke script's
digest of the shipped store, and ``main.main`` over counts that end in a
padded batch and a one-step K-group against the JAX driver's epoch.
"""

import filecmp
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import ips_tpu.main as j_main
from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data import mnist as j_mnist
from ips_tpu_torch import main as t_main
from ips_tpu_torch import weights
from ips_tpu_torch.data import mnist as t_mnist

from test_torch_data import conf_dict
from test_torch_loop import assert_state_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# megapixel MNIST's per-epoch task losses (means over the epoch's rows):
# the per-step bound of tests/test_torch_loop.py
LOSS_RTOL = 1e-4


@pytest.fixture
def no_sklearn(monkeypatch):
    """scikit-learn cannot be imported, as on the card's machine."""
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import sklearn.datasets  # noqa: F401


def test_bundled_bank_equals_load_digits():
    from sklearn.datasets import load_digits
    d = load_digits()
    with np.load(t_mnist.DIGITS_8X8) as f:
        images, labels = f["images"], f["labels"]
    assert images.dtype == np.uint8 and labels.dtype == np.int64
    assert images.shape == d.images.shape == (1797, 8, 8)
    np.testing.assert_array_equal(images.astype(np.float64), d.images)
    np.testing.assert_array_equal(labels, d.target)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_digit_bank_without_sklearn_matches_jax(request, train):
    want_x, want_y = j_mnist.load_digit_bank("sklearn", train)
    request.getfixturevalue("no_sklearn")
    got_x, got_y = t_mnist.load_digit_bank("sklearn", train)
    assert got_x.dtype == want_x.dtype == np.float32
    assert got_x.tobytes() == want_x.tobytes()
    np.testing.assert_array_equal(got_y, want_y)
    assert got_y.dtype == want_y.dtype


def _same_files(a, b):
    for f in ("parameters.json", "train.npy", "test.npy"):
        assert filecmp.cmp(a / f, b / f, shallow=False), f


@pytest.mark.parametrize("how", ["function", "cli", "split_writers"])
def test_store_without_sklearn_matches_jax(tmp_path, monkeypatch, how):
    """3 + 2 images at 300x300 (the generator needs 150 px or more to
    place 5 digits) from the default source."""
    kw = dict(n_train=3, n_test=2, width=300, height=300, n_noise=5)
    j_mnist.generate_megapixel_mnist(str(tmp_path / "j"), **kw)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    out = str(tmp_path / "t")
    if how == "function":
        t_mnist.generate_megapixel_mnist(out, **kw)
    elif how == "cli":
        t_mnist.main(["--n_train", "3", "--n_test", "2", "--width", "300",
                      "--height", "300", "--n_noise", "5", out])
    else:
        t_mnist.SplitWriters(out, **kw).wait(120)
    _same_files(tmp_path / "j", tmp_path / "t")


def test_cli_defaults_are_the_shipped_store(monkeypatch):
    """``python -m ips_tpu_torch.data.mnist <dir>`` writes the shipped
    store: 5000 + 1000 images at 1500x1500 from the sklearn digits."""
    seen = {}
    monkeypatch.setattr(t_mnist, "generate_megapixel_mnist",
                        lambda out, **kw: seen.update(kw, out=out))
    t_mnist.main(["some_dir"])
    assert seen == dict(out="some_dir", n_train=5000, n_test=1000,
                        width=1500, height=1500, noise=True, n_noise=50,
                        seed=0, digit_source="sklearn", mnist_path=None)


def test_smoke_digest_is_the_jax_store(tmp_path):
    """chip_smoke.py's digest of the shipped store's first samples is the
    digest of the JAX package's store of that many samples (each split's
    samples are drawn one after another from its own generator, so the
    first ones do not depend on the count)."""
    n_train, n_test = chip_smoke.SHIPPED_DIGEST_SAMPLES
    j_mnist.generate_megapixel_mnist(str(tmp_path), n_train=n_train,
                                     n_test=n_test, width=1500, height=1500,
                                     n_noise=50, seed=chip_smoke.SEED,
                                     digit_source="sklearn")
    train, test = (np.load(tmp_path / f, allow_pickle=True)
                   for f in ("train.npy", "test.npy"))
    assert chip_smoke.store_digest(train, test) == chip_smoke.SHIPPED_DIGEST


def test_smoke_store_counts_leave_the_tails():
    """The shipped counts end in a padded train batch, a one-step K-group
    and a short eval batch, which phase mnist_shipped counts."""
    c = chip_smoke.MNIST_CONFIG
    B, K = c["B"], c["steps_per_dispatch"]
    steps = -(-chip_smoke.SHIPPED_TRAIN_IMAGES // B)
    assert chip_smoke.SHIPPED_TRAIN_IMAGES % B and steps % K == 1
    assert chip_smoke.SHIPPED_TEST_IMAGES % B
    window = chip_smoke.SHIPPED_WINDOW_IMAGES
    assert window % B == chip_smoke.SHIPPED_TRAIN_IMAGES % B
    assert -(-window // B) % K == 1


# ------------------------------------------------ the JAX initial weights
def write_jax_init(path, seed=0):
    """The JAX package's initial variables for the shipped MNIST config at
    ``seed`` (``init_ips_model`` with ``PRNGKey(seed)``, what
    ``ips_tpu.main`` starts from) as a flat reference-named ``.npz``, which
    ``python -m ips_tpu_torch.scripts.mnist_learning --init`` reads.
    From the repository root, with JAX on the CPU::

        JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['tests'];
        import test_torch_mnist_shipped as t; t.write_jax_init('w.npz')"
    """
    import jax
    from ips_tpu.models.ips_net import init_ips_model
    _, params, batch_stats = init_ips_model(
        j_config(chip_smoke.MNIST_CONFIG), jax.random.PRNGKey(seed))
    np.savez(path, **weights.flatten_variables(params, batch_stats))


def test_jax_init_loads_at_the_shipped_width(tmp_path):
    """Every tensor of the shipped model comes from the file, bitwise."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.models.ips_net import IPSModel
    path = str(tmp_path / "init.npz")
    write_jax_init(path)
    model = IPSModel(config_from_dict(chip_smoke.MNIST_CONFIG))
    weights.load_flat(model, path)
    with np.load(path) as want:
        got = weights.to_flat(model)
        assert got.keys() == set(want.files)
        for k in want.files:
            assert got[k].tobytes() == want[k].tobytes(), k


# ------------------------------------------ the driver's epoch against JAX
# 10 train images in batches of B = 4: a last batch of 2 rows padded to 4,
# and 3 steps at K = 2 end in a group of one step; 10 test images the same
N_IMAGES = 10


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("shipped_tails")
    j_mnist.generate_megapixel_mnist(str(d / "data"), n_train=N_IMAGES,
                                     n_test=N_IMAGES, width=200, height=200,
                                     n_noise=4, digit_source="sklearn")
    return d


def test_main_epoch_matches_jax(store, monkeypatch):
    """One epoch of ``main.main`` on the CPU against ``ips_tpu.main``'s
    from the same initial state (shuffle of patches and dropout off:
    neither stream can be reproduced across frameworks): each split's
    per-task losses within LOSS_RTOL, metrics equal, 3 optimizer steps,
    the weights and running statistics as tests/test_torch_loop.py holds
    them (the zero-weight padded rows move neither)."""
    c = conf_dict(str(store / "data"), shuffle=False, dropout=0.0,
                  attn_dropout=0.0, steps_per_dispatch=2, n_worker=2)
    jax_metrics, port_metrics = store / "jax.jsonl", store / "port.jsonl"

    captured = {}
    j_build = j_main.build_trainer

    def j_trainer(conf):
        tr = j_build(conf)
        captured["initial"] = tr.state
        return tr
    monkeypatch.setattr(j_main, "build_trainer", j_trainer)
    j_tr, _, _ = j_main.run(j_config(dict(c, metrics_path=str(jax_metrics))),
                            "mnist")

    t_build = t_main.build_trainer

    def t_trainer(conf, device=None):
        tr = t_build(conf, device)
        weights.load_jax_train_state(tr, captured["initial"])
        return tr
    monkeypatch.setattr(t_main, "build_trainer", t_trainer)
    cfg = store / "port.json"
    cfg.write_text(json.dumps(dict(c, metrics_path=str(port_metrics))))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # a few hundred small ops a step
    try:
        port, _, _ = t_main.main(["--config", str(cfg), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)

    assert port.step == int(j_tr.state.step) == 3
    got, want = ([json.loads(line) for line in open(p)]
                 for p in (port_metrics, jax_metrics))
    assert [(r["epoch"], r["split"]) for r in got] == \
        [(r["epoch"], r["split"]) for r in want] == [(0, "train"), (0, "test")]
    for g, w in zip(got, want):
        for t in ("majority", "max", "top", "multi"):
            np.testing.assert_allclose(g[f"{t}_loss"], w[f"{t}_loss"],
                                       rtol=LOSS_RTOL, err_msg=t)
        metrics = [k for k in w if k.endswith("accuracy")]
        assert len(metrics) == 4
        assert {k: g[k] for k in metrics} == {k: w[k] for k in metrics}
    assert_state_match(port, j_tr.state, captured["initial"])
