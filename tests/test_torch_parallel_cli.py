"""The training CLI (``ips_tpu_torch.main``) as two gloo ranks on the
CPU, data parallel (``multihost: true``, ``mesh_data: 2``), against one
process of the same config, on a generated megapixel-MNIST store of 16
train and 8 test images at 200x200 (the size of
tests/test_multihost_train.py), 2 epochs of the sparse grouped schedule
with shuffle and dropout on. Stated bounds:

  * the final parameters, AdamW moments and running statistics are
    bitwise equal on both ranks;
  * every train and test loss of the metrics lines within 1e-5 of one
    process's (the ranks' gradient and statistics sums round apart from
    one process's);
  * rank 0 alone writes the metrics lines and saves checkpoints, and a
    resumed run of both ranks loads the checkpoint and trains the next
    epoch only.
"""

import json
import os

import numpy as np
import pytest

from ips_tpu_torch.data.mnist import generate_megapixel_mnist
from ips_tpu_torch.main import main
from ips_tpu_torch.parallel.launch import run_world

from test_torch_data import conf_dict
from test_torch_loop import few_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
LOSS_TOL = 1e-5
EPOCHS = 2


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_cli")
    generate_megapixel_mnist(str(d / "data"), n_train=16, n_test=8,
                             width=200, height=200, n_noise=5,
                             digit_source="synthetic")
    return d


def _config(store, name, **over):
    conf = conf_dict(str(store / "data"), n_epoch=EPOCHS, B=4, B_seq=4,
                     steps_per_dispatch=2,
                     checkpoint_dir=str(store / name / "ckpt"),
                     checkpoint_every=1,
                     metrics_path=str(store / name / "metrics.jsonl"),
                     **over)
    os.makedirs(store / name, exist_ok=True)
    path = str(store / name / "config.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def _losses(rows):
    return np.array([[r[k] for k in sorted(r) if k.endswith("_loss")]
                     for r in rows])


@pytest.fixture(scope="module")
def runs(store):
    main(["--config", _config(store, "one"), "--device", "cpu"])
    mh = dict(multihost=True, cpu_collectives="gloo", mesh_data=2)
    out = store / "two" / "ranks"
    os.makedirs(out, exist_ok=True)
    run_world("torch_parallel_worker:cli", 2,
              [_config(store, "two", **mh), str(out)],
              timeout=WORLD_TIMEOUT, python_path=[TESTS])
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return store, ranks


def test_ranks_end_bitwise_equal(runs):
    _, (a, b) = runs
    assert set(a) == set(b)
    for k in a:
        if k != "saves":
            assert np.array_equal(a[k], b[k]), k
    assert int(a["step"]) == EPOCHS * 4     # 16 images, B = 4


def test_losses_match_one_process(runs):
    store, _ = runs
    one = _rows(store / "one" / "metrics.jsonl")
    two = _rows(store / "two" / "metrics.jsonl")
    assert [(r["epoch"], r["split"]) for r in two] == [
        (r["epoch"], r["split"]) for r in one]
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=0,
                               atol=LOSS_TOL)


def test_rank_zero_alone_writes_and_both_resume(runs):
    store, (a, b) = runs
    assert a["saves"].tolist() == list(range(1, EPOCHS + 1))
    assert b["saves"].tolist() == []
    assert len(_rows(store / "two" / "metrics.jsonl")) == 2 * EPOCHS
    with open(store / "two" / "config.json") as f:
        conf = dict(json.load(f), resume=True, n_epoch=EPOCHS + 1)
    path = str(store / "two" / "resume.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    out = store / "two" / "resumed"
    os.makedirs(out, exist_ok=True)
    run_world("torch_parallel_worker:cli", 2, [path, str(out)],
              timeout=WORLD_TIMEOUT, python_path=[TESTS])
    ra, rb = (dict(np.load(out / f"rank{r}.npz")) for r in range(2))
    assert int(ra["step"]) == int(rb["step"]) == (EPOCHS + 1) * 4
    assert ra["saves"].tolist() == [EPOCHS + 1] and rb["saves"].size == 0
    rows = _rows(store / "two" / "metrics.jsonl")
    assert [(r["epoch"], r["split"]) for r in rows[2 * EPOCHS:]] == [
        (EPOCHS, "train"), (EPOCHS, "test")]
