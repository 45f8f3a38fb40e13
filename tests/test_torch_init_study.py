"""The initial-draw study's two drivers at a tiny size on the CPU: the
port's ``ips_tpu_torch/scripts/init_study.py`` and the JAX package's arm,
``tests/torch_init_study_jax.py``, at the study's reduced width (200x200,
N = 16, M = I = 4, B = 16) on a 10 + 10 store, two draws, one epoch.

- The JSON lines and summaries are well formed, on the 40-epoch lr
  schedule.
- The port from ``port_<s>.npz`` gives the losses of the port from
  ``--port-seeds s``, bitwise.
- The JAX arm from ``jax_<s>.npz`` gives ``ips_tpu.main.run``'s
  first-epoch losses from ``PRNGKey(s)``, bitwise; its ``load_draw``
  replaces every tree of a trainer built at another seed.
- With the patch shuffle and dropout off, in fp32, the port and JAX from
  the same ``port_0.npz`` agree within ``LOSS_RTOL``, as
  ``test_main_epoch_matches_jax`` holds the two drivers.
- ``--tally`` counts the arms; its Fisher tests report the least gap in
  learned draws they could reject.
"""

import json
import math

import numpy as np
import pytest
import scipy.stats
import torch

import ips_tpu.main as j_main
from ips_tpu.config import config_from_dict as j_config
from ips_tpu_torch import main as t_main
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.scripts import init_study
from ips_tpu_torch.train.schedule import warmup_cosine_lr

import torch_init_study_jax as jax_arm
from test_torch_mnist_shipped import LOSS_RTOL, chip_smoke

SEEDS = (0, 1)
TASKS = ("majority", "max", "top", "multi")


@pytest.fixture(autouse=True)
def keep_threads():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """(store, draws directory) at the reduced width: 10 + 10 images and
    both packages' draws at seeds 0 and 1."""
    d = tmp_path_factory.mktemp("init_study")
    store, draws = str(d / "store"), str(d / "draws")
    init_study.ensure_store(store, init_study.store_args(
        chip_smoke, "reduced", 10, 10))
    jax_arm.write_draws(draws, SEEDS, init_study.study_config(
        chip_smoke, "reduced", store, 0))
    return store, draws


def _common(store, out, *extra):
    return ["--width", "reduced", "--store", store, "--n-train", "10",
            "--n-test", "10", "--stop-after", "1", "--threads", "2",
            "--out", str(out), *extra]


def _port(store, out, *extra):
    assert init_study.main(_common(store, out, "--device", "cpu",
                                   *extra)) == 0
    return [json.loads(line) for line in open(out)]


def _jax(store, out, *extra):
    assert jax_arm.main(_common(store, out, *extra)) == 0
    return [json.loads(line) for line in open(out)]


def _numbers(row):
    return {k: v for k, v in row.items()
            if k.endswith(("_loss", "_accuracy"))}


@pytest.fixture(scope="module")
def port_seed_lines(study, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_seeds") / "lines.jsonl"
    return _port(study[0], out, "--port-seeds", "0-1")


def test_lines_and_summaries(port_seed_lines):
    lines = port_seed_lines
    assert [(r["seed"], "summary" in r) for r in lines] == \
        [(0, False), (0, True), (1, False), (1, True)]
    lr0 = warmup_cosine_lr(1, 1, 40, 4, chip_smoke.MNIST_CONFIG["lr"])
    for row, summary in (lines[:2], lines[2:]):
        meta = {"draw": "port", "from": "generator", "trainer": "port",
                "width": "reduced", "stream_seed": 0}
        assert {k: row[k] for k in meta} == meta
        assert row["epoch"] == 0 and math.isclose(row["lr"], lr0)
        for split in ("train", "test"):
            for t in TASKS:
                assert np.isfinite(row[f"{split}_{t}_loss"])
                metric = [k for k in row if k.startswith(f"{split}_{t}_")
                          and not k.endswith("_loss")]
                assert len(metric) == 1 and 0 <= row[metric[0]] <= 1
        assert row["train_seconds"] > 0
        learned = row["test_majority_accuracy"] >= init_study.LEARNED_AT
        assert summary["learned"] is learned
        assert summary["first_epoch"] == (0 if learned else None)
        assert summary["epochs"] == 1 and summary["finite"] is True
        assert {k: summary[k] for k in meta} == meta
        assert summary["seed"] == row["seed"]
        assert summary["test_majority_accuracy"] == \
            row["test_majority_accuracy"]
    assert _numbers(lines[0]) != _numbers(lines[2])   # two draws


def test_port_npz_is_the_port_seed(study, port_seed_lines, tmp_path):
    store, draws = study
    lines = _port(store, tmp_path / "npz.jsonl", "--init-dir", draws,
                  "--init-name", "port", "--init-seeds", "0-1")
    assert [r["from"] for r in lines] == ["port_0.npz"] * 2 + \
        ["port_1.npz"] * 2
    for got, want in zip(lines[::2], port_seed_lines[::2]):
        assert got["seed"] == want["seed"]
        assert _numbers(got) == _numbers(want)


def test_jax_npz_is_jax_main_run(study, tmp_path, monkeypatch):
    """Seed 1 for the draw and the streams alike, as ``ips_tpu.main``
    ties them; the run is cut after its first epoch's records."""
    store, draws = study
    lines = _jax(store, tmp_path / "jax.jsonl", "--init-dir", draws,
                 "--init-seeds", "1", "--stream-seed", "1")
    assert [r["trainer"] for r in lines] == ["jax", "jax"]

    class Stop(Exception):
        pass
    train_epoch = j_main.train_one_epoch

    def first_epoch_only(trainer, loader, epoch, *a, **kw):
        if epoch:
            raise Stop
        return train_epoch(trainer, loader, epoch, *a, **kw)
    monkeypatch.setattr(j_main, "train_one_epoch", first_epoch_only)
    metrics = tmp_path / "run.jsonl"
    c = init_study.study_config(chip_smoke, "reduced", store, 1)
    c.update(metrics_path=str(metrics), n_worker=2)
    with pytest.raises(Stop):
        j_main.run(j_config(c), "mnist")
    want = {r["split"]: r for r in map(json.loads, open(metrics))}
    for split in ("train", "test"):
        for t in TASKS:
            assert lines[0][f"{split}_{t}_loss"] == want[split][f"{t}_loss"]


def test_load_draw_replaces_every_tree(study):
    """A JAX trainer built at seed 0 holds JAX's seed-1 draw, and the
    port's seed-1 draw, after ``load_draw``, bitwise."""
    _, draws = study
    c = init_study.study_config(chip_smoke, "reduced", "unused", 0)
    for name in ("jax_1.npz", "port_1.npz"):
        trainer = j_main.build_trainer(j_config(c))
        before = weights.flatten_variables(trainer.state.params,
                                           trainer.state.batch_stats)
        jax_arm.load_draw(trainer, f"{draws}/{name}")
        got = weights.flatten_variables(trainer.state.params,
                                        trainer.state.batch_stats)
        with np.load(f"{draws}/{name}") as want:
            assert got.keys() == set(want.files)
            for k in want.files:
                assert got[k].tobytes() == want[k].tobytes(), (name, k)
        assert any(before[k].tobytes() != got[k].tobytes() for k in got)


def test_port_and_jax_agree_from_one_draw(study, tmp_path):
    """Through ``train_port`` and ``train_jax`` at ``study_config``'s
    ``deterministic`` and ``fp32``, which no counted run sets."""
    store, draws = study
    c = init_study.study_config(chip_smoke, "reduced", store, 0,
                                deterministic=True, fp32=True)
    c["n_worker"] = 2
    draw = init_study.draw_list("", draws, "0", "port")
    t_conf = t_config(c)
    init_study.train_port(t_conf, "cpu",
                          *t_main.build_datasets(t_conf, "mnist"), draw, 1,
                          out=str(tmp_path / "port.jsonl"), width="reduced")
    j_conf = j_config(c)
    jax_arm.train_jax(j_conf, *j_main.build_datasets(j_conf, "mnist"), draw,
                      1, out=str(tmp_path / "jax.jsonl"))
    port, jax_lines = ([json.loads(line) for line in open(tmp_path / name)]
                       for name in ("port.jsonl", "jax.jsonl"))
    assert port[0]["trainer"] == "port" and jax_lines[0]["trainer"] == "jax"
    assert port[0]["from"] == jax_lines[0]["from"] == "port_0.npz"
    got, want = port[0], jax_lines[0]
    for split in ("train", "test"):
        for t in TASKS:
            np.testing.assert_allclose(got[f"{split}_{t}_loss"],
                                       want[f"{split}_{t}_loss"],
                                       rtol=LOSS_RTOL, err_msg=(split, t))
    metrics = [k for k in want if k.endswith("accuracy")]
    assert len(metrics) == 8
    assert {k: got[k] for k in metrics} == {k: want[k] for k in metrics}


@pytest.mark.parametrize("n, gap", [(2, None), (3, None), (4, 4), (6, 5),
                                    (8, 5)])
def test_least_gap(n, gap):
    """The least difference in learned draws that Fisher's exact test
    rejects at 0.05, n draws a side (0 of 6 against 4 of 6: p = 0.061;
    against 5 of 6: 0.015), and every table with a smaller gap kept."""
    assert init_study.least_gap(n) == gap
    for a in range(n + 1):
        for c in range(n + 1):
            if gap is None or abs(a - c) < gap:
                assert init_study.fisher_p(a, n, c, n) >= 0.05


def test_tally_counts_arms(tmp_path):
    """Two trainers, two generators, three seeds; a repeated draw's last
    summary wins."""
    fates = {("port", "port"): [None, 3, None], ("port", "jax"): [2, 2, 5],
             ("jax", "port"): [None, 4, 7], ("jax", "jax"): [1, None, 2]}
    path = tmp_path / "s.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"epoch": 0}) + "\n")      # an epoch line
        for (trainer, draw), firsts in fates.items():
            for seed, first in enumerate(firsts):
                f.write(json.dumps({
                    "summary": True, "trainer": trainer, "draw": draw,
                    "width": "reduced", "stream_seed": 0, "seed": seed,
                    "first_epoch": 9 if first is None else None}) + "\n")
                f.write(json.dumps({
                    "summary": True, "trainer": trainer, "draw": draw,
                    "width": "reduced", "stream_seed": 0, "seed": seed,
                    "first_epoch": first}) + "\n")
    t = init_study.tally([str(path)])
    arm = t["arms"]["port<-port reduced s0"]
    assert (arm["learned"], arm["n"]) == (1, 3)
    assert arm["fates"] == {0: None, 1: 3, 2: None}
    assert t["agree"] == {
        "port<-port reduced s0 vs jax trainer": {"seeds": 3, "same_fate": 2},
        "port<-jax reduced s0 vs jax trainer": {"seeds": 3, "same_fate": 2}}
    f = t["fisher"]["port<-port|jax reduced s0"]
    assert (f["port_draws"], f["jax_draws"]) == ("1/3", "3/3")
    assert math.isclose(
        f["p"], scipy.stats.fisher_exact([[1, 2], [3, 0]]).pvalue)
    assert f["least_gap"] is None     # no 3-against-3 table reaches 0.05
    assert t["fisher"]["jax<-port|jax reduced s0"]["port_draws"] == "2/3"
