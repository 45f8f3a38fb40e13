"""The port's training CLI (``ips_tpu_torch.main``) on the CPU: two epochs
with checkpoints, metrics lines and a profiler trace, a resumed run that
repeats an unbroken one exactly, the checkpoint manager, the efficiency
tracker, streaming, the camelyon datasets and the overrides (the
traffic CLI is in test_torch_traffic.py)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from ips_tpu_torch.config import _parse_override, config_from_dict
from ips_tpu_torch.data.mnist import generate_megapixel_mnist
from ips_tpu_torch.main import main
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_data import conf_dict
from test_torch_loop import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    """A JSON config (shuffle and dropout on, grouped sparse steps as
    shipped) over a generated 10 + 4 image set."""
    d = tmp_path_factory.mktemp("main")
    generate_megapixel_mnist(str(d / "data"), n_train=10, n_test=4,
                             width=200, height=200, n_noise=4,
                             digit_source="synthetic")
    path = str(d / "config.json")
    with open(path, "w") as f:
        json.dump(conf_dict(str(d / "data"), n_epoch=2, n_worker=2,
                            steps_per_dispatch=2), f)
    return path


def cli(config_path, tmp, name, *over):
    return main(["--config", config_path, "--device", "cpu",
                 f"checkpoint_dir={tmp / name}", "checkpoint_every=1",
                 f"metrics_path={tmp / (name + '.jsonl')}", *over])


def lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_train_checkpoint_resume(config_path, tmp_path, capsys):
    trainer, log_train, log_test = cli(config_path, tmp_path, "run",
                                       f"profile_dir={tmp_path / 'trace'}",
                                       "log_every=1")
    out = capsys.readouterr().out
    assert trainer.device.type == "cpu" and trainer.step == 6
    assert "step 6: loss" in out and "Test Epoch: 2" in out
    rows = lines(tmp_path / "run.jsonl")
    assert [(r["epoch"], r["split"]) for r in rows] == [
        (0, "train"), (0, "test"), (1, "train"), (1, "test")]
    for r in rows:
        assert np.isfinite(r["majority_loss"]) and 0 <= r[
            "majority_accuracy"] <= 1
    assert rows[2]["train_seconds"] > 0
    assert os.listdir(tmp_path / "trace") == ["epoch_0.json"]
    assert CheckpointManager(str(tmp_path / "run")).epochs() == [1, 2]

    # resume from epoch 1: train epoch 1 only, as the unbroken run did
    shutil.copytree(tmp_path / "run", tmp_path / "resumed")
    os.remove(tmp_path / "resumed" / "epoch_2.pt")
    resumed, _, _ = cli(config_path, tmp_path, "resumed", "resume=true")
    assert [r["epoch"] for r in lines(tmp_path / "resumed.jsonl")] == [1, 1]
    assert resumed.step == trainer.step
    a, b = trainer.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = trainer.opt.state_dict()["state"], resumed.opt.state_dict()[
        "state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert lines(tmp_path / "resumed.jsonl")[0] == {
        **rows[2], "train_seconds": lines(tmp_path / "resumed.jsonl")[0][
            "train_seconds"]}

    # a finished run resumed with nothing left to train saves nothing new
    cli(config_path, tmp_path, "run", "resume=true")
    assert CheckpointManager(str(tmp_path / "run")).epochs() == [1, 2]


def test_checkpoint_manager(config_path, tmp_path):
    with open(config_path) as f:
        conf = config_from_dict(json.load(f))
    tr = IPSTrainer(conf, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.restore(tr) is None
    for epoch in range(1, 6):
        tr.step = 10 * epoch
        mgr.save(tr, epoch)
    assert mgr.epochs() == [3, 4, 5]
    fresh = IPSTrainer(conf.replace(seed=1), device="cpu")
    assert mgr.restore(fresh) == 5 and fresh.step == 50
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    # an inference-only trainer restores the weights without the moments
    infer = IPSTrainer(conf.replace(seed=2), device="cpu", init_opt=False)
    assert mgr.restore(infer) == 5 and infer.opt is None
    assert torch.equal(infer.model.encoder.conv1.weight,
                       tr.model.encoder.conv1.weight)
    # ... and what it saves cannot resume a training run
    CheckpointManager(str(tmp_path / "ck2")).save(infer, 1)
    with pytest.raises(ValueError, match="no optimizer state"):
        CheckpointManager(str(tmp_path / "ck2")).restore(tr)


def test_efficiency_tracker_reports_and_stops(config_path, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--config", config_path, "--device", "cpu",
              "track_efficiency=true", "track_epoch=0"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "time: " in out and "avg. time: " in out


def test_camelyon_dataset_builds(tmp_path):
    """``--dataset camelyon`` builds the feature datasets from the two
    HDF5 files the config names."""
    from ips_tpu_torch.data.camelyon.dataset import (CamelyonFeatures,
                                                     make_synth_features)
    from ips_tpu_torch.main import build_datasets
    make_synth_features(str(tmp_path / "a.h5"), n_slides=4, feat_dim=8,
                        n_range=(3, 12), seed=0)
    make_synth_features(str(tmp_path / "b.h5"), n_slides=2, feat_dim=8,
                        n_range=(3, 12), seed=1)
    conf = config_from_dict(dict(
        conf_dict(str(tmp_path), sparse_input=False, use_pos=False),
        is_image=False, n_chan_in=8, train_fname="a.h5",
        test_fname="b.h5"))
    train, test = build_datasets(conf, "camelyon")
    assert isinstance(train, CamelyonFeatures) and (len(train),
                                                    len(test)) == (4, 2)
    assert train[0]["input"].shape[1] == 8


def test_streaming_runs_through_main(config_path, tmp_path):
    """``eager=false`` trains and evaluates through streaming selection,
    and ``preencode_select=true`` runs instead of raising."""
    metrics = str(tmp_path / "m.jsonl")
    trainer, log_train, log_test = main([
        "--config", config_path, "--device", "cpu", "sparse_input=false",
        "eager=false", "n_epoch=1", f"metrics_path={metrics}"])
    assert trainer._streaming is not None and trainer.step > 0
    with open(metrics) as f:
        assert [json.loads(line)["split"] for line in f] == ["train",
                                                             "test"]
    main(["--config", config_path, "--device", "cpu",
          "preencode_select=true", "n_epoch=1"])


def test_overrides_parse_as_jax():
    """key=value overrides mean what they mean to the JAX CLI (YAML 1.1
    scalars: ``1e-3`` stays a string, ``yes`` is true)."""
    from ips_tpu.config import _parse_override as j_parse_override
    vals = ("true", "False", "yes", "3", "0.5", "1e-3", "[50, 50]", "abc",
            "null")
    got = [_parse_override(v) for v in vals]
    assert got == [j_parse_override(v) for v in vals]
    assert got[:3] == [True, False, True] and got[5] == "1e-3"
