"""The traffic training CLI (``ips_tpu_torch.main --dataset traffic``) as
two gloo ranks on the CPU, data parallel (``multihost: true``,
``mesh_data: 2``), 2 loader threads a rank, against one process on the
same optimizer batches (its loaders with drop_last, as the ranks' are),
one epoch on a synthetic corpus at 120x160. Stated bounds:

  * every train step's loss within 1e-5 of one process's, and the test
    loss too (the ranks' gradient and statistics sums round apart from
    one process's; the bound of tests/test_torch_parallel_cli.py);
  * the final parameters, AdamW moments and running statistics bitwise
    equal on both ranks.

The ranks augment each item as one process does only because each
item's draw is its place in the epoch's global order (the loader's
draw rule). This module imports nothing of JAX: its ``rank`` function
runs in the world's processes.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
LOSS_TOL = 1e-5
B = 4
TASKS = {"task0": {"id": 0, "name": "sign", "act_fn": "softmax",
                   "metric": "accuracy"}}


def config(data_dir, **over):
    """tests/test_torch_traffic.py's tiny traffic config at D = 128 with
    ResNet-18/2, 2 loader threads, dropout on."""
    d = dict(n_epoch=1, B=B, B_seq=B, n_epoch_warmup=1, lr=1e-3, wd=0.1,
             n_class=4, data_dir=data_dir, n_worker=2, is_image=True,
             enc_type="resnet18", n_chan_in=3, n_res_blocks=2,
             shuffle=False, n_token=1, N=48, M=4, I=16,
             patch_size=[20, 20], patch_stride=[20, 20], img_size=[120, 160],
             use_pos=False, H=2, D=128, D_k=8, D_v=8, D_inner=64,
             compute_dtype="float32", donate_buffers=False, tasks=TASKS)
    d.update(over)
    return d


def _recording_steps():
    """Records every train step's loss (the loop's per-step log hook)."""
    from ips_tpu_torch.train import loop
    losses = []
    log = loop._maybe_log_step

    def record(conf, data_it, loss, lr):
        losses.append(float(loop._np(loss)))
        return log(conf, data_it, loss, lr)
    return losses, record


def rank(argv):
    """One rank of the world: the CLI, then its step losses, final
    weights, AdamW state and step."""
    path, out_dir = argv
    torch.set_num_threads(1)
    from ips_tpu_torch import weights
    from ips_tpu_torch.main import main
    from ips_tpu_torch.train import loop
    from torch_parallel_worker import _opt_state, _save
    losses, loop._maybe_log_step = _recording_steps()
    tr, _, _ = main(["--dataset", "traffic", "--config", path,
                     "--device", "cpu"])
    _save(out_dir, int(os.environ["RANK"]),
          dict(weights.to_flat(tr.model), **_opt_state(tr.opt),
               step=np.int64(tr.step), losses=np.asarray(losses)))


def _write(d, name, conf):
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ips_tpu_torch.data import loader
    from ips_tpu_torch.data.traffic import TrafficSigns
    from ips_tpu_torch.data.traffic_synth import generate_synth_sts
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.main import main
    from ips_tpu_torch.parallel.launch import run_world
    from ips_tpu_torch.train import loop
    d = str(tmp_path_factory.mktemp("traffic_parallel"))
    data = os.path.join(d, "data")
    generate_synth_sts(data, n_per_set=12, height=120, width=160, seed=0)
    n_train = len(TrafficSigns(config_from_dict(config(data)), True))
    # a ragged tail, so that drop_last leaves items out
    assert n_train % B and n_train // B >= 2

    path = _write(d, "one", config(
        data, metrics_path=os.path.join(d, "one.jsonl")))
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one, record = _recording_steps()
        mp.setattr(loop, "_maybe_log_step", record)
        mp.setattr(loader, "DataLoader",
                   functools.partial(loader.DataLoader, drop_last=True))
        main(["--dataset", "traffic", "--config", path, "--device", "cpu"])
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    out = os.path.join(d, "ranks")
    os.makedirs(out)
    run_world("test_torch_traffic_parallel:rank", 2,
              [_write(d, "two", config(
                  data, metrics_path=os.path.join(d, "two.jsonl"),
                  multihost=True, cpu_collectives="gloo", mesh_data=2)),
               out], timeout=WORLD_TIMEOUT, python_path=[TESTS])
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(2)]
    return d, np.asarray(one), ranks, n_train


def test_step_losses_match_one_drop_last_process(runs):
    d, one, ranks, n_train = runs
    assert len(one) == n_train // B
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one, rtol=0, atol=LOSS_TOL)
    want, got = _rows(os.path.join(d, "one.jsonl")), _rows(
        os.path.join(d, "two.jsonl"))
    assert [x["split"] for x in got] == [x["split"] for x in want] == [
        "train", "test"]
    np.testing.assert_allclose([x["sign_loss"] for x in got],
                               [x["sign_loss"] for x in want], rtol=0,
                               atol=LOSS_TOL)


def test_ranks_end_bitwise_equal(runs):
    _, one, (a, b), _ = runs
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(a["step"]) == len(one)
