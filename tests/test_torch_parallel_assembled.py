"""B_seq < B over several data ranks (gloo ranks on the CPU) against JAX's
single-device assembled steps and the port's single process.

Worlds of 2x1 and 2x2 ranks (``run_world``, each with its deadline) at
B = 4 from B_seq = 1 slots (r = 4, two a data rank), N = 16 patches of
16x16, M = I = 4, ``use_pos``, masked patches, fp32, from the JAX
trainer's weights (``weights.py``); shuffle off and dropout 0 where JAX
is the reference. Stated bounds:

  * one ``fused_assembled_step`` (K = 1): the loss within 1e-5 of JAX's,
    every parameter within 1e-5 of JAX's after the step, leaving out the
    elements whose gradient is nonzero but within rounding of 0 (below
    1e-4 of its tensor's RMS; fewer than 1% of each tensor), which
    AdamW's first step, about lr * sign(g), may move either way;
  * ``fused_assembled_multi_step`` (K = 2): both steps' losses within
    1e-5 of JAX's; the parameters after the group within 1e-5 of one
    process of the port, outside the same elements of either step (the
    second step carries the first one's moves of such elements through
    every layer, against JAX up to 1.5e-4 in one process too);
  * dropout and instance shuffle on: the slots' kept indices bitwise
    equal to one process of the port, the loss and predictions within
    1e-6, parameters within 1e-5 outside the same elements;
  * the streamed select-assemble-train (``eager: false``) at 2x1 through
    ``train_one_epoch`` and ``evaluate``, shuffle and dropout on, against
    one process's B_seq = 1 loop on the same items: losses and eval
    predictions within 1e-6, parameters as above;
  * parameters, AdamW moments and running statistics bitwise equal on
    every rank;
  * the driver as 2 ranks on a tiny camelyon feature store (the CLI) and
    a tiny camelyon_e2e tile corpus (``main.run``): both ranks end
    bitwise equal, rank 0 alone writes the metrics lines, and the
    epoch-0 train loss is within 1e-5 of one process fed the same
    optimizer batches (each of the camelyon group's 4 step losses within
    6e-8), the test loss after the epoch's updates within 5e-5 (measured
    1.18e-5 for camelyon: the ranks' gradient sums round apart from one
    process's, and AdamW's first step, about lr * sign(g), moves an
    element whose gradient is within rounding of 0 either way).

Also the loader at optimizer-batch granularity against the JAX loader
that ``ips_tpu/main.py`` builds for P processes, the ``preencode``
resolution on the global table, and the error for r % n_data != 0.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.loader import DataLoader as JLoader
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import main as driver
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
from ips_tpu_torch.parallel.launch import run_world
from ips_tpu_torch.parallel.mesh import DATA_AXIS, PATCH_AXIS, Mesh
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_loop import few_torch_threads  # noqa: F401
from test_torch_parallel import TINY
from test_torch_parallel_train import JAX_TOL, PORT_TOL, _keep, _port_grads
from torch_parallel_worker import ArrayDataset, e2e_slides, recorded_epoch

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
LR = 1e-3
K, R = 2, 4
ASM = dict(TINY, B=4, B_seq=1, N=16, M=4, I=4, steps_per_dispatch=K)
RANDOM = dict(dropout=0.1, attn_dropout=0.1, shuffle=True,
              shuffle_style="instance")
STREAMED = dict(RANDOM, eager=False, stream_chunk_group=2, n_epoch=1,
                n_worker=0)
MESHES = [(2, 1), (2, 2)]
ITEMS = 4
CLI_LOSS_TOL = {"train": 1e-5, "test": 5e-5}


def make_slots(seed=0):
    """K optimizer batches of r slots of one row, their labels, the
    slots' selection seeds and the steps' train seeds."""
    rng = np.random.default_rng(seed)
    x = rng.random((K, R, 1, 16, 16, 16, 1)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0.0
    mask = np.ones((K, R, 1, 16), bool)
    mask[:, 1, 0, 12:] = False
    labels = {"majority": rng.integers(0, 10, (K, R)).astype(np.int32),
              "multi": (rng.random((K, R, 10)) < 0.5).astype(np.float32)}
    return dict(patches=x, mask=mask, weights=np.ones((K, R), np.float32),
                seeds=rng.integers(0, 2**40, (K, R)),
                train_seeds=rng.integers(0, 2**40, K),
                **{f"label/{k}": v for k, v in labels.items()}), labels


def make_items(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((ITEMS, 16, 16, 16, 1)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0.0
    mask = np.ones((ITEMS, 16), bool)
    mask[2, 13:] = False
    return {"input": x, "mask": mask,
            "label/majority": rng.integers(0, 10, ITEMS).astype(np.int32),
            "label/multi": (rng.random((ITEMS, 10)) < 0.5).astype(
                np.float32)}


def _mu_grads(jtr):
    """JAX's gradients of its first step: AdamW's first moment is
    0.1 * g after one step."""
    mu = weights.flatten_variables(jtr.state.opt_state.inner_state[0].mu)
    return {k: np.asarray(v) / 0.1 for k, v in mu.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_assembled")
    b, labels = make_slots()
    np.savez(d / "slots.npz", **b)
    np.savez(d / "items.npz", **make_items())
    jtr = JTrainer(j_config(ASM), rng=jax.random.PRNGKey(0))
    initial = jtr.state
    np.savez(d / "weights.npz", **weights.flatten_variables(
        initial.params, initial.batch_stats))
    with open(d / "conf.json", "w") as f:
        json.dump({"conf": ASM, "lr": LR, "random": RANDOM,
                   "streamed": STREAMED}, f)

    ref = {}
    keys = jax.random.split(jax.random.PRNGKey(1), K * R).reshape(K, R, 2)
    tkeys = jax.random.split(jax.random.PRNGKey(2), K)
    loss = jtr.fused_assembled_step(
        b["patches"][0], b["mask"][0], {k: v[0] for k, v in labels.items()},
        b["weights"][0], keys[0], tkeys[0], LR)[0]
    ref["k1"] = (float(loss), weights.flatten_variables(
        jtr.state.params, jtr.state.batch_stats), _mu_grads(jtr))
    jtr.state = initial
    losses = jtr.fused_assembled_multi_step(
        b["patches"], b["mask"], labels, b["weights"], keys, tkeys,
        np.full(K, LR, np.float32))[0]
    ref["k2/losses"] = np.asarray(losses)

    t = {k: torch.from_numpy(v) for k, v in b.items()}
    lab = {k: torch.from_numpy(v) for k, v in labels.items()}

    def port(**over):
        tr = IPSTrainer(t_config(dict(ASM, **over)), device="cpu")
        weights.load_flat(tr.model, str(d / "weights.npz"))
        return tr

    def gens(tr, seeds):
        return [tr.new_generator(int(s)) for s in seeds]

    # one process: step 1's gradients, the K = 2 group and its step-2
    # gradients, the step with dropout and shuffle on
    tr = port()
    tr.fused_assembled_step(t["patches"][0], t["mask"][0],
                            {k: v[0] for k, v in lab.items()},
                            t["weights"][0], gens(tr, b["seeds"][0]),
                            tr.new_generator(int(b["train_seeds"][0])), LR)
    step1 = _port_grads(tr)
    tr = port()
    tr.fused_assembled_multi_step(
        t["patches"], t["mask"], lab, t["weights"],
        [gens(tr, s) for s in b["seeds"]], gens(tr, b["train_seeds"]),
        [LR] * K)
    ref["k2"] = (weights.to_flat(tr.model), step1, _port_grads(tr))
    tr = port(**RANDOM)
    with torch.no_grad():
        ref["random/idx"] = tr._select_slots(
            t["patches"][0], t["mask"][0],
            gens(tr, b["seeds"][0]))[2].numpy()
    loss, _, preds = tr.fused_assembled_step(
        t["patches"][0], t["mask"][0], {k: v[0] for k, v in lab.items()},
        t["weights"][0], gens(tr, b["seeds"][0]),
        tr.new_generator(int(b["train_seeds"][0])), LR)
    ref["random"] = (float(loss), {k: v.numpy() for k, v in preds.items()},
                     weights.to_flat(tr.model), _port_grads(tr))

    # one process of the streamed B_seq = 1 loop on the same items
    conf = t_config(dict(ASM, **STREAMED))
    tr = port(**STREAMED)
    ds = ArrayDataset(str(d / "items.npz"))
    ref["streamed"] = (recorded_epoch(
        tr, conf, DataLoader(ds, batch_size=1, shuffle=True, seed=conf.seed),
        DataLoader(ds, batch_size=1)), weights.to_flat(tr.model),
        _port_grads(tr))

    ranks = {}
    for data, patch in MESHES:
        run_world("torch_parallel_worker:assembled", data * patch,
                  [str(d), str(data), str(patch)], timeout=WORLD_TIMEOUT,
                  python_path=[TESTS])
        ranks[data, patch] = [
            dict(np.load(d / f"rank{f'asm{data}x{patch}'}_{r}.npz"))
            for r in range(data * patch)]
    return ref, ranks


def _assert_params(out, tag, state, grads, tol=JAX_TOL):
    """Parameters within ``tol`` outside the elements whose gradient
    (any of ``grads``) lies within rounding of 0; running statistics
    within rtol 1e-4."""
    keeps = [_keep(g) for g in grads]
    for k, v in state.items():
        got = out[f"{tag}/{k}"]
        if k.startswith("params/"):
            keep = np.logical_and.reduce([kp[k] for kp in keeps])
            np.testing.assert_allclose(got[keep], v[keep], rtol=0, atol=tol,
                                       err_msg=k)
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=JAX_TOL,
                                       err_msg=k)


IDS = dict(ids=lambda m: f"{m[0]}x{m[1]}")


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_one_assembled_step_matches_jax(case, mesh):
    ref, ranks = case
    loss, state, grads = ref["k1"]
    out = ranks[mesh][0]
    assert abs(float(out["k1/loss"]) - loss) <= JAX_TOL * max(abs(loss), 1)
    _assert_params(out, "k1", state, [grads])


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_two_assembled_steps_match_jax(case, mesh):
    ref, ranks = case
    out = ranks[mesh][0]
    np.testing.assert_allclose(out["k2/loss"], ref["k2/losses"], rtol=0,
                               atol=JAX_TOL)
    state, step1, step2 = ref["k2"]
    _assert_params(out, "k2", state, [step1, step2])


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_dropout_and_shuffle_match_one_process(case, mesh):
    ref, ranks = case
    loss, preds, state, grads = ref["random"]
    for r, out in enumerate(ranks[mesh]):
        d = r // mesh[1]
        np.testing.assert_array_equal(out["random/idx"],
                                      ref["random/idx"][2 * d:2 * d + 2])
    out = ranks[mesh][0]
    assert abs(float(out["random/loss"]) - loss) <= PORT_TOL
    for k, v in preds.items():
        np.testing.assert_allclose(out[f"random/preds/{k}"], v, rtol=0,
                                   atol=PORT_TOL)
    _assert_params(out, "random", state, [grads])


def test_streamed_schedule_matches_one_process(case):
    ref, ranks = case
    epoch, state, grads = ref["streamed"]
    out = ranks[2, 1][0]
    for k, v in epoch.items():
        np.testing.assert_allclose(out[f"streamed/{k}"], v, rtol=0,
                                   atol=PORT_TOL, err_msg=k)
    _assert_params(out, "streamed", state, [grads])


@pytest.mark.parametrize("mesh", MESHES, **IDS)
def test_state_is_bitwise_equal_on_every_rank(case, mesh):
    _, ranks = case
    first = ranks[mesh][0]
    keys = [k for k in first if not k.endswith("/idx")
            and "/loss" not in k and "/preds/" not in k]
    assert any("/opt/" in k for k in keys)
    assert any("batch_stats" in k for k in keys)
    for out in ranks[mesh][1:]:
        for k in keys:
            assert np.array_equal(out[k], first[k]), k


# ------------------------------------------------------------------ shapes
def _mesh(d, p):
    return Mesh({DATA_AXIS: d, PATCH_AXIS: p}, (0, 0), torch.device("cpu"))


def test_preencode_resolves_on_the_global_table():
    """'auto' pre-encodes a table over 96 MiB: (4, 30000, 16, 16, 1) fp32
    is 117 MiB whole and 59 MiB on each of 2 data ranks. Both ranks
    resolve it as one process does."""
    shape = (2, 1, 30000, 16, 16, 1)
    one = IPSTrainer(t_config(ASM), device="cpu", init_opt=False)
    two = ShardedIPSTrainer(t_config(dict(ASM, mesh_data=2)),
                            mesh=_mesh(2, 1), device="cpu", init_opt=False)
    assert one._slots_preencode((4,) + shape[1:], torch.float32)
    assert two._slots_preencode(shape, torch.float32)
    # the rank's own table alone would not pre-encode
    assert not one._slots_preencode(shape, torch.float32)
    small = (2, 1, 8000, 16, 16, 1)         # 31 MiB whole
    assert not two._slots_preencode(small, torch.float32)


class _Buckets:
    """37 items in 3 buckets."""

    def __len__(self):
        return 37

    def bucket_of(self, i):
        return i % 3

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64)}


@pytest.mark.parametrize("P", [2, 4])
def test_loader_at_optimizer_batches_matches_jax(P):
    """``main.build_loaders`` for data rank p of P with B_seq < B: the
    rows of the JAX loader that ``ips_tpu/main.py:49-84`` builds for
    process p of P (batch B, buckets forced, shuffle, two epochs)."""
    conf = t_config(dict(ASM, B=8, B_seq=1, n_worker=0))
    ds = _Buckets()
    for p in range(P):
        train, test = driver.build_loaders(conf, ds, ds, p, P)
        jtrain, jtest = (JLoader(ds, batch_size=conf.B, shuffle=shuffle,
                                 seed=conf.seed, bucket_fn=ds.bucket_of,
                                 process_index=p, process_count=P)
                         for shuffle in (True, False))
        for ours, theirs in ((train, jtrain), (train, jtrain),
                             (test, jtest)):
            got = [b["x"][:, 0].tolist() for b in ours]
            want = [b["x"][:, 0].tolist() for b in theirs]
            assert got == want and len(got) == len(ours) == len(theirs)
            assert all(len(b) == conf.B // P for b in got)


def test_slots_need_r_divisible_by_data_ranks():
    """r = B / B_seq = 2 does not divide over 4 data ranks: JAX's
    ValueError before any step, from the CLI's check."""
    conf = t_config(dict(ASM, B=4, B_seq=2, mesh_data=4))
    with pytest.raises(ValueError, match="r=2, data=4"):
        driver._check_multihost_path(conf)


# ----------------------------------------------------------------- driver
class SlotLoader:
    """The optimizer batches of a B-row loader handed out one B_seq-row
    loader batch at a time: one process fed the 2-rank run's batches."""

    def __init__(self, inner, B_seq):
        self.inner, self.B_seq = inner, B_seq

    def __len__(self):
        return len(self.inner) * (self.inner.batch_size // self.B_seq)

    def __iter__(self):
        for b in self.inner:
            for j in range(0, len(next(iter(b.values()))), self.B_seq):
                yield {k: v[j:j + self.B_seq] for k, v in b.items()}


def _one_process(monkeypatch, run):
    """``run()`` in this process with the loaders of the 2-rank run, at
    B_seq-row granularity."""
    def loaders(conf, train, test, data_rank=0, n_data=1):
        return tuple(SlotLoader(DataLoader(
            ds, batch_size=conf.B, shuffle=shuffle, seed=conf.seed,
            bucket_fn=ds.bucket_of, drop_last=True), conf.B_seq)
            for ds, shuffle in ((train, True), (test, False)))
    monkeypatch.setattr(driver, "build_loaders", loaders)
    return run()


def _metrics(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


FEAT = dict(n_epoch=1, B=4, B_seq=1, n_epoch_warmup=1, lr=1e-3, wd=0.1,
            n_class=1, train_fname="train.h5", test_fname="test.h5",
            n_worker=0, is_image=False, enc_type="resnet50", n_chan_in=32,
            shuffle=True, shuffle_style="batch", n_token=1, M=8, I=8,
            use_pos=False, H=2, D=16, D_k=8, D_v=8, D_inner=32,
            attn_dropout=0.1, dropout=0.1, compute_dtype="float32",
            ln_fold=True, steps_per_dispatch=4,
            tasks={"task0": {"id": 0, "name": "metastases",
                             "act_fn": "sigmoid", "metric": "auc"}})
E2E = dict(FEAT, is_image=True, enc_type="resnet18", n_chan_in=3,
           n_res_blocks=2, N=0, M=4, I=4, patch_size=[16, 16],
           patch_stride=[16, 16], D=128, eager=False, stream_chunk_group=2,
           grad_encode_chunk=2, ln_fold=False, steps_per_dispatch=1)
# every slide in one bucket (72 rows of features, 36 tiles): 16 train
# slides are four optimizer batches (one K = 4 group), 8 e2e ones two;
# the test sets one and two full batches
SLIDES = {"camelyon": ((16, (41, 72)), (8, (41, 72))),
          "camelyon_e2e": {"train": [21, 30, 36, 25, 33, 22, 28, 35],
                           "test": [23, 34, 29, 26], "tile_hw": [16, 16]}}


def _driver_case(tmp, dataset, name, **over):
    base = FEAT if dataset == "camelyon" else E2E
    d = tmp / name
    os.makedirs(d, exist_ok=True)
    conf = dict(base, data_dir=str(tmp), metrics_path=str(d / "m.jsonl"),
                **over)
    with open(d / "config.json", "w") as f:
        json.dump(conf, f)
    if dataset == "camelyon_e2e":
        with open(d / "slides.json", "w") as f:
            json.dump(SLIDES[dataset], f)
    return d


@pytest.mark.parametrize("dataset", ["camelyon", "camelyon_e2e"])
def test_driver_as_two_ranks(tmp_path, monkeypatch, dataset):
    from ips_tpu_torch.data.camelyon.dataset import (CamelyonFeatures,
                                                     make_synth_features)
    from ips_tpu_torch.data.camelyon.patches import CamelyonPatches
    if dataset == "camelyon":
        (n_tr, r_tr), (n_te, r_te) = SLIDES[dataset]
        make_synth_features(str(tmp_path / "train.h5"), n_tr, 32, r_tr, 0)
        make_synth_features(str(tmp_path / "test.h5"), n_te, 32, r_te, 4)
    one = _driver_case(tmp_path, dataset, "one")
    conf = t_config(json.load(open(one / "config.json")))
    if dataset == "camelyon":
        datasets = (CamelyonFeatures(conf, True),
                    CamelyonFeatures(conf, False))
    else:
        train, test = e2e_slides(SLIDES[dataset])
        datasets = (CamelyonPatches(conf, True, slides=train),
                    CamelyonPatches(conf, False, slides=test))
    assert len({ds.bucket_of(i) for ds in datasets
                for i in range(len(ds))}) == 1
    single, _, _ = _one_process(monkeypatch, lambda: driver.run(
        conf, dataset, "cpu", datasets=datasets))
    monkeypatch.undo()

    two = _driver_case(tmp_path, dataset, "two", multihost=True,
                       cpu_collectives="gloo", mesh_data=2)
    run_world("torch_parallel_worker:driver", 2,
              [dataset, str(two / "config.json"), str(two)],
              timeout=WORLD_TIMEOUT, python_path=[TESTS])
    a, b = (dict(np.load(two / f"rank{r}.npz")) for r in range(2))
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(a["step"]) == single.step == len(datasets[0]) // conf.B
    rows, ref = _metrics(two / "m.jsonl"), _metrics(one / "m.jsonl")
    assert [(r["epoch"], r["split"]) for r in rows] == [
        (0, "train"), (0, "test")]
    for got, want in zip(rows, ref):
        assert abs(got["metastases_loss"] - want["metastases_loss"]) \
            <= CLI_LOSS_TOL[got["split"]], (got, want)
