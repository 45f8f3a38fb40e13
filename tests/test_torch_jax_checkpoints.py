"""The JAX package's TPU-trained MNIST checkpoints as the port reads them
(``ips_tpu_torch/results/trained/``, written by
``tests/torch_jax_checkpoints.py`` from ``ckpt_mnist150/{100,150}`` and
``ckpt_mnist40/44``).

  * Each committed ``.npz`` holds its orbax step's restored leaves
    bitwise (every leaf, the Adam and hyperparameter counts, the step,
    the epoch), and ``manifest.json`` the run's overrides and records.
  * One resumed training step from each train state, the port's from the
    ``.npz`` against JAX's from the orbax step, in fp32 with no shuffle
    or dropout at N = 16, M = I = 4, B = 2 (the weights do not depend on
    them), at the lr of the resumed epoch's first step: losses and
    predictions within test_torch_train.py's rtol 1e-4, parameters and
    AdamW moments within its relative Frobenius distance 1e-3, running
    statistics within its rtol 1e-4, each parameter's update within
    ``UPDATE_DIST`` (the weights' fp32 rounding), Adam's step one past
    the stored count.
  * The lr of every step of the resumed epochs (313 steps each) equals
    JAX's schedule, the last of each epoch the TPU's logged ``lr``
    within 1e-9 relative, and the state's injected lr (fp32) is the
    schedule's at the step before the checkpoint, on the schedule of the
    run that wrote it.
  * ``main.run`` resumed from the ``epoch_<n>.pt`` that
    ``save_reference_state`` writes trains epoch n first.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from ips_tpu.train.loop import warmup_cosine_lr as j_lr
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict
from ips_tpu_torch.scripts import trained_eval as te
from ips_tpu_torch.train.loop import _lr as t_lr
from ips_tpu_torch.train.steps import IPSTrainer

import test_torch_train as ttt
import torch_jax_checkpoints as jc

STEPS_PER_EPOCH = 313          # 5000 images at B = 16, as the TPU ran
REDUCED = {"N": 16, "M": 4, "I": 4, "B": 2, "B_seq": 2,
           "steps_per_dispatch": 1, "shuffle": False, "dropout": 0.0,
           "attn_dropout": 0.0, "compute_dtype": "float32",
           "input_dtype": "float32", "sparse_input": False}
# each parameter's update (after - before, both fp32) against JAX's, as
# a relative Frobenius distance. Adam's stored moments dominate a trained
# state's update, so the packages' gradients (1e-4 apart) barely move it;
# the fp32 weights' rounding does: at lr 2.9e-6 (mnist40_e44) one ulp of
# a weight near 0.1 (7.5e-9) is 0.26% of its step. Measured: 2.644e-3
# (mnist40_e44), 4.985e-5 (mnist150_e100, lr 2.7e-4)
UPDATE_DIST = 1e-2
TRAIN_STATES = ("mnist150_e100", "mnist40_e44")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smoke():
    return te.chip_smoke()


def reduced_config(name: str) -> dict:
    return {**smoke().MNIST_CONFIG, "data_dir": "",
            **te.manifest()[name]["overrides"], **REDUCED}


@pytest.fixture(scope="module")
def restored():
    """name -> (JAX trainer at the reduced config, epoch), each orbax step
    restored once."""
    out = {}
    for name, (source, *_) in jc.STEPS.items():
        over = {k: v for k, v in reduced_config(name).items()
                if k in REDUCED or k in jc.RUN_KEYS}
        out[name] = jc.restore_step(source, over)
    return out


@pytest.mark.parametrize("name", sorted(jc.STEPS))
def test_npz_equals_orbax_step(restored, name):
    source, kind, log, writer, records = jc.STEPS[name]
    trainer, epoch = restored[name]
    entry = te.manifest()[name]
    assert entry["source"] == source and entry["epoch"] == epoch
    assert epoch == int(os.path.basename(source))
    assert entry["overrides"] == jc.log_overrides(log)
    assert entry["written_n_epoch"] == jc.log_overrides(writer)["n_epoch"]
    assert entry["records"] == sum((jc.record_lines(p, e)
                                    for p, e in records), [])
    want = jc.flat_state(trainer, epoch, kind)
    got = weights.read_npz(te.npz_path(name))
    assert set(got) == set(want)
    assert len(got) == jc.n_leaves(trainer, kind) + (kind == "train")
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if kind == "train":
        steps = epoch * STEPS_PER_EPOCH
        assert int(got["step"]) == steps
        assert int(got["opt_state/count"]) == steps
        assert int(got["opt_state/inner_state/0/count"]) == steps


@pytest.mark.parametrize("name", TRAIN_STATES)
def test_flat_train_state_loads_into_the_trainer(name):
    conf = config_from_dict(reduced_config(name))
    tr = IPSTrainer(conf, device="cpu")
    flat = weights.read_npz(te.npz_path(name))
    epoch = weights.load_flat_train_state(tr, flat)
    assert epoch == te.manifest()[name]["epoch"]
    assert tr.step == epoch * STEPS_PER_EPOCH
    assert weights.to_flat(tr.model).keys() == {
        k for k in flat if k.startswith(("params/", "batch_stats/"))}
    for k, v in weights.to_flat(tr.model).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    params = dict(tr.model.named_parameters())
    # a conv kernel and a dense kernel: HWIO and (in, out) on the JAX side
    for ref, key, to_port in (
            ("encoder/conv1/kernel", "encoder.conv1.weight",
             lambda a: np.transpose(a, (3, 2, 0, 1))),
            ("transf/crs_attn/q_w/kernel", "transf.crs_attn.q_w.weight",
             np.transpose)):
        st = tr.opt.state[params[key]]
        for moment, m in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = flat[f"opt_state/inner_state/0/{moment}/{ref}"]
            np.testing.assert_array_equal(st[m].numpy(), to_port(want))
    for st in tr.opt.state.values():
        assert st["step"].item() == epoch * STEPS_PER_EPOCH
    assert len(tr.opt.state) == len(params)
    # an inference trainer takes the weights alone
    inf = IPSTrainer(conf, device="cpu", init_opt=False)
    assert weights.load_flat_train_state(inf, flat) == epoch


def _step_batch():
    """Two 200x200 megapixel-MNIST test images (16 patches of 50x50)."""
    from ips_tpu_torch.data.mnist import generate_split
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        generate_split(d, "test", 2, width=200, height=200, noise=True,
                       n_noise=1, seed=0, digit_source="sklearn",
                       mnist_path=None)
        data = np.load(os.path.join(d, "test.npy"), allow_pickle=True)
    from ips_tpu_torch.native import densify_patchify
    x = np.stack([densify_patchify(*s["input"], (200, 200, 1), (50, 50),
                                   (50, 50)) for s in data])
    labels = {k: np.stack([s[k] for s in data]).astype(
        np.float32 if k == "multi" else np.int32)
        for k in ("majority", "max", "top", "multi")}
    return (x.astype(np.float32), np.ones(x.shape[:2], bool), labels,
            np.ones(2, np.float32))


@pytest.mark.parametrize("name", TRAIN_STATES)
def test_resumed_step_matches_jax(restored, name):
    """The first step of the resumed epoch, from the same trained state."""
    jtr, epoch = restored[name]
    conf = config_from_dict(reduced_config(name))
    lr = t_lr(conf, epoch, STEPS_PER_EPOCH, 0)
    x, m, lab, w = _step_batch()
    before = jc.flat_state(jtr, epoch, "train")
    port = IPSTrainer(conf, device="cpu")
    assert weights.load_flat_train_state(port, te.npz_path(name)) == epoch
    state = jtr.state
    try:
        want = jtr.fused_step(x, m, lab, w, jax.random.PRNGKey(0), lr)
        after = jc.flat_state(jtr, epoch, "train")
        jstate = jtr.state
    finally:
        jtr.state = state           # the fixture's state stays restored
    got = port.fused_step(*ttt.to_torch(x, m, lab, w), None, lr)
    ttt.assert_outputs_close(got, want)
    ttt.assert_state_close(port, jstate, 1)
    assert float(after["opt_state/hyperparams/learning_rate"]) == \
        np.float32(lr)
    assert int(after["opt_state/inner_state/0/count"]) == \
        epoch * STEPS_PER_EPOCH + 1
    port_flat = weights.to_flat(port.model)
    worst = 0.0
    for k in port_flat:
        if k.startswith("params/"):
            d = ttt.rel_dist(port_flat[k] - before[k], after[k] - before[k])
            worst = max(worst, d)
            assert d < UPDATE_DIST, f"{k}: update relative distance {d:.3e}"
    print(f"{name}: worst update relative distance {worst:.3e}")
    for _, ref, layout, t in weights._tensors(port.model):
        if not isinstance(t, torch.nn.Parameter):
            continue
        st = port.opt.state[t]
        assert st["step"].item() == epoch * STEPS_PER_EPOCH + 1
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            g = st[key].detach()
            g = (g.permute(2, 3, 1, 0) if layout == "conv" else
                 g.t() if layout == "dense" else g).numpy()
            j = after[f"opt_state/inner_state/0/{moment}/" + ref[7:]]
            d = ttt.rel_dist(g, j)
            assert d < ttt.PARAM_DIST, f"{moment} {ref}: {d:.3e}"


@pytest.mark.parametrize("name", TRAIN_STATES)
def test_resumed_lr_schedule(name):
    entry = te.manifest()[name]
    conf = config_from_dict(dict(smoke().MNIST_CONFIG, data_dir="",
                                 **entry["overrides"]))
    epoch = entry["epoch"]
    rec = te.tpu_records(name)
    for e in (epoch, epoch + 1):
        lrs = [t_lr(conf, e, STEPS_PER_EPOCH, it)
               for it in range(STEPS_PER_EPOCH)]
        want = [j_lr(e * STEPS_PER_EPOCH + it + 1, STEPS_PER_EPOCH,
                     conf.n_epoch, conf.n_epoch_warmup, conf.lr)
                for it in range(STEPS_PER_EPOCH)]
        assert lrs == want
        tpu = rec["train", e]["lr"]
        assert abs(lrs[-1] - tpu) <= te.BOUNDS["lr_rel"] * tpu, (e, lrs[-1])
    # the stored lr is the last step's of the run that wrote the state,
    # on that run's schedule (mnist40_e44: n_epoch 44, so 1e-6)
    flat = weights.read_npz(te.npz_path(name))
    writer = conf.replace(n_epoch=entry["written_n_epoch"])
    assert flat["opt_state/hyperparams/learning_rate"] == np.float32(
        t_lr(writer, epoch - 1, STEPS_PER_EPOCH, STEPS_PER_EPOCH - 1))


TPU_LR = {("mnist150_e100", 100): 2.737317453800964e-04,
          ("mnist150_e100", 101): 2.638026030947372e-04,
          ("mnist40_e44", 44): 2.9007483031731e-06,
          ("mnist40_e44", 45): 1e-06}


@pytest.mark.parametrize("name,epoch", sorted(TPU_LR))
def test_tpu_lr_values(name, epoch):
    """The four lr values the resumed runs are held to, as the TPU logged
    them (results/mnist_150epoch_metrics.jsonl, mnist_resume46_*)."""
    assert te.tpu_records(name)["train", epoch]["lr"] == TPU_LR[name, epoch]
    conf = config_from_dict(dict(smoke().MNIST_CONFIG, data_dir="",
                                 **te.manifest()[name]["overrides"]))
    lr = t_lr(conf, epoch, STEPS_PER_EPOCH, STEPS_PER_EPOCH - 1)
    assert abs(lr - TPU_LR[name, epoch]) <= 1e-9 * TPU_LR[name, epoch]


def test_resume_through_main_run(tmp_path):
    """``save_reference_state`` then ``main.run(resume=true)`` on a tiny
    store: the run starts at the stored epoch and ends at n_epoch (46),
    the step counters carried on."""
    from ips_tpu_torch import main as driver
    from ips_tpu_torch.data.mnist import generate_megapixel_mnist
    from ips_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                save_reference_state)
    name = "mnist40_e44"
    data = str(tmp_path / "mnist")
    generate_megapixel_mnist(data, n_train=32, n_test=16, width=200,
                             height=200, n_noise=1)
    ckpt = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "m.jsonl")
    c = dict(reduced_config(name), data_dir=data, B=16, B_seq=16,
             steps_per_dispatch=2, sparse_input=True, n_worker=0,
             resume=True, checkpoint_dir=ckpt, metrics_path=metrics)
    conf = config_from_dict(c)
    path = save_reference_state(conf, te.npz_path(name), ckpt)
    assert os.path.basename(path) == "epoch_44.pt"
    trainer, _, _ = driver.run(conf, "mnist", "cpu")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["epoch"], r["split"]) for r in rows] == [
        (44, "train"), (44, "test"), (45, "train"), (45, "test")]
    steps = 44 * STEPS_PER_EPOCH + 2 * math.ceil(32 / 16)
    assert trainer.step == steps
    for st in trainer.opt.state.values():
        assert st["step"].item() == steps
    assert np.isfinite([v for r in rows for k, v in r.items()
                        if k.endswith("_loss")]).all()
    assert CheckpointManager(ckpt).epochs()[-1] == 46
    # a run cut after one epoch saves that epoch
    ckpt2 = str(tmp_path / "ckpt2")
    conf2 = conf.replace(checkpoint_dir=ckpt2, metrics_path="")
    save_reference_state(conf2, te.npz_path(name), ckpt2)
    tr2, _, _ = driver.run(conf2, "mnist", "cpu", epochs=1)
    assert tr2.step == 44 * STEPS_PER_EPOCH + 2
    assert CheckpointManager(ckpt2).epochs() == [44, 45]


def _card_lines():
    """The card's ``eval --against`` lines (bound (iv)): per file, each
    parting image's entry and the card's kept sets, by image."""
    path = os.path.join(te.TRAINED, "card", "card.jsonl")
    with open(path) as f:
        lines = [json.loads(x) for x in f]
    return {ln["file"]: ({int(i): t for i, t in
                          ln["against_jax"]["kept_differ"].items()},
                         ln["predictor"]["kept"])
            for ln in lines if "against_jax" in ln}


def test_bound_iv_reads_both_sides_near_ties():
    """The card's recorded kept sets against JAX's: 11 of 320 images part
    where the card's replay sees no near tie; JAX's own bf16 and fp32
    selections part at a near tie on each of them, and the card keeps
    JAX's fp32 set there (``calibration/near_tie_jax.json``), so no image
    misses the bound."""
    cards = _card_lines()
    jax_ties = te.jax_near_ties(os.path.join(
        te.TRAINED, "calibration", "near_tie_jax.json"))
    alone = {n: te.kept_misses(t, {}, kept) for n, (t, kept) in cards.items()}
    assert {n: len(m) for n, m in alone.items()} == {
        "mnist150_e150": 2, "mnist40_e44": 9}
    for name, (t, kept) in cards.items():
        assert te.kept_misses(t, jax_ties[name], kept) == []
        # the JAX side decides only where the card's side did not
        for i, entry in t.items():
            if not entry["near_tie"]:
                assert te.is_near_tie(jax_ties[name][i])
                assert jax_ties[name][i]["fp32_kept"] == kept[i]
    # an image JAX's selections do not part on stays a miss
    one, kept = {7: {"near_tie": False}}, {7: [1, 2]}
    assert len(te.kept_misses(one, {}, kept)) == 1
    far = {7: {"step": 0, "gap_at_M": 1e-3, "max_score_diff": 1e-4,
               "fp32_kept": [1, 2]}}
    assert len(te.kept_misses(one, far, kept)) == 1
    # a near tie on JAX's side passes only the card set that is JAX's fp32
    # selection: one that is neither JAX's bf16 set nor its fp32 set misses
    tie = {7: {"step": 0, "gap_at_M": 1e-6, "max_score_diff": 1e-4,
               "fp32_kept": [1, 2]}}
    assert te.kept_misses(one, tie, kept) == []
    assert len(te.kept_misses(one, tie, {7: [1, 3]})) == 1


def test_first_parting_of_two_replays():
    """``_first_parting`` matches the two replays' candidates by patch
    index and reads the run dtype's gap at the M-th place."""
    M = 2
    idx = np.array([[0, 1, 2, 3]])
    run = [{"idx": idx, "scores": np.array([[0.4, 0.3, 0.2, 0.1]]),
            "kept": np.array([[0, 1]])},
           {"idx": np.array([[0, 1, 4, 5]]),
            "scores": np.array([[0.3, 0.30001, 0.2, 0.2]]),
            "kept": np.array([[1, 0]])}]
    fp32 = [{"idx": idx, "scores": np.array([[0.4, 0.3, 0.2, 0.1]]),
             "kept": np.array([[1, 0]])},
            {"idx": np.array([[1, 0, 5, 4]]),
             "scores": np.array([[0.3, 0.29, 0.2, 0.31]]),
             "kept": np.array([[4, 1]])}]
    rep = jc._first_parting(run, fp32, 0, M)
    assert rep["step"] == 1
    assert rep["gap_at_M"] == pytest.approx(0.3 - 0.2)
    # patch 1: 0.30001 against 0.3; patch 0: 0.3 against 0.29; patch 4:
    # 0.2 against 0.31, the largest
    assert rep["max_score_diff"] == pytest.approx(0.11)
    assert jc._first_parting(run[:1], fp32[:1], 0, M) is None
