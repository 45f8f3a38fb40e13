"""The port's training driver against ips_tpu's: ``train_one_epoch`` and
``evaluate`` on the sparse schedules (also fed dense batches), the port's
own schedules against each other, and the error paths.

Tiny config of tests/test_sparse_input.py (200x200, N = 16, M = I = 4,
fp32, ``shuffle=False``, both dropouts 0, since neither RNG stream can be
reproduced across frameworks), 10 train and 4 test images from the
generator (sklearn digits), B = 4: the third train batch is ragged. The
JAX trainer's initial state goes to the port through the weight bridge.
Stated bounds, with the values measured on the CPU:

  * per-step task losses (what each loop hands its MetricsLogger.update):
    rtol 1e-4 (measured 1.3e-5);
  * epoch metrics, train and test: equal;
  * parameters after the epoch: relative Frobenius distance of the whole
    model 1e-3 (measured 2.6e-4);
  * each tensor's update over the epoch (final minus initial) against
    JAX's update, relative to JAX's: parameters 0.1 (measured 3.05e-2),
    running statistics 1e-3 (measured 4.1e-4). A tensor the loop left
    unchanged is at 1 and fails, and each of them moves;
  * each parameter's update after the first optimizer step alone
    (test_torch_loop_dense.py): 1e-3 (measured 6.2e-5), over the
    elements whose step-1 gradient is not within rounding of 0.

An epoch's parameter updates cannot be held closer. AdamW's first step
is about lr * sign(g) for each element, so an element whose gradient
lies within rounding of 0 (JAX's gradients lie within 2e-5 of an fp64
evaluation of the same step, the port's within 1e-6) may step either
way; after the first step that moves 4 tensors by more than 1e-3 of
their update (measured 4.5e-3), and the two later steps carry the
difference through every layer above (3.05e-2 after 3 steps, 28 of 71
tensors past 1e-3). The port run against itself from weights nudged by
one float32 rounding (1.2e-7 relative) diverges as far: 3.74e-2, 29
tensors past 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.loader import DataLoader as JLoader
from ips_tpu.data.mnist import MegapixelMNIST as JMNIST
from ips_tpu.data.mnist import generate_megapixel_mnist
from ips_tpu.train.loop import evaluate as j_evaluate
from ips_tpu.train.loop import train_one_epoch as j_train
from ips_tpu.train.metrics import MetricsLogger as JLogger
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.data.mnist import MegapixelMNIST
from ips_tpu_torch.train.loop import evaluate, train_one_epoch
from ips_tpu_torch.train.metrics import MetricsLogger
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_data import conf_dict

LOSS_RTOL = 1e-4
MODEL_DIST = 1e-3
PARAM_UPDATE_DIST = 0.1
STATS_UPDATE_DIST = 1e-3
STEP1_UPDATE_DIST = 1e-3
# a step-1 gradient element below this fraction of its tensor's RMS is
# within rounding of 0 (5x JAX's measured gradient error)
GRAD_ROUNDING = 1e-4


def loop_conf(data_dir, **over):
    return conf_dict(data_dir, shuffle=False, dropout=0.0, attn_dropout=0.0,
                     **over)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """A few hundred small ops a step: with six test workers each running
    torch's default thread pool, they wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist_loop"))
    generate_megapixel_mnist(d, n_train=10, n_test=4, width=200, height=200,
                             n_noise=4, digit_source="sklearn")
    return d


@pytest.fixture(scope="module")
def jax_trainer(data_dir):
    """One JAX trainer for every schedule (its jitted steps compile once);
    each run starts again from ``initial``."""
    tr = JTrainer(j_config(loop_conf(data_dir)), rng=jax.random.PRNGKey(0))
    return tr, tr.state


class Recorder:
    """A MetricsLogger that also keeps each step's task losses."""

    def __init__(self, cls, tasks):
        self.logger = cls(tasks)
        self.steps = []
        update = self.logger.update

        def record(losses, *a, **kw):
            self.steps.append(dict(losses))
            return update(losses, *a, **kw)
        self.logger.update = record


MNIST = {"jax": JMNIST, "torch": MegapixelMNIST}


def run_epoch(side, trainer, conf, data_conf=None, dataset=MNIST):
    """One train epoch then one eval pass over datasets of class
    ``dataset[side]`` made from ``data_conf`` (default ``conf``); (train,
    test) recorders."""
    M = dataset[side]
    if side == "jax":
        L, Log, train, ev = JLoader, JLogger, j_train, j_evaluate
    else:
        L, Log, train, ev = (DataLoader, MetricsLogger, train_one_epoch,
                             evaluate)
    data_conf = data_conf or conf
    loader = L(M(data_conf, train=True), batch_size=conf.B_seq, shuffle=True,
               seed=conf.seed)
    rec_train = Recorder(Log, conf.task_list)
    train(trainer, loader, 0, rec_train.logger, conf)
    rec_train.logger.compute_metric()
    rec_test = Recorder(Log, conf.task_list)
    ev(trainer, L(M(data_conf, train=False), batch_size=conf.B_seq),
       rec_test.logger, conf)
    rec_test.logger.compute_metric()
    return rec_train, rec_test


def rel_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def assert_runs_match(port_out, jax_out, n_train_steps):
    for got, want in zip(port_out, jax_out):
        assert len(got.steps) == len(want.steps)
        for g, w in zip(got.steps, want.steps):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=k)
        assert dict(got.logger.metrics) == dict(want.logger.metrics)
    assert len(port_out[0].steps) == n_train_steps


def flat_state(state):
    return weights.flatten_variables(state.params, state.batch_stats)


def update_dists(port, state, initial, keep=None):
    """Per tensor: the distance of the port's update (final minus
    initial) from JAX's, relative to JAX's, over the elements ``keep``
    selects (all by default)."""
    got, want, start = weights.to_flat(port.model), flat_state(state), \
        flat_state(initial)
    assert got.keys() == want.keys()
    dists = {}
    for k, v in want.items():
        m = keep[k] if keep is not None and k in keep else Ellipsis
        d_want = (np.asarray(v, np.float64) - start[k])[m]
        d_got = (np.asarray(got[k], np.float64) - start[k])[m]
        assert np.linalg.norm(d_want) > 0, f"{k}: JAX left it unchanged"
        dists[k] = rel_dist(d_got, d_want)
    return dists


def assert_state_match(port, state, initial):
    got, want = weights.to_flat(port.model), flat_state(state)
    params = sorted(k for k in want if k.startswith("params/"))
    whole = rel_dist(np.concatenate([got[k].ravel() for k in params]),
                     np.concatenate([np.ravel(want[k]) for k in params]))
    assert whole < MODEL_DIST, f"whole model: {whole:.3e}"
    for k, d in update_dists(port, state, initial).items():
        bound = (PARAM_UPDATE_DIST if k.startswith("params/")
                 else STATS_UPDATE_DIST)
        assert d < bound, f"{k}: update relative distance {d:.3e}"


def assert_first_step(port, state, initial):
    """Each parameter's update after one optimizer step within
    STEP1_UPDATE_DIST of JAX's, leaving out the elements whose step-1
    gradient (optax's first moment / 0.1) is nonzero but below
    GRAD_ROUNDING of its tensor's RMS, which AdamW may step either way;
    they must be under 1% of each tensor."""
    mu = weights.flatten_variables(state.opt_state.inner_state[0].mu)
    keep = {}
    for k, v in mu.items():
        g = np.abs(np.asarray(v, np.float64)) / 0.1
        keep[k] = (g == 0) | (g > GRAD_ROUNDING * np.sqrt(np.mean(g ** 2)))
        assert (~keep[k]).mean() < 0.01, k
    dists = update_dists(port, state, initial, keep)
    assert set(keep) < set(dists)
    for k in keep:
        assert dists[k] < STEP1_UPDATE_DIST, \
            f"{k}: update relative distance {dists[k]:.3e}"


def run_both(data_dir, jax_trainer, data=None, make_conf=None,
             dataset=MNIST, **over):
    """One epoch and one eval pass in each package from the same state;
    ``data`` overrides the config the datasets are made from. The config
    is ``make_conf(data_dir, **over)`` (default ``loop_conf``), the
    datasets of classes ``dataset`` (default megapixel MNIST)."""
    make_conf = make_conf or loop_conf
    jtr, initial = jax_trainer
    c = make_conf(data_dir, **over)
    dc = make_conf(data_dir, **dict(over, **data)) if data else None
    jtr.state = initial
    jax_out = run_epoch("jax", jtr, j_config(c), dc and j_config(dc),
                        dataset)
    port = IPSTrainer(t_config(c), device="cpu")
    weights.load_jax_train_state(port, initial)
    port_out = run_epoch("torch", port, t_config(c), dc and t_config(dc),
                         dataset)
    return port, port_out, jtr.state, jax_out


# The sparse schedules (the shipped config's path), one step at a time and
# grouped; 3 train batches, so K = 2 makes one group of two and a single,
# K = 4 three singles through the grouped driver. sparse_k2_dense_batches
# feeds the sparse schedule a dataset that emits dense batches, which each
# take the select-assemble-train step alone. The dense and assembled
# schedules are in test_torch_loop_dense.py.
@pytest.mark.parametrize("over", [
    dict(sparse_input=True, steps_per_dispatch=1),
    dict(sparse_input=True, steps_per_dispatch=2),
    dict(sparse_input=True, steps_per_dispatch=4),
    dict(sparse_input=True, steps_per_dispatch=2,
         data=dict(sparse_input=False)),
], ids=["sparse_k1", "sparse_k2", "sparse_k4", "sparse_k2_dense_batches"])
def test_epoch_matches_jax(data_dir, jax_trainer, over):
    port, port_out, state, jax_out = run_both(data_dir, jax_trainer, **over)
    assert_runs_match(port_out, jax_out, 3)
    assert port.step == int(state.step) == 3
    assert_state_match(port, state, jax_trainer[1])


# ------------------------------------------------------ the port's own runs
def port_epochs(data_dir, n_epoch=2, **over):
    """Two epochs with shuffle and dropout on, so every step's generator
    matters; returns the trainer and each step's losses."""
    c = t_config(conf_dict(data_dir, n_epoch=n_epoch, **over))
    tr = IPSTrainer(c, device="cpu")
    loader = DataLoader(MegapixelMNIST(c, train=True), batch_size=c.B_seq,
                        shuffle=True, seed=c.seed)
    rec = Recorder(MetricsLogger, c.task_list)
    for epoch in range(n_epoch):
        train_one_epoch(tr, loader, epoch, rec.logger, c)
        rec.logger.compute_metric()
    test = Recorder(MetricsLogger, c.task_list)
    evaluate(tr, DataLoader(MegapixelMNIST(c, train=False),
                            batch_size=c.B_seq), test.logger, c)
    return tr, rec.steps + test.steps


@pytest.mark.parametrize("sparse,K", [(True, 2), (True, 4), (False, 2)],
                         ids=["sparse_k2", "sparse_k4", "dense_k2"])
def test_grouped_equals_single_steps(data_dir, sparse, K):
    single, single_losses = port_epochs(data_dir, sparse_input=sparse,
                                        steps_per_dispatch=1)
    grouped, grouped_losses = port_epochs(data_dir, sparse_input=sparse,
                                          steps_per_dispatch=K)
    assert grouped_losses == single_losses
    a, b = single.model.state_dict(), grouped.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_densify_inside_matches_dense_batches(data_dir):
    """The sparse path's per-step densify gives the dense path's batches:
    a sparse and a dense run of the same seed make the same updates."""
    sparse, sparse_losses = port_epochs(data_dir, n_epoch=1,
                                        sparse_input=True)
    dense, dense_losses = port_epochs(data_dir, n_epoch=1,
                                      sparse_input=False)
    assert sparse_losses == dense_losses
    a, b = sparse.model.state_dict(), dense.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- error paths
def test_unported_schedules_raise(data_dir):
    """B_seq < B over 2 data ranks, which raised while ROADMAP item 6 was
    open, builds: the check passes, and a data rank's loader yields its
    contiguous B / 2 rows of each optimizer batch, its r / 2 slots (the
    worlds that train it are in test_torch_parallel_assembled.py)."""
    from ips_tpu_torch.main import build_loaders
    from ips_tpu_torch.train.loop import check_sharded_slots
    c = t_config(loop_conf(data_dir, B_seq=2, sparse_input=False))
    check_sharded_slots(c, 2)
    ds = MegapixelMNIST(c, train=True)
    whole, _ = build_loaders(c, ds, ds)
    half, _ = build_loaders(c, ds, ds, data_rank=1, n_data=2)
    assert (whole.batch_size, half.batch_size) == (c.B_seq, c.B)
    assert half.drop_last and len(half) == len(ds) // c.B
    ref = DataLoader(ds, batch_size=c.B, shuffle=True, seed=c.seed)
    for got, want in zip(half, ref):
        np.testing.assert_array_equal(got["input"], want["input"][2:])


def test_multihost_settings_run(data_dir):
    """multihost and a process-sharded loader are ported: with one
    process the run is the single-process one, and a data rank's loader
    holds its rows of each batch."""
    c = t_config(loop_conf(data_dir, multihost=True))
    tr = IPSTrainer(c, device="cpu")
    loader = DataLoader(MegapixelMNIST(c, train=False), batch_size=4)
    train_one_epoch(tr, loader, 0, MetricsLogger(c.task_list), c)
    assert tr.step == len(loader)
    half = DataLoader(MegapixelMNIST(c, train=False), batch_size=4,
                      process_index=1, process_count=2)
    full = next(iter(loader))
    assert np.array_equal(next(iter(half))["input_idx"],
                          full["input_idx"][2:])
