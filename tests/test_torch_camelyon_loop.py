"""The port's driver loop on camelyon features against ips_tpu's: one
``train_one_epoch`` and one ``evaluate`` at B = 4 from B_seq = 1 loader
slots (r = 4), K = 2, fp32, with the bounds of test_torch_loop.py: losses
rtol 1e-4, metrics equal, the whole model 1e-3 (measured 1.1e-4 and
1.2e-4), each tensor's update 0.1 and the running statistics' 1e-3
(measured at most 6.0e-4 over every tensor). The projector's Linear bias
is the exception: a train-mode BatchNorm subtracts it again, so its
gradient is rounding in both packages (first moment ~1e-9 against the
Linear weight's 3.4e-3) and AdamW steps it by the sign of that noise; it
is held to that, within GRAD_ROUNDING of the weight's.

The corpora are chosen so that the epoch takes every assembled schedule
on bucket-padded (1, N, F) slides: 14 train slides of 9..18 rows (buckets
16 and 24) come in r-groups of one bucket, one bucket, two buckets and a
partial group of two, so the first two optimizer steps run as one
``fused_assembled_multi_step``, the mixed group through the
select-assemble step (``legacy``) and the last partial optimizer batch
likewise, zero-padded with weight-0 rows. The 10 test slides (4..39
rows, buckets 8 to 40) make a mixed eval group with an M >= N slide, a
one-bucket group evaluated alone, and a partial group.
"""

import os

import jax
import numpy as np
import pytest

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.camelyon import dataset as jds
from ips_tpu.data.loader import DataLoader as JLoader
from ips_tpu.train.loop import evaluate as j_evaluate
from ips_tpu.train.loop import train_one_epoch as j_train
from ips_tpu.train.metrics import MetricsLogger as JLogger
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.camelyon import dataset as tds
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.train import loop as tloop
from ips_tpu_torch.train.metrics import MetricsLogger
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_camelyon import feat_conf
from test_torch_loop import (GRAD_ROUNDING, MODEL_DIST,  # noqa: F401
                             PARAM_UPDATE_DIST, STATS_UPDATE_DIST, Recorder,
                             assert_runs_match, few_torch_threads, flat_state,
                             rel_dist, update_dists)

N_TRAIN, N_TEST = 14, 10


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("camelyon_loop"))
    jds.make_synth_features(os.path.join(d, "train.h5"), n_slides=N_TRAIN,
                            feat_dim=32, n_range=(9, 19), seed=8)
    jds.make_synth_features(os.path.join(d, "test.h5"), n_slides=N_TEST,
                            feat_dim=32, n_range=(4, 40), seed=29)
    return d


def _epoch(side, trainer, conf):
    """One train epoch and one eval pass: (train, test) recorders, each
    with the number of slides its logger saw (``n_rows``)."""
    if side == "jax":
        ds, L, Log, train, ev = (jds.CamelyonFeatures, JLoader, JLogger,
                                 j_train, j_evaluate)
    else:
        ds, L, Log, train, ev = (tds.CamelyonFeatures, DataLoader,
                                 MetricsLogger, tloop.train_one_epoch,
                                 tloop.evaluate)
    rec_train = Recorder(Log, conf.task_list)
    train(trainer, L(ds(conf, train=True), batch_size=conf.B_seq,
                     shuffle=True, seed=conf.seed), 0, rec_train.logger, conf)
    rec_train.n_rows = len(rec_train.logger.y_trues["metastases"])
    rec_train.logger.compute_metric()
    rec_test = Recorder(Log, conf.task_list)
    ev(trainer, L(ds(conf, train=False), batch_size=conf.B_seq),
       rec_test.logger, conf)
    rec_test.n_rows = len(rec_test.logger.y_trues["metastases"])
    rec_test.logger.compute_metric()
    return rec_train, rec_test


@pytest.mark.parametrize("ln_fold", [False, True], ids=["exact", "ln_fold"])
def test_assembled_epoch_matches_jax(corpus, monkeypatch, ln_fold):
    c = feat_conf(corpus, ln_fold=ln_fold)
    jtr = JTrainer(j_config(c), rng=jax.random.PRNGKey(0))
    initial = jtr.state
    jax_out = _epoch("jax", jtr, j_config(c))

    port = IPSTrainer(t_config(c), device="cpu")
    weights.load_jax_train_state(port, initial)
    calls = []
    for name in ("fused_assembled_multi_step", "fused_assembled_step",
                 "train_step", "fused_assembled_eval_step",
                 "fused_assembled_eval_multi_step", "eval_step"):
        def spy(*a, _name=name, _fn=getattr(port, name), **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(port, name, spy)
    port_out = _epoch("torch", port, t_config(c))

    # two assembled steps as one group, the mixed group and the partial
    # last batch through the select-assemble step; eval: a mixed group,
    # a one-bucket group alone, the partial group
    assert calls == ["fused_assembled_multi_step", "train_step",
                     "train_step", "eval_step", "fused_assembled_eval_step",
                     "eval_step"]
    assert_runs_match(port_out, jax_out, 4)
    assert [out.n_rows for out in port_out] == [N_TRAIN, N_TEST]
    for out in port_out:
        assert 0.0 <= out.logger.metrics["metastases"][-1] <= 1.0
    assert port.step == int(jtr.state.step) == 4
    assert_state_match(port, jtr.state, initial)


# the Linear's bias feeds a train-mode BatchNorm, which subtracts it with
# the batch mean: its gradient is 0 up to rounding in either package
ZERO_GRAD = "params/encoder/fc/bias"


def _first_moments(port, state):
    """AdamW's first moment of every parameter, in both packages, in the
    reference's names and layouts."""
    mu = weights.flatten_variables(state.opt_state.inner_state[0].mu)
    ours = {}
    for key, ref_key, layout, t in weights._tensors(port.model):
        if key in dict(port.model.named_parameters()):
            m = port.opt.state[t]["exp_avg"].detach().float()
            ours[ref_key] = (m.t() if layout == "dense" else m).numpy()
    assert ours.keys() == mu.keys()
    return ours, {k: np.asarray(v) for k, v in mu.items()}


def assert_state_match(port, state, initial):
    """test_torch_loop.py's bounds, the whole model included; the update
    of the one tensor whose gradient is rounding (ZERO_GRAD) is held only
    to that: its first moment within GRAD_ROUNDING of the Linear weight's
    RMS in both packages, where AdamW steps it by the noise's sign."""
    got, want = weights.to_flat(port.model), flat_state(state)
    params = sorted(k for k in want if k.startswith("params/"))
    whole = rel_dist(np.concatenate([got[k].ravel() for k in params]),
                     np.concatenate([np.ravel(want[k]) for k in params]))
    assert whole < MODEL_DIST, f"whole model: {whole:.3e}"
    for side in _first_moments(port, state):
        rms = np.sqrt(np.mean(side["params/encoder/fc/kernel"] ** 2))
        print(f"fc bias first moment {np.abs(side[ZERO_GRAD]).max():.3e}"
              f" of the kernel's RMS {rms:.3e}")
        assert np.abs(side[ZERO_GRAD]).max() < GRAD_ROUNDING * rms
    dists = update_dists(port, state, initial)
    print(f"whole model {whole:.3e}; largest update distance " + str(max(
        (d, k) for k, d in dists.items() if k != ZERO_GRAD)))
    for k, d in dists.items():
        bound = (PARAM_UPDATE_DIST if k.startswith("params/")
                 else STATS_UPDATE_DIST)
        if k != ZERO_GRAD:
            assert d < bound, f"{k}: update relative distance {d:.3e}"
