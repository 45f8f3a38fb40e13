"""The training slice: the port's IPSTrainer against ips_tpu's.

Tiny image config in fp32 (``TINY`` of test_torch_infer.py), no shuffle
and both dropouts 0, since neither RNG stream can be reproduced across
frameworks; the dropout path is held by its properties. The JAX trainer's
weights and perturbed running statistics go to the port through the
weight bridge. Stated bounds (measured values in each test's docstring):

  * losses and task losses per step: rtol 1e-4
  * step-1 gradients per tensor: relative Frobenius distance 1e-4
  * params after 3 steps per tensor: relative Frobenius distance 1e-3
    (Adam turns a gradient at rounding level into a step of about lr)
  * running statistics after one step from the same state: rtol 1e-4
    (atol 1e-6 for means near 0); after several steps they are computed
    from params that Adam has already moved apart at rounding level
    (measured: ~2e-5 absolute on a mean of -0.0196 after 3 steps, where
    one step gives 5e-7), so they are held per tensor there, at relative
    Frobenius distance 1e-4 (measured 9e-6)

Module-scoped JAX trainers keep the compiles to one per step function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.models.norm import MaskedBatchNorm as JNorm
from ips_tpu.train.schedule import warmup_cosine_lr as j_lr
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu.train.steps import compute_task_losses as j_losses
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.models.transformer import dropout
from ips_tpu_torch.train.schedule import warmup_cosine_lr
from ips_tpu_torch.train.steps import IPSTrainer, compute_task_losses

from test_torch_infer import TINY as INFER_TINY
from test_torch_infer import _perturb_stats

TINY = dict(INFER_TINY, shuffle=False, attn_dropout=0.0, dropout=0.0,
            lr=1e-3, wd=0.1, donate_buffers=False)
LR = 1e-3
STEP_WEIGHTS = ([1.0, 1.0], [1.0, 0.0], [1.0, 1.0])
LOSS_RTOL = 1e-4
GRAD_DIST = 1e-4
PARAM_DIST = 1e-3
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_DIST = 1e-4


# ------------------------------------------------------------------ helpers
def batch(seed, B=2, N=23):
    """One (patches, mask, labels, weights) batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, 16, 16, 1), np.float32)
    x[:, rng.random(N) < 0.4] = 0.0            # blank patches, as in MNIST
    labels = {"majority": rng.integers(0, 10, B).astype(np.int32),
              "multi": (rng.random((B, 10)) < 0.5).astype(np.float32)}
    return x, np.ones((B, N), bool), labels, np.ones(B, np.float32)


def step_batches():
    out = []
    for k, w in enumerate(STEP_WEIGHTS):
        x, m, lab, _ = batch(10 + k)
        out.append((x, m, lab, np.asarray(w, np.float32)))
    return out


def to_torch(x, m, lab, w, device="cpu"):
    return (torch.from_numpy(x).to(device), torch.from_numpy(m).to(device),
            {k: torch.from_numpy(v).to(device) for k, v in lab.items()},
            torch.from_numpy(w).to(device))


def jax_trainer(**over):
    tr = JTrainer(j_config(dict(TINY, **over)), rng=jax.random.PRNGKey(0))
    stats = _perturb_stats(tr.state.batch_stats, np.random.default_rng(1))
    tr.state = tr.state.replace(
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    return tr


def port_trainer(state, **over):
    """A CPU port trainer carrying the JAX TrainState ``state``."""
    tr = IPSTrainer(t_config(dict(TINY, **over)), device="cpu")
    weights.load_jax_train_state(tr, state)
    return tr


def rel_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_flat(state):
    return weights.flatten_variables(state.params, state.batch_stats)


def assert_state_close(port, state, n_steps, dist=PARAM_DIST):
    """Every param within ``dist`` relative Frobenius distance; every
    running statistic within STATS_TOL after one step from a common
    state, within STATS_DIST per tensor after several."""
    got, want = weights.to_flat(port.model), jax_flat(state)
    assert set(got) == set(want)
    worst = 0.0
    for k, v in want.items():
        if k.startswith("batch_stats/") and n_steps == 1:
            np.testing.assert_allclose(got[k], v, **STATS_TOL, err_msg=k)
        elif k.startswith("batch_stats/"):
            d = rel_dist(got[k], v)
            assert d < STATS_DIST, f"{k}: relative distance {d:.3e}"
        else:
            d = rel_dist(got[k], v)
            worst = max(worst, d)
            assert d < dist, f"{k}: relative distance {d:.3e}"
    return worst


def port_grads(model):
    """The parameters' .grad in the reference's names and layouts."""
    out = {}
    for _, ref_key, layout, t in weights._tensors(model):
        if isinstance(t, torch.nn.Parameter):
            g = t.grad.detach()
            g = (g.permute(2, 3, 1, 0) if layout == "conv" else
                 g.t() if layout == "dense" else g)
            out[ref_key] = g.numpy()
    return out


def assert_outputs_close(got, want, rtol=LOSS_RTOL):
    loss, task_losses, preds = got
    np.testing.assert_allclose(loss.numpy(), np.asarray(want[0]), rtol=rtol)
    for k, v in want[1].items():
        np.testing.assert_allclose(task_losses[k].numpy(), np.asarray(v),
                                   rtol=rtol, err_msg=k)
    for k, v in want[2].items():
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=1e-6, err_msg=k)


def run_jax(tr, steps, rng=0):
    """Fused steps from tr's current state: per-step outputs and states."""
    outs, states = [], [tr.state]
    for k, (x, m, lab, w) in enumerate(steps):
        outs.append(tr.fused_step(x, m, lab, w,
                                  jax.random.PRNGKey(rng + k), LR))
        states.append(tr.state)
    return outs, states


def assert_grads_close(port, adam_state_after_1, dist=GRAD_DIST):
    """Step-1 gradients: the port's .grad against optax's first moment
    after one step, mu = (1 - b1) g."""
    want = weights.flatten_variables(adam_state_after_1.inner_state[0].mu)
    got = port_grads(port.model)
    assert set(got) == set(want)
    worst = 0.0
    for k, v in want.items():
        d = rel_dist(got[k], np.asarray(v, np.float64) / 0.1)
        worst = max(worst, d)
        assert d < dist, f"{k}: gradient relative distance {d:.3e}"
    return worst


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """At these tiny shapes a step is a few hundred small ops; with the
    test workers each running torch's default thread pool, they spend
    their time waiting for one another (a 0.9 s test took 37 s in a
    six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp32_run():
    """The JAX trainer's 3 fused steps from the perturbed initial state."""
    tr = jax_trainer()
    outs, states = run_jax(tr, step_batches())
    return tr, outs, states


# -------------------------------------------------------------- units
def test_task_losses_match_jax():
    """Zero weight, softmax preds with exact zeros (the eps path) and
    sigmoid preds at exactly 0 and 1 (the clamp): rtol 1e-6."""
    conf = t_config(dict(TINY))
    rng = np.random.default_rng(3)
    p = rng.random((3, 10)).astype(np.float32)
    p[0, :5] = 0.0
    p /= p.sum(-1, keepdims=True)
    s = rng.random((3, 10)).astype(np.float32)
    s[0, 0], s[1, 1], s[2, 2] = 0.0, 1.0, 1.0
    preds = {"majority": p, "multi": s}
    labels = {"majority": np.array([0, 4, 9], np.int32),
              "multi": (rng.random((3, 10)) < 0.5).astype(np.float32)}
    labels["multi"][0, 0], labels["multi"][1, 1] = 1.0, 0.0
    for w in ([1.0, 0.0, 1.0], [0.0, 0.0, 0.0]):
        w = np.asarray(w, np.float32)
        jl, jt = j_losses(j_config(dict(TINY)), preds, labels, w)
        tl, tt = compute_task_losses(
            conf, {k: torch.from_numpy(v) for k, v in preds.items()},
            {k: torch.from_numpy(v) for k, v in labels.items()},
            torch.from_numpy(w))
        assert np.isfinite(tl.item())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
        for k in jt:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("row_w", [None, [1, 0, 1, 1, 0, 1]],
                         ids=["no_weights", "zero_weight_rows"])
def test_train_batch_norm_matches_flax(row_w):
    """Output, updated running mean/var and the gradients for x, scale and
    bias against flax's MaskedBatchNorm: rtol 1e-5 (atol 1e-6 on the
    gradients of x, whose entries pass through 0)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 5, 5, 3)) * 2 + 0.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    ra_mean = rng.standard_normal(3).astype(np.float32) * 0.1
    ra_var = rng.uniform(0.5, 2, 3).astype(np.float32)
    w = None if row_w is None else np.asarray(row_w, np.float32)

    norm = JNorm()

    def f(x, scale, bias):
        y, mut = norm.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": ra_mean, "var": ra_var}},
            x, use_running_average=False, weights=w, mutable=["batch_stats"])
        return (y * ct).sum(), (y, mut["batch_stats"])

    (_, (jy, jbs)), jg = jax.value_and_grad(f, argnums=(0, 1, 2),
                                            has_aux=True)(x, scale, bias)

    bn = MaskedBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ty = bn(tx, use_running_average=False,
            weights=None if w is None else torch.from_numpy(w))
    (ty * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), jy,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), jbs["mean"],
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), jbs["var"],
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), jg[0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.weight.grad.numpy(), jg[1], rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), jg[2], rtol=1e-5)
    if w is not None:           # zero-weight rows add nothing to the stats
        kept = w > 0
        np.testing.assert_allclose(
            bn.running_mean.numpy(),
            0.9 * ra_mean + 0.1 * x[kept].mean(axis=(0, 1, 2)), rtol=1e-5)


def test_adamw_matches_optax():
    """torch.optim.AdamW (as the trainer builds it) against
    optax.inject_hyperparams(optax.adamw) over 3 steps with a changing lr
    and weight decay on every tensor: rtol 1e-6."""
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    tx = optax.inject_hyperparams(optax.adamw)(
        learning_rate=0.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(tp.values(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    for step, lr in enumerate((1e-3, 5e-3, 2e-4)):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** -step
                     ).astype(np.float32) for k, v in params.items()}
        opt_state.hyperparams["learning_rate"] = lr
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6)


def test_dropout_properties():
    x = torch.randn(100_000)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(dropout(x, 0.0, True, g), x)          # p = 0
    assert torch.equal(dropout(x, 0.1, False, g), x)         # eval ignores p
    a = dropout(x, 0.1, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.1, True, torch.Generator().manual_seed(7))
    c = dropout(x, 0.1, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(a[kept], x[kept] / 0.9, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, True, None)


def test_dropout_reaches_the_train_forward():
    """With dropout on, the train forward depends on the generator and the
    eval forward does not."""
    conf = t_config(dict(TINY, attn_dropout=0.1, dropout=0.1))
    tr = IPSTrainer(conf, device="cpu")
    x, m, lab, w = to_torch(*batch(6))
    mem_patch, mem_pos, _, mem_mask = tr.select(x, m)

    def fwd(train, seed):
        with torch.no_grad():
            return tr.model(mem_patch, mem_pos, None, train=train, weights=w,
                            generator=torch.Generator().manual_seed(seed)
                            )["majority"]
    assert torch.equal(fwd(True, 1), fwd(True, 1))
    assert not torch.equal(fwd(True, 1), fwd(True, 2))
    assert torch.equal(fwd(False, 1), fwd(False, 2))


def test_schedule_matches_reference():
    for step in (0, 5, 99, 100, 101, 700, 1499):
        assert warmup_cosine_lr(step, 10, 150, 10, 1e-3) == j_lr(
            step, 10, 150, 10, 1e-3)


def test_inference_trainer_cannot_train():
    tr = IPSTrainer(t_config(dict(TINY)), device="cpu", init_opt=False)
    x, m, lab, w = to_torch(*batch(7))
    with pytest.raises(RuntimeError, match="init_opt=False"):
        tr.fused_step(x, m, lab, w, None, LR)
    mem = tr.select(x, m)
    with pytest.raises(RuntimeError, match="init_opt=False"):
        tr.train_step(mem[0], mem[1], mem[3], lab, w, None, LR)
    with pytest.raises(RuntimeError, match="init_opt=False"):
        tr.fused_multi_step(x[None], m[None], {k: v[None] for k, v in
                                               lab.items()}, w[None],
                            [None], [LR])


# -------------------------------------------------------------- the slice
def test_fused_step_matches_jax(fp32_run):
    """3 fused steps at lr 1e-3, weights [1, 0] in step 2, from perturbed
    running statistics. Measured: losses within 6.5e-7 relative, step-1
    gradients within 2.7e-6, params after 3 steps within 9.1e-5, running
    statistics after one step within 1.4e-7 and after 3 within 9.2e-6
    per tensor."""
    _, outs, states = fp32_run
    port = port_trainer(states[0])
    for k, step in enumerate(step_batches()):
        x, m, lab, w = to_torch(*step)
        got = port.fused_step(x, m, lab, w, None, LR)
        assert_outputs_close(got, outs[k])
        if k == 0:
            assert_grads_close(port, states[1].opt_state)
            assert_state_close(port, states[1], 1)
    assert port.step == 3
    assert_state_close(port, states[3], 3)


def test_resume_from_jax_state(fp32_run):
    """The JAX run's state after 2 steps (params, statistics, AdamW
    moments and count, step) carried into the port: step 3 agrees."""
    _, outs, states = fp32_run
    port = port_trainer(states[2])
    assert port.step == 2
    x, m, lab, w = to_torch(*step_batches()[2])
    got = port.fused_step(x, m, lab, w, None, LR)
    assert_outputs_close(got, outs[2])
    assert_state_close(port, states[3], 1)
    for t in port.opt.state.values():
        assert t["step"].item() == 3


def test_fused_multi_step_matches_jax(fp32_run):
    """K = 3 stacked steps in one call against JAX's scan."""
    tr, _, states = fp32_run
    tr.state = states[0]
    steps = step_batches()
    stack = [np.stack(a) for a in zip(*[(x, m, w) for x, m, _, w in steps])]
    labs = {k: np.stack([s[2][k] for s in steps]) for k in steps[0][2]}
    want = tr.fused_multi_step(stack[0], stack[1], labs, stack[2],
                               jax.random.split(jax.random.PRNGKey(0), 3),
                               [LR, 2 * LR, LR])
    port = port_trainer(states[0])
    x, m, lab, w = to_torch(stack[0], stack[1], labs, stack[2])
    got = port.fused_multi_step(x, m, lab, w, [None] * 3, [LR, 2 * LR, LR])
    assert got[0].shape == (3,) and got[2]["multi"].shape == (3, 2, 10)
    assert_outputs_close(got, want)
    assert_state_close(port, tr.state, 3)


def test_train_and_eval_steps_match_jax(fp32_run):
    """select + train_step, eval_step and fused_eval_step (both the
    embedding-reuse and the re-encode forms) from the same state."""
    tr, _, states = fp32_run
    tr.state = states[0]
    port = port_trainer(states[0])
    x, m, lab, w = batch(8)
    w = np.asarray([1.0, 0.0], np.float32)
    tx, tm, tlab, tw = to_torch(x, m, lab, w)

    assert_outputs_close(port.fused_eval_step(tx, tm, tlab, tw),
                         tr.fused_eval_step(x, m, lab, w,
                                            jax.random.PRNGKey(0)))
    port.conf = port.conf.replace(eval_reuse_emb=False)
    assert_outputs_close(port.fused_eval_step(tx, tm, tlab, tw),
                         tr.fused_eval_step(x, m, lab, w,
                                            jax.random.PRNGKey(0)))
    jmem = tr.select(x, m)
    tmem = port.select(tx, tm)
    np.testing.assert_array_equal(tmem[2].numpy(), np.asarray(jmem[2]))
    assert_outputs_close(
        port.eval_step(tmem[0], tmem[1], tmem[3], tlab, tw),
        tr.eval_step(jmem[0], jmem[1], jmem[3], lab, w))
    assert_outputs_close(
        port.train_step(tmem[0], tmem[1], tmem[3], tlab, tw, None, LR),
        tr.train_step(jmem[0], jmem[1], jmem[3], lab, w,
                      jax.random.PRNGKey(0), LR))
    assert_state_close(port, tr.state, 1)


def test_multi_step_equals_sequential_steps():
    """With shuffle and dropout on, fused_multi_step is K fused_steps with
    the same generators and lrs, bitwise."""
    conf = t_config(dict(TINY, shuffle=True, attn_dropout=0.1, dropout=0.1))
    a = IPSTrainer(conf, device="cpu")
    b = IPSTrainer(conf, device="cpu")
    steps = [to_torch(*s) for s in step_batches()]
    lrs = [LR, 3 * LR, LR / 2]
    seq = [a.fused_step(*s, a.new_generator(k), lrs[k])
           for k, s in enumerate(steps)]
    stacked = [torch.stack(t) for t in zip(*[(x, m, w) for x, m, _, w in
                                              steps])]
    labs = {k: torch.stack([s[2][k] for s in steps]) for k in steps[0][2]}
    multi = b.fused_multi_step(stacked[0], stacked[1], labs, stacked[2],
                               [b.new_generator(k) for k in range(3)], lrs)
    assert torch.equal(multi[0], torch.stack([o[0] for o in seq]))
    for k in multi[2]:
        assert torch.equal(multi[2][k], torch.stack([o[2][k] for o in seq]))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a.step == b.step == 3
