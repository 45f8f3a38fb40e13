"""Data and exact context parallelism over gloo ranks on the CPU against
JAX's single-device IPSTrainer and the port's single process.

2x1, 1x2 and 2x2 worlds (``run_world``, each with its deadline) at the
shape of ``tiny_conf`` (B = 4, N = 16 patches of 16x16, M = 8, I = 4,
``use_pos``, fp32), from the JAX trainer's weights (``weights.py``),
shuffle off and dropout 0 where JAX is the reference. Stated bounds:

  * selection indices: bitwise equal to JAX's and to one process of the
    port, in every rank's rows;
  * one fused dense and one fused sparse step: the loss within 1e-5 of
    JAX's, every parameter within 1e-5 of JAX's after the step, leaving
    out the elements whose gradient is nonzero but within rounding of 0
    (below 1e-4 of its tensor's RMS; fewer than 1% of each tensor), which
    AdamW's first step, about lr * sign(g), may move either way;
  * dropout and instance shuffle on: indices equal to one process of the
    port, the loss and predictions within 1e-6; parameters within 1e-5
    outside the same near-zero-gradient elements (the ranks' gradient
    sums round apart from one process's, and AdamW's first step
    lr * g / (|g| + 1e-8) carries that into an element whose gradient
    is a few eps: 2.9e-6 measured in 1 of 128 BatchNorm scales);
  * parameters, AdamW moments and running statistics bitwise equal on
    every rank;
  * the local-merge selection (1x2, 2x2; M = 4) bitwise equal to one
    process's ``ips_select_cp`` with 2 shards.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.parallel.ips_sharded import ips_select_cp
from ips_tpu_torch.parallel.launch import run_world
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_loop import GRAD_ROUNDING
from test_torch_parallel import TINY

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
LR = 1e-3
JAX_TOL = 1e-5
PORT_TOL = 1e-6
MERGE_M = 4
RANDOM = dict(dropout=0.1, attn_dropout=0.1, shuffle=True,
              shuffle_style="instance")
MESHES = [(2, 1), (1, 2), (2, 2)]
B, HW, PS = 4, 64, 16


def make_batch(seed=0):
    """Images of HW x HW with 80% blank pixels, as dense patches and as
    sparse (flat index, value) pairs padded with zeros; random labels."""
    rng = np.random.default_rng(seed)
    img = rng.random((B, HW, HW, 1)).astype(np.float32)
    img[rng.random(img.shape) < 0.8] = 0.0
    g = HW // PS
    patches = img.reshape(B, g, PS, g, PS, 1).transpose(
        0, 1, 3, 2, 4, 5).reshape(B, g * g, PS, PS, 1)
    nnz = int(max((im != 0).sum() for im in img))
    flat_idx = np.zeros((B, nnz), np.int32)
    values = np.zeros((B, nnz), np.float32)
    for b in range(B):
        f = np.flatnonzero(img[b])
        flat_idx[b, :len(f)] = f
        values[b, :len(f)] = img[b].reshape(-1)[f]
    labels = {"majority": rng.integers(0, 10, B).astype(np.int32),
              "multi": (rng.random((B, 10)) < 0.5).astype(np.float32)}
    return dict(patches=patches, mask=np.ones((B, g * g), bool),
                weights=np.ones(B, np.float32), flat_idx=flat_idx,
                values=values, img_hw=np.array([HW, HW]),
                **{f"label/{k}": v for k, v in labels.items()}), labels


def _flat_state(jtr):
    return weights.flatten_variables(jtr.state.params, jtr.state.batch_stats)


def _keep(grads):
    """Per tensor, the elements whose gradient is 0 or clear of
    rounding."""
    keep = {}
    for k, g in grads.items():
        g = np.abs(np.asarray(g, np.float64))
        keep[k] = (g == 0) | (g > GRAD_ROUNDING * np.sqrt(np.mean(g ** 2)))
        assert (~keep[k]).mean() < 0.01, k
    return keep


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX reference (selection, one dense and one sparse fused step
    from the same state), one process of the port with dropout and
    shuffle on, and every world's rank outputs."""
    d = tmp_path_factory.mktemp("parallel_train")
    arrays, labels = make_batch()
    np.savez(d / "batch.npz", **arrays)
    jtr = JTrainer(j_config(TINY), rng=jax.random.PRNGKey(0))
    initial = jtr.state
    np.savez(d / "weights.npz", **_flat_state(jtr))
    with open(d / "conf.json", "w") as f:
        json.dump({"conf": TINY, "lr": LR, "random": RANDOM,
                   "merge_M": MERGE_M}, f)

    ref = {}
    key = jax.random.PRNGKey(0)
    ref["idx"] = np.asarray(jtr.select(arrays["patches"], arrays["mask"],
                                       key)[2])
    for tag in ("dense", "sparse"):
        jtr.state = initial
        if tag == "dense":
            loss = jtr.fused_step(arrays["patches"], arrays["mask"], labels,
                                  arrays["weights"], key, LR)[0]
        else:
            loss = jtr.fused_sparse_step(
                arrays["flat_idx"], arrays["values"], (HW, HW),
                arrays["mask"], labels, arrays["weights"], key, LR)[0]
        ref[tag] = (float(loss), _flat_state(jtr), weights.flatten_variables(
            jtr.state.opt_state.inner_state[0].mu))

    # one process of the port, dropout and instance shuffle on
    port = IPSTrainer(t_config(dict(TINY, **RANDOM)), device="cpu")
    weights.load_flat(port.model, str(d / "weights.npz"))
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    lab = {k: torch.from_numpy(v) for k, v in labels.items()}
    ref["random/idx"] = port.select(t["patches"], t["mask"],
                                    port.new_generator(7))[2].numpy()
    loss, _, preds = port.fused_step(t["patches"], t["mask"], lab,
                                     t["weights"], port.new_generator(7), LR)
    ref["random"] = (float(loss), {k: v.numpy() for k, v in preds.items()},
                     weights.to_flat(port.model), _port_grads(port))

    # one process of the port's local merge, 2 shards
    merge = IPSTrainer(t_config(dict(TINY, M=MERGE_M)), device="cpu")
    weights.load_flat(merge.model, str(d / "weights.npz"))
    with torch.no_grad():
        ref["merge/idx"] = ips_select_cp(
            merge.model.encode, merge.model.scores, t["patches"], M=MERGE_M,
            I=TINY["I"], n_shards=2, pos_table=merge.pos_table,
            mask=t["mask"]).mem_idx.numpy()

    ranks = {}
    for data, patch in MESHES:
        run_world("torch_parallel_worker:train", data * patch,
                  [str(d), str(data), str(patch)], timeout=WORLD_TIMEOUT,
                  python_path=[TESTS])
        ranks[data, patch] = [
            dict(np.load(d / f"rank{data}x{patch}_{r}.npz"))
            for r in range(data * patch)]
    return ref, ranks


def _port_grads(port):
    """The port's gradients of its last step under the reference names
    (a model whose weights are the gradients)."""
    saved = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    with torch.no_grad():
        for p in port.model.parameters():
            p.copy_(p.grad)
        grads = {k: v for k, v in weights.to_flat(port.model).items()
                 if k.startswith("params/")}
        for n, p in port.model.named_parameters():
            p.copy_(saved[n])
    return grads


def _rows(data, patch, r):
    k = B // data
    d = r // patch
    return slice(d * k, (d + 1) * k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_selection_matches_jax_and_one_process(case, mesh):
    ref, ranks = case
    for r, out in enumerate(ranks[mesh]):
        rows = _rows(*mesh, r)
        np.testing.assert_array_equal(out["idx"], ref["idx"][rows])
        np.testing.assert_array_equal(out["random/idx"],
                                      ref["random/idx"][rows])
        if mesh[1] == 2:
            np.testing.assert_array_equal(out["merge/idx"],
                                          ref["merge/idx"][rows])


def _assert_step(out, tag, loss, state, grads, loss_tol):
    assert abs(float(out[f"{tag}/loss"]) - loss) <= loss_tol * max(
        abs(loss), 1)
    keep = _keep(grads)
    for k, v in state.items():
        got = out[f"{tag}/{k}"]
        if k in keep:
            np.testing.assert_allclose(got[keep[k]], v[keep[k]], rtol=0,
                                       atol=JAX_TOL, err_msg=k)
        elif k.startswith("batch_stats/"):
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=JAX_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("tag", ["dense", "sparse"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_fused_step_matches_jax(case, mesh, tag):
    ref, ranks = case
    loss, state, mu = ref[tag]
    grads = {k: np.asarray(v) / 0.1 for k, v in mu.items()}
    _assert_step(ranks[mesh][0], tag, loss, state, grads, JAX_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dropout_and_shuffle_match_one_process(case, mesh):
    ref, ranks = case
    loss, preds, state, grads = ref["random"]
    out = ranks[mesh][0]
    _assert_step(out, "random", loss, state, grads, PORT_TOL)
    for k, v in preds.items():
        np.testing.assert_allclose(out[f"random/preds/{k}"], v, rtol=0,
                                   atol=PORT_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_state_is_bitwise_equal_on_every_rank(case, mesh):
    _, ranks = case
    first = ranks[mesh][0]
    keys = [k for k in first if k.split("/")[0] in ("dense", "sparse",
                                                    "random")
            and not k.endswith("/idx")]
    assert any(k.split("/")[1] == "opt" for k in keys)
    assert any("batch_stats" in k for k in keys)
    for out in ranks[mesh][1:]:
        for k in keys:
            assert np.array_equal(out[k], first[k]), k
