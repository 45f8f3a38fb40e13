"""The card-vs-CPU training check of ips_tpu_torch.scripts.train_parity,
on the CPU: one real small fp32 step, and a copy of it in which one ReLU
gate falls on the other side of 0, as on another device.

A flip at a rounding-level gap must be accepted with the gradient and
parameter bounds applied only to the parameters used after it; a flip at a
wide gap, a gradient past the flip that disagrees, or a run in which every
seed flips must be refused.
"""

import copy

import pytest
import torch

from ips_tpu_torch.scripts import train_parity as tp

FLIP_AT = 4            # the ReLU at layer1_block1's output


@pytest.fixture(scope="module")
def step():
    conf = tp.config_from_dict(tp.SMALL_TRAIN)
    return tp.run_step(conf, tp.make_inputs(conf, 3), "cpu")


def flipped(step, gap):
    """Two copies of ``step`` with one input of ReLU ``FLIP_AT`` set to
    +gap/2 in the first and -gap/2 in the second (gap in units of that
    input's RMS), and in the second the gradients and params of every
    tensor used before it moved by 1%, as a flipped gate moves them."""
    one, other = copy.deepcopy(step), copy.deepcopy(step)
    pos, _, x = one["relus"][FLIP_AT]
    y = other["relus"][FLIP_AT][2]
    half = gap / 2 * y.pow(2).mean().sqrt()
    at = (0,) * x.dim()
    x[at], y[at] = half, -half
    for k, used in step["first_use"].items():
        if used < pos:
            other["grads"][k] *= 1.01
            other["params"][k] *= 1.01
    return one, other


def result(a, b, seed=4):
    return {"seed": seed, "launches": 4, "n_iter": 4,
            "vs_device_plain": tp.compare(a, a), "vs_cpu": tp.compare(a, b)}


def test_no_flip_holds_every_tensor(step):
    r = tp.compare(step, copy.deepcopy(step))
    assert r["gate_flips"] == {} and r["n_held"] == r["n_params"] == 47
    assert r["n_relu"] == 10 and r["grad_dist"] == r["pre_dist"] == 0.0
    tp.check([result(step, step)])


def test_rounding_flip_holds_tensors_after_it(step):
    one, other = flipped(step, 1e-6)
    r = tp.compare(one, other)
    name = step["relus"][FLIP_AT][1]
    assert name == "4:encoder.layer1_block1.bn2"
    assert r["gate_flips"][name]["n"] == 1
    assert r["gate_flips"][name]["gap"] == pytest.approx(1e-6, rel=1e-3)
    # the stem's conv and norm and layer1's two blocks (3 + 2 * 6 tensors)
    # are used before it
    assert r["n_held"] == 47 - 15 and r["grad_dist"] == 0.0
    tp.check([result(step, step, seed=3), result(one, other)])


@pytest.mark.parametrize("case,match", [
    ("wide_gap", "flipped with inputs"), ("grad_past_flip", "grad_dist"),
    ("every_seed_flips", "every seed")])
def test_check_refuses(step, case, match):
    one, other = flipped(step, 1e-3 if case == "wide_gap" else 1e-6)
    if case == "grad_past_flip":
        other["grads"]["encoder.layer2_block0.conv1.weight"] *= 1.01
    results = [result(one, other)]
    if case != "every_seed_flips":
        results.insert(0, result(step, step, seed=3))
    with pytest.raises(AssertionError, match=match):
        tp.check(results)


def test_traffic_config_step_on_cpu():
    """SMALL_TRAFFIC (ResNet-18 with all 4 blocks, RGB, one softmax task)
    takes a step with its inputs and passes the check against itself:
    every ReLU of the encoder's 4 stages and the MLP is recorded and every
    parameter is held."""
    conf = tp.config_from_dict(tp.SMALL_TRAFFIC)
    x, labels, w = tp.make_inputs(conf, 3, blank=0.0)
    assert x.shape == (4, 48, 20, 20, 3) and set(labels) == {"sign"}
    s = tp.run_step(conf, (x, labels, w), "cpu")
    r = tp.compare(s, copy.deepcopy(s))
    assert r["gate_flips"] == {} and r["n_held"] == r["n_params"]
    assert r["n_relu"] == 1 + 4 * 2 * 2 + 1 and r["loss"] > 0
    assert any(k.startswith("encoder.layer4") for k in s["first_use"])
    tp.check([{**result(s, s), "launches": 6, "n_iter": 6}],
             tp.FLIP_TOL_4_BLOCKS)
