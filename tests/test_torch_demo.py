"""The README's demo in the port (ips_tpu_torch/examples/) against the JAX
package's (examples/minimal_ips.py, examples/ips_example.ipynb), on the
CPU: the task's data, the config, the first selection from the same
weights, the deterministic variant's losses over the demo's 60 batches,
the script's and the notebook's lines, and the card as the default."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax

from ips_tpu_torch import weights
from ips_tpu_torch.examples import minimal_ips as demo
from torch_demo_jax import (NOTEBOOK, config_literal, jax_demo_config,
                            train_jax)
import examples.minimal_ips as jax_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NOTEBOOK = os.path.join(REPO, "ips_tpu_torch", "examples",
                             "ips_example.ipynb")
# shuffle off and both dropouts 0: the steps draw nothing, so the two
# packages take the same steps from the same weights on the same batches
DET = dict(shuffle=False, dropout=0.0, attn_dropout=0.0)
# Relative loss gap, port against JAX, at steps 0-2 (measured 0, 5.9e-7,
# 1.8e-6): fp32 convolutions summed in another order, and AdamW's first
# moves, about lr * sign(g), on gradients within rounding of 0.
EARLY_RTOL = 1e-5
# The last 10 steps' mean loss: each package's below LEARNED, and the two
# within LATE_RTOL of each other. Later steps carry those first moves and
# the near-tie selections among noise patches they lead to, and the
# port's sums move with torch's thread count: measured JAX 0.31440
# against the port's 0.31157, 0.31035 and 0.31855 at 1, 2 and 6 threads
# (0.9%, 1.3%, 1.3%; steps 0-2 the same at each). Every test of this file
# runs at THREADS.
LEARNED = 0.5
LATE_RTOL = 0.05
THREADS = 2
LINE = {"devices": re.compile(r"^devices: \[.+\]$"),
        "step": re.compile(r"^step +\d+  loss \d+\.\d{4}  batch acc "
                           r"\d\.\d{2}$"),
        "kept": re.compile(r"^selected patch indices for sample 0: "
                           r"\[[ \d]+\]$")}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(prev)


def _cells(path):
    with open(path) as f:
        return [("".join(c["source"]), c["cell_type"])
                for c in json.load(f)["cells"]]


def _notebook_make_task(path):
    ns = {"np": np}
    src = next(s for s, kind in _cells(path)
               if kind == "code" and s.startswith("def make_task"))
    exec(src, ns)
    return ns["make_task"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("copy", ["port", "port_notebook", "jax_notebook"])
def test_make_task_bitwise(copy, seed):
    fn = {"port": demo.make_task,
          "port_notebook": _notebook_make_task(PORT_NOTEBOOK),
          "jax_notebook": _notebook_make_task(NOTEBOOK)}[copy]
    X, y = fn(np.random.default_rng(seed), 64, 4, 25, 32)
    Xj, yj = jax_demo.make_task(np.random.default_rng(seed), 64, 4, 25, 32)
    assert X.dtype == Xj.dtype and y.dtype == yj.dtype
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_config_equals_jax_scripts():
    from ips_tpu.config import config_from_dict as jax_config_from_dict
    ref = jax_demo_config()
    assert demo.DEMO_CONFIG == ref
    assert (demo.demo_config().to_dict()
            == jax_config_from_dict(ref).to_dict())
    # the notebook's literal too
    src = next(s for s, kind in _cells(PORT_NOTEBOOK)
               if "config_from_dict(dict(" in s)
    assert config_literal(src) == ref


@pytest.mark.parametrize("shuffle", [True, False])
def test_select_before_any_step_equals_jax(shuffle):
    from ips_tpu.config import config_from_dict
    from ips_tpu.train.steps import IPSTrainer
    import jax.numpy as jnp
    conf = dict(jax_demo_config(), shuffle=shuffle)
    jt = IPSTrainer(config_from_dict(conf))
    X, _ = demo.make_task(np.random.default_rng(0), 64, 4, 25, 32)
    want = np.asarray(jt.select(jnp.asarray(X[:3]),
                                rng=jax.random.PRNGKey(0))[2])
    tr = demo.IPSTrainer(demo.demo_config(shuffle=shuffle), device="cpu")
    weights.load_jax(tr.model, jt.state.params, jt.state.batch_stats)
    got = tr.select(torch.from_numpy(X[:3]),
                    generator=tr.new_generator(0))[2].numpy()
    np.testing.assert_array_equal(got, want)


def test_deterministic_variant_against_jax():
    """Shuffle off, dropouts 0, the port from JAX's initial weights, over
    the demo's 60 batches and learning rates."""
    init = {}

    def grab(tr):
        init["p"] = jax.tree_util.tree_map(np.asarray, tr.state.params)
        init["s"] = jax.tree_util.tree_map(np.asarray, tr.state.batch_stats)

    want = train_jax(60, 0, DET, on_init=grab)["losses"]
    got = demo.run(60, 0, "cpu", overrides=DET, out=lambda s: None,
                   init=lambda tr: weights.load_jax(
                       tr.model, init["p"], init["s"]))["losses"]
    np.testing.assert_allclose(got[:3], want[:3], rtol=EARLY_RTOL)
    late = np.mean(got[-10:]), np.mean(want[-10:])
    assert max(late) < LEARNED, late
    assert abs(late[0] - late[1]) <= LATE_RTOL * late[1], late


def _check_lines(lines, steps):
    assert LINE["devices"].match(lines[0]), lines[0]
    shown = [s for s in range(steps) if s % 10 == 0 or s == steps - 1]
    assert len(lines) == 2 + len(shown), lines
    for s, line in zip(shown, lines[1:-1]):
        assert LINE["step"].match(line) and line.startswith(
            f"step {s:3d}"), line
    assert LINE["kept"].match(lines[-1]), lines[-1]


def test_main_on_the_cpu(capsys):
    res = demo.main(["--cpu", "--steps", "3"])
    _check_lines(capsys.readouterr().out.splitlines(), 3)
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 3
    assert sorted(set(res["kept"].tolist())) == sorted(res["kept"].tolist())
    assert len(res["kept"]) == 5 and 0 <= res["kept"].min() < 25


def test_notebook_executes_on_the_cpu(capsys):
    cells = _cells(PORT_NOTEBOOK)
    code = [s for s, kind in cells if kind == "code"]
    subs = {'DEVICE = "cuda"': 'DEVICE = "cpu"', "STEPS = 60": "STEPS = 3"}
    for old in subs:
        assert sum(old in s for s in code) == 1, f"no line {old!r}"
    ns = {}
    for src in code:
        for old, new in subs.items():
            src = src.replace(old, new)
        exec(compile(src, PORT_NOTEBOOK, "exec"), ns)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "devices: [device(type='cpu')]"
    _check_lines(out, 3)
    assert np.isfinite(ns["losses"]).all() and len(ns["losses"]) == 3
    # the same program as the script at its seed
    ref = demo.run(3, 0, "cpu", out=lambda s: None)
    assert ns["losses"] == ref["losses"]


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main([])
