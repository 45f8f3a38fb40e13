"""The port's dense and assembled (B_seq < B) schedules against ips_tpu's,
with the setup and bounds of test_torch_loop.py (whose docstring gives
the measured values).

With B_seq = 2 < B = 4 the 10 train images make 5 loader batches: K = 1
runs the select-assemble-train schedule (3 optimizer steps, the last over
one loader batch), K = 2 one group of two ``fused_assembled`` steps and
the last optimizer batch through the select-assemble schedule; the 4 test
images make one assembled eval batch.

The first optimizer step alone (4 train images) is held closer, per
tensor, on the three kinds of step: sparse, dense and assembled.
"""

import pytest

from ips_tpu.data.mnist import generate_megapixel_mnist
from test_torch_loop import (assert_first_step,  # noqa: F401
                             assert_runs_match, assert_state_match, data_dir,
                             few_torch_threads, jax_trainer, run_both)


@pytest.mark.parametrize("over", [
    dict(sparse_input=False, steps_per_dispatch=1),
    dict(sparse_input=False, steps_per_dispatch=2),
    dict(sparse_input=False, B_seq=2, steps_per_dispatch=1),
    dict(sparse_input=False, B_seq=2, steps_per_dispatch=2),
], ids=["dense_k1", "dense_k2", "assembled_k1", "assembled_k2"])
def test_epoch_matches_jax(data_dir, jax_trainer, over):
    port, port_out, state, jax_out = run_both(data_dir, jax_trainer, **over)
    assert_runs_match(port_out, jax_out, 3)
    assert port.step == int(state.step) == 3
    assert_state_match(port, state, jax_trainer[1])


@pytest.fixture(scope="module")
def one_step_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist_one_step"))
    generate_megapixel_mnist(d, n_train=4, n_test=4, width=200, height=200,
                             n_noise=4, digit_source="sklearn")
    return d


@pytest.mark.parametrize("over", [
    dict(sparse_input=True, steps_per_dispatch=1),
    dict(sparse_input=False, steps_per_dispatch=1),
    dict(sparse_input=False, B_seq=2, steps_per_dispatch=1),
], ids=["sparse", "dense", "assembled"])
def test_first_step_matches_jax(one_step_dir, jax_trainer, over):
    """Each parameter's update after one optimizer step within
    STEP1_UPDATE_DIST of JAX's (``assert_first_step``; the elements left
    out are under 1% of each tensor, measured 0.05%)."""
    port, port_out, state, jax_out = run_both(one_step_dir, jax_trainer,
                                              **over)
    assert_runs_match(port_out, jax_out, 1)
    assert port.step == int(state.step) == 1
    assert_first_step(port, state, jax_trainer[1])
