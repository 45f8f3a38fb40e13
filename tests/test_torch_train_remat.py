"""The training step's memory options and its bf16 numerics against
ips_tpu, at the tiny fp32 config of test_torch_train.py, with the same
bounds (stated there).

``remat_encode`` recomputes the train-mode encode in the backward; the
recompute must not update the running statistics a second time, so the
statistics after each step are held against the reference's, whose
``jax.checkpoint`` is pure. ``grad_encode_chunk=3`` at M=4 encodes one
chunk of 3 and a tail of 1, each with its own batch statistics.
"""

import numpy as np
import pytest

from ips_tpu_torch import weights

from test_torch_train import (LR, assert_grads_close,  # noqa: F401
                              assert_outputs_close, assert_state_close,
                              few_torch_threads, jax_trainer, port_grads,
                              port_trainer, rel_dist, run_jax, step_batches,
                              to_torch)

# bf16 against bf16: both round each conv, projection and their
# gradients to bf16, in another order of accumulation
BF16_LOSS_RTOL = 2.0 ** -7
BF16_GRAD_DIST = 5e-2


@pytest.mark.parametrize("over", [{"remat_encode": True},
                                  {"grad_encode_chunk": 3}],
                         ids=["remat", "chunk3"])
def test_memory_options_match_jax(over):
    """2 fused steps (weights [1, 0] in the second): losses, step-1
    gradients, the state after each step. Measured over 3 steps: remat as
    the plain step (losses 6.5e-7, gradients 2.7e-6, params 9.1e-5
    relative); chunk3 losses 8.7e-7, gradients 3.0e-6, params 6.0e-5."""
    steps = step_batches()[:2]
    tr = jax_trainer(**over)
    outs, states = run_jax(tr, steps)
    port = port_trainer(states[0], **over)
    for k, step in enumerate(steps):
        got = port.fused_step(*to_torch(*step), None, LR)
        assert_outputs_close(got, outs[k])
        if k == 0:
            assert_grads_close(port, states[1].opt_state)
        assert_state_close(port, states[k + 1], k + 1)


def test_bf16_fused_step_matches_jax():
    """compute_dtype = input_dtype = bfloat16, one fused step from the
    same state; both select the same patches.

    The loss within 2^-7 relative (measured 4.8e-4); the gradients of the
    transformer and heads within 5e-2 relative Frobenius distance
    (measured <= 1.4e-2). The encoder's gradients cannot meet 5e-2 in any
    bf16 implementation at this size: JAX's own lie 0.025-0.24 from the
    fp32 gradients of the same step (bf16 cotangents into the train-mode
    BatchNorm backward, whose mean subtraction cancels most of each sum),
    and the port's lie 0.012-0.27 from JAX's. So each encoder gradient's
    distance from the fp32 one is held to between 0.6x and 1.9x of JAX's
    (measured 0.73x-1.74x): a bf16 port has JAX's error, where an encoder
    left in fp32 sits far closer to the fp32 gradient (0.15x for the
    stem's BatchNorm bias). This bound only tells a bf16 encoder from one
    left in fp32; a wrong gradient (a misplaced cast, a lost term) is held
    by the fp32 tests, which bound every gradient to 1e-4 of JAX's
    (test_torch_train.py and test_memory_options_match_jax above).
    """
    over = {"compute_dtype": "bfloat16", "input_dtype": "bfloat16"}
    tr = jax_trainer(**over)
    step = step_batches()[0]
    jmem = tr.select(step[0], step[1])
    outs, states = run_jax(tr, [step])
    port = port_trainer(states[0], **over)
    x, m, lab, w = to_torch(*step)
    mem = port.select(x, m)
    np.testing.assert_array_equal(mem[2].numpy(), np.asarray(jmem[2]))
    loss = port.fused_step(x, m, lab, w, None, LR)[0]
    np.testing.assert_allclose(loss.numpy(), np.asarray(outs[0][0]),
                               rtol=BF16_LOSS_RTOL)
    got = port_grads(port.model)

    fp32 = port_trainer(states[0])          # the same step in fp32
    fp32.train_step(mem[0].float(), mem[1], mem[3], lab, w, None, LR)
    exact = port_grads(fp32.model)
    want = weights.flatten_variables(states[1].opt_state.inner_state[0].mu)
    for k, v in want.items():
        v = np.asarray(v, np.float64) / 0.1         # mu = (1 - b1) g
        if k.startswith("params/encoder/"):
            ratio = rel_dist(got[k], exact[k]) / rel_dist(v, exact[k])
            assert 0.6 < ratio < 1.9, f"{k}: error ratio {ratio:.3f}"
        else:
            d = rel_dist(got[k], v)
            assert d < BF16_GRAD_DIST, f"{k}: relative distance {d:.3e}"
