"""The port's streaming selection (``eager: false``) against ips_tpu's.

``ips_select_streaming_step`` on a linear stub encoder, then
``StreamingSelector.select`` (through ``IPSTrainer.select_streaming``) on
the tiny conv model of test_torch_infer.py with weights bridged from JAX,
``shuffle=False`` (neither RNG stream crosses frameworks): N = 23, M = 4,
I = 3, so the 7 chunks after the first M make one group of G = 4 and a
remainder of 3 through the per-chunk stages, the last chunk ragged (one
patch and two padded slots). At G = 1 and G = 4, with and without a mask
and ``return_emb``, and on the M >= N shortcut: kept indices, masks and
patches equal to JAX's, positions and embeddings within EMB_TOL (fp32).
The port's streaming selection is also held to its own eager
``ips_select`` (with shuffle, from the same generator) and G = 4 to G = 1,
bitwise.

Last, one lazy train epoch and one eval pass through ``train_one_epoch`` /
``evaluate`` against the JAX loop, on test_torch_loop.py's generated
megapixel-MNIST set (fp32, dropout 0, dense batches of B_seq = 2, B = 4,
so the assembler takes two loader batches a step and the epoch's last
step one), with that file's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.ops import score_kernel as jsk
from ips_tpu.ops.selection import ips_select_streaming_step as j_step
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.ops import score_kernel as tsk
from ips_tpu_torch.ops.selection import ips_select_streaming_step as t_step
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_infer import TINY, _perturb_stats
from test_torch_loop import (assert_runs_match, assert_state_match,  # noqa: F401
                             data_dir, few_torch_threads, loop_conf,
                             run_epoch)

EMB_TOL = dict(rtol=1e-5, atol=1e-5)
LAZY = dict(TINY, shuffle=False, eager=False, N=23, M=4, I=3)


@pytest.mark.parametrize("use_pos", [False, True], ids=["no_pos", "pos"])
def test_streaming_step_matches_jax(use_pos):
    rng = np.random.default_rng(7)
    B, M, I, F, D, N = 2, 4, 3, 6, 8, 20
    proj = rng.standard_normal((F, D), np.float32)
    w = 0.3 * rng.standard_normal((D, 4), np.float32)
    pos = 0.1 * rng.standard_normal((N, D), np.float32) if use_pos else None
    mem_emb = rng.standard_normal((B, M, D), np.float32)
    mem_idx = np.stack([rng.permutation(N)[:M] for _ in range(B)])
    mem_valid = np.ones((B, M), bool)
    chunk = rng.standard_normal((B, I, F), np.float32)
    chunk_idx = np.stack([rng.permutation(N)[:I] for _ in range(B)])
    chunk_valid = np.array([[True, True, False], [True, False, False]])
    jp, jw = jnp.asarray(proj), jnp.asarray(w)
    want = j_step(lambda x: x @ jp, lambda e, m: jsk.fast_scores(e, jw, m),
                  jnp.asarray(mem_emb), jnp.asarray(mem_idx),
                  jnp.asarray(mem_valid), jnp.asarray(chunk),
                  jnp.asarray(chunk_idx), jnp.asarray(chunk_valid), M,
                  None if pos is None else jnp.asarray(pos))
    tp, tw = torch.from_numpy(proj), torch.from_numpy(w)
    got = t_step(lambda x: x @ tp, lambda e, m: tsk.scores(e, tw, m),
                 *map(torch.from_numpy, (mem_emb, mem_idx, mem_valid, chunk,
                                         chunk_idx, chunk_valid)), M,
                 None if pos is None else torch.from_numpy(pos))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **EMB_TOL)


@pytest.fixture(scope="module")
def lazy_pairs():
    """G -> (JAX trainer, port trainer), the same weights and perturbed
    running statistics."""
    base = JTrainer(j_config(LAZY), rng=jax.random.PRNGKey(0),
                    init_opt=False)
    stats = _perturb_stats(base.state.batch_stats, np.random.default_rng(1))
    state = base.state.replace(
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    pairs = {}
    for G in (1, 4):
        c = dict(LAZY, stream_chunk_group=G)
        jtr = JTrainer(j_config(c), rng=jax.random.PRNGKey(0),
                       init_opt=False)
        jtr.state = state
        port = IPSTrainer(t_config(c), device="cpu", init_opt=False)
        weights.load_jax(port.model, state.params, state.batch_stats)
        pairs[G] = jtr, port
    return pairs


def _inputs(seed, N=23, B=2):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, 16, 16, 1), np.float32)
    x[:, rng.random(N) < 0.4] = 0.0
    mask = np.ones((B, N), bool)
    mask[1, N - 6:] = False
    return x, mask


def _assert_streams_match(got, want, return_emb):
    assert len(got) == len(want) == (5 if return_emb else 4)
    if return_emb:
        assert got[0] is None and want[0] is None
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   **EMB_TOL)
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **EMB_TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("return_emb", [False, True],
                         ids=["patches", "emb"])
def test_select_streaming_matches_jax(lazy_pairs, G, masked, return_emb):
    jtr, port = lazy_pairs[G]
    x, mask = _inputs(3)
    m = mask if masked else None
    want = jtr.select_streaming(x, m, jax.random.PRNGKey(0),
                                return_emb=return_emb)
    got = port.select_streaming(x, m, None, return_emb=return_emb)
    _assert_streams_match(got, want, return_emb)
    if masked:                  # padded patches are never kept
        assert not np.isin(got[2][1].numpy(), np.arange(17, 23)).any()


@pytest.mark.parametrize("return_emb", [False, True],
                         ids=["patches", "emb"])
def test_shortcut_matches_jax(lazy_pairs, return_emb):
    """N = 3 <= M: every patch, unshuffled, no selection step."""
    jtr, port = lazy_pairs[4]
    x, _ = _inputs(5, N=3)
    want = jtr.select_streaming(x, None, jax.random.PRNGKey(0),
                                return_emb=return_emb)
    got = port.select_streaming(x, None, None, return_emb=return_emb)
    _assert_streams_match(got, want, return_emb)
    np.testing.assert_array_equal(got[2].numpy(), [[0, 1, 2]] * 2)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_streaming_equals_eager_and_groups(lazy_pairs, masked):
    """With shuffle on: streaming at G = 4 and G = 1 and the eager
    ``ips_select`` from generators of one seed keep the same patches, and
    the two streamed runs are bitwise equal, embeddings included."""
    x, mask = _inputs(6)
    m = mask if masked else None
    runs = {}
    for G in (1, 4):
        port = IPSTrainer(t_config(dict(LAZY, shuffle=True,
                                        stream_chunk_group=G)),
                          device="cpu", init_opt=False)
        port.model.load_state_dict(lazy_pairs[G][1].model.state_dict())
        runs[G] = port.select_streaming(x, m, port.new_generator(11),
                                        return_emb=True)
        kept = port.select_streaming(x, m, port.new_generator(11))
        eager = port.select(torch.from_numpy(x),
                            None if m is None else torch.from_numpy(m),
                            port.new_generator(11))
        for a, b in zip(kept, eager):
            assert torch.equal(a, b)
    for a, b in zip(runs[1][1:], runs[4][1:]):
        assert a is b is None or torch.equal(a, b)


def test_lazy_epoch_matches_jax(data_dir):
    c = loop_conf(data_dir, sparse_input=False, eager=False, B=4, B_seq=2,
                  stream_chunk_group=2)
    jtr = JTrainer(j_config(c), rng=jax.random.PRNGKey(0))
    initial = jtr.state
    jax_out = run_epoch("jax", jtr, j_config(c))
    port = IPSTrainer(t_config(c), device="cpu")
    weights.load_jax_train_state(port, initial)
    calls = []
    for name in ("select_streaming", "select", "train_step",
                 "eval_from_emb_step", "eval_step"):
        def spy(*a, _name=name, _fn=getattr(port, name), **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        setattr(port, name, spy)
    port_out = run_epoch("torch", port, t_config(c))
    # 5 loader batches of 2 -> steps after the 2nd, 4th and 5th; eval: 2
    # batches, one step on the buffers' embeddings
    assert calls == (["select_streaming"] * 2 + ["train_step"]) * 2 + [
        "select_streaming", "train_step"] + ["select_streaming"] * 2 + [
        "eval_from_emb_step"]
    assert_runs_match(port_out, jax_out, 3)
    assert port.step == int(jtr.state.step) == 3
    assert_state_match(port, jtr.state, initial)
