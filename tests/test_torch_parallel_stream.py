"""Streaming selection (``eager: false``) under a mesh over gloo ranks on
the CPU, against JAX's single-device ``StreamingSelector.select`` and
the port's single process.

2x1, 1x2 and 2x2 worlds (``run_world``, each with its deadline) at
B = 4, N = 22 patches of 16x16, M = I = 4, G = 2 (the 5 chunks after
the first M make two groups and one chunk alone, the last one ragged),
``use_pos``, masked patches in two rows, fp32, from the JAX trainer's
weights (``weights.py``), shuffle off and dropout 0 where JAX is the
reference. Stated bounds:

  * kept indices, masks and patches: bitwise equal to JAX's and to one
    process of the port, in every rank's rows;
  * positions and the buffer's embeddings (``return_emb``): within 1e-5
    of JAX's and of one process's (the encoder sums the same products in
    another order when a rank encodes half a chunk);
  * the M >= N shortcut (N = 4, ``return_emb``): indices equal, the
    embeddings within 1e-5;
  * with shuffle on ('batch' and 'instance'): indices bitwise equal to
    one process of the port from a generator of the same seed;
  * under a patch group of 2 every stage holds I / 2 = 2 patches of each
    chunk (M / 2 of the first M, N / 2 of the shortcut); the gather of
    the M kept patches stays whole.
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
from ips_tpu_torch.parallel.launch import run_world
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_parallel import TINY

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
EMB_TOL = dict(rtol=1e-5, atol=1e-5)
STREAM = dict(TINY, eager=False, N=22, M=4, I=4, stream_chunk_group=2)
MESHES = [(2, 1), (1, 2), (2, 2)]
B, N, N_SHORT = 4, 22, 4


def make_batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, 16, 16, 1), np.float32)
    x[:, rng.random(N) < 0.3] = 0.0
    mask = np.ones((B, N), bool)
    mask[1, N - 6:] = False
    mask[3, N - 3:] = False
    short = rng.random((B, N_SHORT, 16, 16, 1), np.float32)
    return dict(patches=x, mask=mask, short=short)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's streamed selections, one process of the port's, and every
    world's rank outputs."""
    d = tmp_path_factory.mktemp("parallel_stream")
    b = make_batch()
    np.savez(d / "batch.npz", **b)
    jtr = JTrainer(j_config(STREAM), rng=jax.random.PRNGKey(0),
                   init_opt=False)
    np.savez(d / "weights.npz", **weights.flatten_variables(
        jtr.state.params, jtr.state.batch_stats))
    with open(d / "conf.json", "w") as f:
        json.dump({"conf": STREAM}, f)
    key = jax.random.PRNGKey(0)
    ref = {"jax": jtr.select_streaming(b["patches"], b["mask"], key),
           "jax/emb": jtr.select_streaming(b["patches"], b["mask"], key,
                                           return_emb=True),
           "jax/short": jtr.select_streaming(b["short"], None, key,
                                             return_emb=True)}
    ref = {k: [None if v is None else np.asarray(v) for v in vs]
           for k, vs in ref.items()}

    def port(**over):
        tr = IPSTrainer(t_config(dict(STREAM, **over)), device="cpu",
                        init_opt=False)
        weights.load_flat(tr.model, str(d / "weights.npz"))
        return tr

    tr = port()
    ref["port"] = [v.numpy() for v in tr.select_streaming(
        b["patches"], b["mask"], tr.new_generator(0))]
    ref["port/emb"] = [None if v is None else v.numpy() for v in
                       tr.select_streaming(b["patches"], b["mask"],
                                           tr.new_generator(0),
                                           return_emb=True)]
    ref["port/short"] = [None if v is None else v.numpy() for v in
                         tr.select_streaming(b["short"], None,
                                             tr.new_generator(0),
                                             return_emb=True)]
    for style in ("batch", "instance"):
        tr = port(shuffle=True, shuffle_style=style)
        ref[f"shuffle/{style}"] = tr.select_streaming(
            b["patches"], b["mask"], tr.new_generator(7))[2].numpy()

    ranks = {}
    for data, patch in MESHES:
        run_world("torch_parallel_worker:stream", data * patch,
                  [str(d), str(data), str(patch)], timeout=WORLD_TIMEOUT,
                  python_path=[TESTS])
        ranks[data, patch] = [
            dict(np.load(d / f"rank{f'stream{data}x{patch}'}_{r}.npz"))
            for r in range(data * patch)]
    return ref, ranks


def _rows(data, patch, r):
    k = B // data
    d = r // patch
    return slice(d * k, (d + 1) * k)


def _each_rank(case, mesh):
    ref, ranks = case
    for r, out in enumerate(ranks[mesh]):
        yield ref, out, _rows(*mesh, r)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_kept_sets_match_jax_and_one_process(case, mesh):
    for ref, out, rows in _each_rank(case, mesh):
        for src in ("jax", "port"):
            want = ref[src]
            np.testing.assert_array_equal(out["idx"], want[2][rows])
            np.testing.assert_array_equal(out["mask"], want[3][rows])
            np.testing.assert_array_equal(out["patch"], want[0][rows])
            np.testing.assert_allclose(out["pos"], want[1][rows],
                                       **EMB_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_return_emb_and_shortcut_match(case, mesh):
    for ref, out, rows in _each_rank(case, mesh):
        for src in ("jax", "port"):
            emb, short = ref[f"{src}/emb"], ref[f"{src}/short"]
            np.testing.assert_array_equal(out["emb/idx"], emb[2][rows])
            np.testing.assert_allclose(out["emb"], emb[4][rows], **EMB_TOL)
            np.testing.assert_array_equal(out["short/idx"],
                                          short[2][rows])
            np.testing.assert_allclose(out["short/emb"], short[4][rows],
                                       **EMB_TOL)


@pytest.mark.parametrize("style", ["batch", "instance"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shuffled_selection_matches_one_process(case, mesh, style):
    for ref, out, rows in _each_rank(case, mesh):
        np.testing.assert_array_equal(out[f"shuffle/{style}"],
                                      ref[f"shuffle/{style}"][rows])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_patch_ranks_stage_their_slice(case, mesh):
    """Stages (S, rows, n): the first M, two groups of G = 2 chunks, the
    chunk alone, then the kept patches, whole."""
    data, patch = mesh
    part = STREAM["I"] // patch
    for _, out, rows in _each_rank(case, mesh):
        n_rows = rows.stop - rows.start
        assert out["staged"].tolist() == [
            [1, n_rows, part], [2, n_rows, part], [2, n_rows, part],
            [1, n_rows, part], [1, n_rows, STREAM["M"]]]
        assert out["short/staged"].tolist() == [[1, n_rows,
                                                 N_SHORT // patch]]
