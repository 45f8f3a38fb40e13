"""The port's selection engine against the JAX package's.

Both sides get the same numpy inputs and the same linear "encoder" and
query-folded scorer, so the kept indices must be equal, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.ops import score_kernel as jsk
from ips_tpu.ops.selection import ips_select as j_select
from ips_tpu.ops.selection import select_top_m as j_top_m
from ips_tpu_torch.ops import score_kernel as tsk
from ips_tpu_torch.ops.selection import ips_select as t_select
from ips_tpu_torch.ops.selection import select_top_m as t_top_m
from ips_tpu_torch.ops.shuffle import make_permutation

F, D, TH = 6, 8, 4


def _problem(B, N, seed, ties=False):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((B, N, F), np.float32)
    if ties:                   # duplicated patches score exactly alike
        patches[:, N // 2:] = patches[:, :1]
    proj = rng.standard_normal((F, D), np.float32)
    w_eff = 0.3 * rng.standard_normal((D, TH), np.float32)
    pos = 0.1 * rng.standard_normal((N, D), np.float32)
    return patches, proj, w_eff, pos


def _run_both(patches, proj, w_eff, pos, mask, M, I, return_emb=False):
    jp = jnp.asarray(proj)
    jw = jnp.asarray(w_eff)
    j = j_select(lambda x: x @ jp, lambda e, m: jsk.fast_scores(e, jw, m),
                 jnp.asarray(patches), M=M, I=I,
                 pos_table=None if pos is None else jnp.asarray(pos),
                 mask=None if mask is None else jnp.asarray(mask),
                 return_emb=return_emb)
    tp = torch.from_numpy(proj)
    tw = torch.from_numpy(w_eff)
    t = t_select(lambda x: x @ tp, lambda e, m: tsk.scores(e, tw, m),
                 torch.from_numpy(patches), M=M, I=I,
                 pos_table=None if pos is None else torch.from_numpy(pos),
                 mask=None if mask is None else torch.from_numpy(mask),
                 return_emb=return_emb)
    return j, t


@pytest.mark.parametrize("N,M,I", [(23, 5, 4), (40, 8, 8), (17, 6, 5)])
@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_ips_select_matches_jax(N, M, I, use_mask, ties):
    B = 3
    patches, proj, w_eff, pos = _problem(B, N, N * 7 + M, ties)
    mask = None
    if use_mask:
        mask = np.ones((B, N), bool)
        mask[1, -5:] = False
        mask[2, ::3] = False
    # with ties, no positional table: duplicated patches then score alike
    j, t = _run_both(patches, proj, w_eff, None if ties else pos, mask, M, I,
                     return_emb=True)
    np.testing.assert_array_equal(t.mem_idx.numpy(), np.asarray(j.mem_idx))
    np.testing.assert_array_equal(t.mem_mask.numpy(),
                                  np.asarray(j.mem_mask))
    np.testing.assert_allclose(t.mem_emb.numpy(), np.asarray(j.mem_emb),
                               rtol=1e-5, atol=1e-6)
    if not ties:
        np.testing.assert_allclose(t.mem_pos.numpy(), np.asarray(j.mem_pos))
    np.testing.assert_array_equal(t.mem_patch.numpy(),
                                  np.asarray(j.mem_patch))


def test_shortcut_when_m_covers_n():
    B, N = 2, 6
    patches, proj, w_eff, pos = _problem(B, N, 3)
    j, t = _run_both(patches, proj, w_eff, pos, None, M=8, I=4,
                     return_emb=True)
    np.testing.assert_array_equal(t.mem_idx.numpy(), np.asarray(j.mem_idx))
    np.testing.assert_array_equal(t.mem_patch.numpy(), patches)
    assert t.mem_mask.all()
    np.testing.assert_allclose(t.mem_emb.numpy(), np.asarray(j.mem_emb),
                               rtol=1e-6)
    np.testing.assert_allclose(t.mem_pos.numpy(), np.asarray(j.mem_pos))


def _const_score(e, m):
    return torch.full(e.shape[:2], 0.25)


def test_select_top_m_ties_go_to_lower_position():
    """Constant embeddings give exactly equal scores: lax.top_k keeps the
    lowest positions, in order, and so must the port."""
    B, L, M = 2, 12, 5
    emb = torch.ones((B, L, D))
    idx = torch.arange(100, 100 + L).expand(B, L).contiguous()
    valid = torch.ones((B, L), dtype=torch.bool)
    valid[1, 1] = False
    _, mem_idx, mem_valid = t_top_m(emb, emb, idx, valid, M, _const_score)
    np.testing.assert_array_equal(mem_idx[0].numpy(), np.arange(100, 105))
    np.testing.assert_array_equal(mem_idx[1].numpy(),
                                  [100, 102, 103, 104, 105])
    assert mem_valid.all()

    jw = jnp.zeros((D, TH))
    _, j_idx, j_valid = j_top_m(
        jnp.asarray(emb.numpy()), jnp.asarray(emb.numpy()),
        jnp.asarray(idx.numpy()), jnp.asarray(valid.numpy()), M,
        lambda e, m: jsk.fast_scores(e, jw, m))
    np.testing.assert_array_equal(mem_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(mem_valid.numpy(), np.asarray(j_valid))


def test_select_top_m_invalid_kept_last():
    B, L, M = 1, 6, 4
    emb = torch.ones((B, L, D))
    idx = torch.arange(L)[None]
    valid = torch.tensor([[False, True, False, True, False, False]])
    _, mem_idx, mem_valid = t_top_m(emb, emb, idx, valid, M, _const_score)
    np.testing.assert_array_equal(mem_idx[0].numpy(), [1, 3, 0, 2])
    np.testing.assert_array_equal(mem_valid[0].numpy(),
                                  [True, True, False, False])


def test_permutation_without_shuffle_is_stable_valid_first():
    mask = torch.tensor([[True, False, True, True, False],
                         [False, False, True, True, True]])
    perm = make_permutation(None, 2, 5, mask, shuffle=False)
    np.testing.assert_array_equal(perm.numpy(),
                                  [[0, 2, 3, 1, 4], [2, 3, 4, 0, 1]])
    ident = make_permutation(None, 2, 5, None, shuffle=False)
    np.testing.assert_array_equal(ident.numpy(), [list(range(5))] * 2)


@pytest.mark.parametrize("style", ["batch", "instance"])
def test_shuffled_permutation_properties(style):
    """torch.Generator cannot reproduce jax.random's stream: check what the
    permutation must satisfy instead."""
    B, N = 4, 30
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[2, 20:] = False
    g = torch.Generator().manual_seed(0)
    perm = make_permutation(g, B, N, mask, shuffle=True, shuffle_style=style)
    for b in range(B):
        assert sorted(perm[b].tolist()) == list(range(N))
        n_valid = int(mask[b].sum())
        assert mask[b, perm[b, :n_valid]].all()
    if style == "batch":
        assert (perm[0] == perm[1]).all()
    else:
        assert not (perm[0] == perm[1]).all()
    again = make_permutation(torch.Generator().manual_seed(0), B, N, mask,
                             shuffle=True, shuffle_style=style)
    assert torch.equal(perm, again)
    with pytest.raises(ValueError, match="Generator"):
        make_permutation(None, B, N, mask, shuffle=True)
