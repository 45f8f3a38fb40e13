"""ips_tpu_torch.parallel against ips_tpu.parallel on the CPU: the grid
and row helpers, ``ips_select_cp``, the sharded trainer's accept/reject
table, the data-rank-sharded loader, the gather, and weighted BatchNorm
over 2 gloo ranks. Stated bounds:

  * ``ips_select_cp`` against JAX's: indices bitwise equal, embeddings
    within 1e-5 (both sum the same fp32 products in another order);
  * BatchNorm over 2 ranks with zero-weight rows: output, input gradient
    and running statistics within 1e-6 of one process of the port and
    of the JAX module (the sums are split over the ranks: a few fp32
    roundings apart).

Every multi-process case runs in a world of its own with a deadline
(``run_world``): a hung collective fails the test instead of waiting.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data.loader import DataLoader as JLoader
from ips_tpu.models.norm import MaskedBatchNorm as JNorm
from ips_tpu.parallel.ips_sharded import ShardedIPSTrainer as JSharded
from ips_tpu.parallel.ips_sharded import ips_select_cp as j_select_cp
from ips_tpu.parallel.mesh import make_mesh as j_make_mesh
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.parallel import distributed as pdist
from ips_tpu_torch.parallel.ips_sharded import (ShardedIPSTrainer,
                                                ips_select_cp)
from ips_tpu_torch.parallel.launch import run_world
from ips_tpu_torch.parallel.mesh import (DATA_AXIS, PATCH_AXIS, Mesh,
                                         make_mesh, rand_rows, row_shard,
                                         shard_rows)

from torch_parallel_worker import bn_inputs

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120
EMB_ATOL = 1e-5
BN_TOL = 1e-6


# ------------------------------------------------------------ grid and rows
def test_make_mesh_single_process():
    mesh = make_mesh(1, 1, torch.device("cpu"))
    assert (mesh.n_dp, mesh.n_cp, mesh.coords) == (1, 1, (0, 0))
    assert mesh.data_group is None and mesh.patch_group is None
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, 1, torch.device("cpu"))


def _mesh(d, p, coords):
    return Mesh({DATA_AXIS: d, PATCH_AXIS: p}, coords, torch.device("cpu"))


def test_shard_rows_slices_or_replicates():
    x = np.arange(12).reshape(6, 2)
    got = shard_rows({"x": x, "t": (x[:, 0],)}, _mesh(3, 2, (1, 0)))
    assert got["x"].tolist() == x[2:4].tolist()
    assert got["t"][0].tolist() == [4, 6]
    # 6 rows do not divide over 4 data ranks: replicated, as shard_batch
    assert shard_rows(x, _mesh(4, 1, (3, 0))).tolist() == x.tolist()


def test_rand_rows_draws_the_global_batch():
    full = torch.rand((6, 5), generator=torch.Generator().manual_seed(3))
    with row_shard(6, 2):
        part = rand_rows((2, 5), torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(part, full[2:4])
    assert torch.equal(rand_rows((6, 5), torch.Generator().manual_seed(3),
                                 "cpu"), full)


def test_collectives_without_a_group_are_identities():
    x = torch.arange(6.0).reshape(2, 3)
    assert pdist.all_gather_rows(x) is x
    tree = {"a": np.ones(2)}
    assert pdist.host_allgather(tree) is tree
    g = [torch.ones(3)]
    pdist.all_reduce_sum(g, scale=0.5)
    assert g[0].tolist() == [0.5] * 3
    assert pdist.is_main_process() and pdist.world_size() == 1


@pytest.mark.parametrize("device,gloo,want", [
    ("cpu", "", "gloo"), ("cpu", "gloo", "gloo"), ("cuda", "gloo", "gloo"),
    ("cuda", "", "nccl")])
def test_backend_is_chosen_not_fallen_back(device, gloo, want):
    assert pdist.backend_for(torch.device(device), gloo) == want


def test_mpi_raises_without_mpi():
    if torch.distributed.is_mpi_available():
        pytest.skip("this torch has MPI")
    with pytest.raises(RuntimeError, match="MPI"):
        pdist.backend_for(torch.device("cpu"), "mpi")


# ----------------------------------------------------------- ips_select_cp
def _cp_inputs(B=2, N=16, P=12, D=8, seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(B, N, P)).astype(np.float32)
    w_enc = (rng.normal(size=(P, D)) / np.sqrt(P)).astype(np.float32)
    v = rng.normal(size=(D,)).astype(np.float32)
    pos = rng.normal(size=(N, D)).astype(np.float32) * 0.1
    mask = np.ones((B, N), bool)
    mask[1, N - 3:] = False
    return patches, w_enc, v, pos, mask


def _j_fns(w_enc, v):
    def enc(x):
        return jnp.einsum("bnp,pd->bnd", x, w_enc)

    def score(e, m):
        s = jnp.where(m, jnp.einsum("bld,d->bl", e, v), -1e9)
        return jax.nn.softmax(s, axis=-1)
    return enc, score


def _t_fns(w_enc, v):
    w_enc, v = torch.from_numpy(w_enc), torch.from_numpy(v)

    def enc(x):
        return torch.einsum("bnp,pd->bnd", x, w_enc)

    def score(e, m):
        s = torch.where(m, torch.einsum("bld,d->bl", e, v), -1e9)
        return torch.softmax(s, dim=-1)
    return enc, score


@pytest.mark.parametrize("n_shards", [2, 4])
def test_ips_select_cp_matches_jax(n_shards):
    """N = 8 n_shards: every shard holds more than M = 4 patches."""
    patches, w_enc, v, pos, mask = _cp_inputs(N=8 * n_shards)
    je, js = _j_fns(w_enc, v)
    jres = j_select_cp(je, js, jnp.asarray(patches), M=4, I=4,
                       n_shards=n_shards, pos_table=jnp.asarray(pos),
                       mask=jnp.asarray(mask), return_emb=True)
    te, ts = _t_fns(w_enc, v)
    tres = ips_select_cp(te, ts, torch.from_numpy(patches), M=4, I=4,
                         n_shards=n_shards, pos_table=torch.from_numpy(pos),
                         mask=torch.from_numpy(mask), return_emb=True)
    np.testing.assert_array_equal(tres.mem_idx.numpy(),
                                  np.asarray(jres.mem_idx))
    np.testing.assert_array_equal(tres.mem_mask.numpy(),
                                  np.asarray(jres.mem_mask))
    np.testing.assert_allclose(tres.mem_emb.numpy(),
                               np.asarray(jres.mem_emb), atol=EMB_ATOL)
    np.testing.assert_array_equal(tres.mem_patch.numpy(),
                                  np.asarray(jres.mem_patch))
    np.testing.assert_allclose(tres.mem_pos.numpy(),
                               np.asarray(jres.mem_pos))


@pytest.mark.parametrize("N,M,n_shards,match", [
    (15, 4, 2, "not divisible"), (16, 8, 2, "M < N/n_shards")])
def test_ips_select_cp_raises_as_jax(N, M, n_shards, match):
    patches, w_enc, v, _, _ = _cp_inputs(N=N)
    with pytest.raises(ValueError, match=match):
        j_select_cp(*_j_fns(w_enc, v), jnp.asarray(patches), M=M, I=4,
                    n_shards=n_shards)
    with pytest.raises(ValueError, match=match):
        ips_select_cp(*_t_fns(w_enc, v), torch.from_numpy(patches), M=M,
                      I=4, n_shards=n_shards)


def test_ips_select_cp_shuffle_draws_one_seed_per_shard():
    patches, w_enc, v, pos, mask = _cp_inputs()
    te, ts = _t_fns(w_enc, v)
    kw = dict(M=4, I=4, n_shards=2, pos_table=torch.from_numpy(pos),
              mask=torch.from_numpy(mask), shuffle=True,
              shuffle_style="instance")
    a = ips_select_cp(te, ts, torch.from_numpy(patches),
                      generator=torch.Generator().manual_seed(1), **kw)
    b = ips_select_cp(te, ts, torch.from_numpy(patches),
                      generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(a.mem_idx, b.mem_idx)
    with pytest.raises(ValueError, match="Generator"):
        ips_select_cp(te, ts, torch.from_numpy(patches), **kw)


# ------------------------------------------------- the trainer's validation
TINY = dict(
    n_epoch=1, B=4, B_seq=4, n_epoch_warmup=1, lr=1e-3, wd=0.1, n_class=10,
    is_image=True, enc_type="resnet18", n_chan_in=1, n_res_blocks=2,
    shuffle=False, n_token=2, N=16, M=8, I=4, patch_size=[16, 16],
    patch_stride=[16, 16], use_pos=True, H=4, D=128, D_k=16, D_v=16,
    D_inner=256, compute_dtype="float32", donate_buffers=False,
    dropout=0.0, attn_dropout=0.0,
    tasks={"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                     "metric": "accuracy"},
           "task1": {"id": 1, "name": "multi", "act_fn": "sigmoid",
                     "metric": "multilabel_accuracy"}})


@pytest.mark.parametrize("B,N,M,mesh,cp_select", [
    (4, 16, 8, (2, 1), "exact"),
    (6, 16, 8, (4, 1), "exact"),            # B % data
    (4, 15, 8, (1, 3), "exact"),            # N % patch
    (4, 16, 8, (1, 2), "exact"),            # exact CP: no M constraint
    (4, 16, 8, (1, 2), "local_merge"),      # M >= N / patch
    (4, 16, 4, (1, 2), "local_merge"),
    (4, 16, 8, (2, 4), "exact"),
    (8, 16, 2, (2, 4), "local_merge"),
])
def test_sharded_trainer_accepts_what_jax_accepts(B, N, M, mesh, cp_select):
    """Constructed only, from a hand-made grid (no process group): the
    checks come before any collective."""
    conf = dict(TINY, B=B, B_seq=B, N=N, M=M, cp_select=cp_select,
                mesh_data=mesh[0], mesh_patch=mesh[1])
    jerr = terr = None
    try:
        JSharded(j_config(conf), mesh=j_make_mesh(*mesh),
                 rng=jax.random.PRNGKey(0))
    except ValueError as e:
        jerr = e
    try:
        tr = ShardedIPSTrainer(t_config(conf), mesh=_mesh(*mesh, (0, 0)),
                               device="cpu")
        assert (tr.n_dp, tr.n_cp) == mesh
    except ValueError as e:
        terr = e
    assert (jerr is None) == (terr is None), (jerr, terr)


@pytest.mark.parametrize("over", [
    dict(mesh_patch=2, eager=False), dict(mesh_data=2, B_seq=2)],
    ids=["streaming_1x2", "slots_2x1"])
def test_sharded_trainer_deferred_parts_raise(over):
    """The parts that raised while ROADMAP item 6 was open, streaming
    under a patch group and B_seq < B over data ranks, build from a
    hand-made grid: the streamed chunks split over the patch ranks, and
    'auto' resolves on the global slot table."""
    conf = t_config(dict(TINY, **over))
    tr = ShardedIPSTrainer(conf, mesh=_mesh(conf.mesh_data, conf.mesh_patch,
                                            (0, conf.mesh_patch - 1)),
                           device="cpu")
    split = tr._stream_patch_split()
    assert (split is not None) == (conf.mesh_patch > 1)
    if split is not None:
        assert (split.rank, split.size) == (1, 2)
    assert tr._slot_table_rows(conf.B // conf.mesh_data) == conf.B


@pytest.mark.parametrize("B,B_seq,data,ok", [
    (4, 1, 2, True), (4, 2, 2, True), (4, 2, 4, False), (6, 2, 2, False),
    (8, 1, 4, True)])
def test_slots_need_r_divisible_by_data(B, B_seq, data, ok):
    """r = B / B_seq must divide over the data ranks: JAX's ValueError,
    from the trainer and from the loop's check, before any step."""
    from ips_tpu_torch.train.loop import check_sharded_slots
    conf = t_config(dict(TINY, B=B, B_seq=B_seq, mesh_data=data))
    mesh = _mesh(data, 1, (0, 0))
    if ok:
        ShardedIPSTrainer(conf, mesh=mesh, device="cpu")
        check_sharded_slots(conf, data)
        return
    with pytest.raises(ValueError, match="divisible by the data"):
        ShardedIPSTrainer(conf, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="divisible by the data"):
        check_sharded_slots(conf, data)


# ------------------------------------------------------------------ loader
class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64)}


@pytest.mark.parametrize("P", [2, 4])
def test_loader_rows_match_jax(P):
    """Every data rank draws the global order from the seed and loads
    its contiguous rows; the ragged last batch is dropped."""
    for idx in range(P):
        ours = [b["x"][:, 0].tolist() for _ in range(2) for b in DataLoader(
            _Items(27), batch_size=8, shuffle=True, seed=5,
            process_index=idx, process_count=P)]
        ref = [np.asarray(b["x"])[:, 0].tolist() for _ in range(2)
               for b in JLoader(_Items(27), batch_size=8, shuffle=True,
                                seed=5, process_index=idx, process_count=P)]
        assert ours == ref and len(ours) == 2 * 3
        assert all(len(b) == 8 // P for b in ours)


def test_loader_rejects_what_jax_rejects():
    for kw, exc in ((dict(batch_size=6, process_count=4), ValueError),
                    (dict(batch_size=8, process_index=2, process_count=2),
                     ValueError)):
        with pytest.raises(exc):
            DataLoader(_Items(8), **kw)
        with pytest.raises(exc):
            JLoader(_Items(8), **kw)


# ----------------------------------------------- BatchNorm over two ranks
def test_weighted_batchnorm_over_two_ranks(tmp_path):
    run_world("torch_parallel_worker:bn", 2, [str(tmp_path)],
              timeout=WORLD_TIMEOUT, python_path=[TESTS])
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    x, w, g = bn_inputs()
    scale = np.linspace(0.5, 1.5, x.shape[1]).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, x.shape[1]).astype(np.float32)

    # one process of the port
    norm = MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = norm(xt, use_running_average=False, weights=torch.from_numpy(w))
    (y * torch.from_numpy(g)).sum().backward()

    # the JAX module (channels last)
    nhwc = (0, 2, 3, 1)

    def f(xj):
        yj, mut = JNorm().apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": np.zeros_like(scale),
                             "var": np.ones_like(scale)}},
            xj, use_running_average=False, weights=w,
            mutable=["batch_stats"])
        return (yj * g.transpose(nhwc)).sum(), (yj, mut["batch_stats"])

    (_, (jy, jbs)), jdx = jax.value_and_grad(f, has_aux=True)(
        x.transpose(nhwc))

    got_y = np.concatenate([r["y"] for r in ranks])
    got_dx = np.concatenate([r["dx"] for r in ranks])
    for ref_y, ref_dx, ref_mean, ref_var in (
            (y.detach().numpy(), xt.grad.numpy(), norm.running_mean.numpy(),
             norm.running_var.numpy()),
            (np.asarray(jy).transpose(0, 3, 1, 2),
             np.asarray(jdx).transpose(0, 3, 1, 2), np.asarray(jbs["mean"]),
             np.asarray(jbs["var"]))):
        np.testing.assert_allclose(got_y, ref_y, atol=BN_TOL)
        np.testing.assert_allclose(got_dx, ref_dx, atol=BN_TOL)
        for r in ranks:
            np.testing.assert_allclose(r["mean"], ref_mean, atol=BN_TOL)
            np.testing.assert_allclose(r["var"], ref_var, atol=BN_TOL)
    # the affine gradients' shares add up to one process's
    np.testing.assert_allclose(ranks[0]["dweight"] + ranks[1]["dweight"],
                               norm.weight.grad.numpy(), atol=BN_TOL)
    np.testing.assert_allclose(ranks[0]["dbias"] + ranks[1]["dbias"],
                               norm.bias.grad.numpy(), atol=BN_TOL)
    # zero-weight rows normalize with the global statistics too
    assert np.array_equal(ranks[0]["mean"], ranks[1]["mean"])
