"""Data parallelism and context parallelism over the patch axis
(counterpart of ips_tpu/parallel/ips_sharded.py).

Data parallelism: each data rank holds B / n_dp rows of every batch (the
loader is data-rank-sharded). Batch statistics and the loss's sum of
row weights are global (``models/norm.py``, ``compute_task_losses``'s
``w_sum``); after the backward one flat all-reduce sums the gradients
over the whole world and a multiply by 1 / mesh_patch undoes the patch
replicas, which compute the same rows: JAX's psum over ``data``. Every
rank then applies the same bits, so parameters and AdamW moments stay
bitwise equal on all ranks. Steps return the global loss (the sum of the
ranks' shares) and the global predictions.

Context parallelism, two modes (``conf.cp_select``):

* ``'exact'`` (default): the single global selection stream of
  ``ips_select`` runs unchanged on every rank of a patch group; only each
  chunk's encode is split, each rank encoding n / n_cp of the chunk's
  patches, and the (B, n, D) embeddings are all-gathered for scoring
  (``_selection_encode_wrap``). Encoding is per patch, so the selection
  is the single-device one. On the eager path every rank still holds its
  whole local batch: context parallelism saves encode time there, not
  patch memory; streaming (below) saves both.
* ``'local_merge'`` (``ips_select_cp``): each of ``n_shards`` contiguous
  slices of the N patches runs its own top-M selection, then the n_shards
  x M survivors are merged by one global rescoring. Under a patch group
  each rank runs its own slice and the survivors' (emb, idx, valid), M x
  D floats a shard, are all-gathered before the merge. Scores are
  softmax-normalized over each candidate set, so this is a heuristic of
  the same family as the single stream.

The JAX package has two multi-device forms, a single-process mesh and
one process per host; a rank here is one device of the mesh, and each
case below takes the form that matches it.

Streaming under a mesh (``select_streaming``, ``eager: false``). JAX's
single-process mesh places each streamed (B, I, ...) chunk with
``_stream_spec``: rows over ``data`` and the patch axis over ``patch``
where they divide, replicated where they do not; a stacked (G, B, I,
...) stage likewise (``_stream_group_sharding``) and the kept (B, M,
...) batch on ``data`` only (``_stream_out_sharding``). Its multi-host
path refuses streaming, because the host-side selection state is per
process. Here each rank streams exactly what one JAX device holds: its
data rank's rows of the batch, and under a patch group of n_cp > 1
only its contiguous I / n_cp slice of every chunk (of the first M tiles
and of the M >= N shortcut's encode too), staged, copied and encoded;
the (B, n, D) embeddings are gathered over the patch group in patch
order (``_stream_patch_split``), and scoring and the top-M run the one
stream on every rank of the group. A count that does not divide is
staged and encoded whole, as ``_stream_spec`` replicates it. The M kept
raw patches are gathered whole, since training is not patch-sharded.
So the ranks compute what the single-process mesh computes, and each
holds 1 / n_cp of a stage on its device.

B_seq < B under several data ranks. JAX's multi-host form shards the
r = B / B_seq loader-slot axis over ``data`` (``_assembled_spec``): the
loader runs at optimizer-batch granularity and each process loads its
contiguous B / n_dp rows of every optimizer batch, which are its
r / n_dp slots; r must divide over the data ranks. The port does the
same, since its ranks are processes: a rank's assembled payload is its
(r / n_dp, B_seq, N, ...) slots, its labels and weights its rows
``row_range(B)``, and one step with global statistics, loss weight and
gradient all-reduce trains the B rows (``train/loop.py``). A slot lies
whole on one rank, so its selection draws its own B_seq rows from its
own generator (``_select_rows``), while dropout in the step draws the
global B rows and keeps the rank's. ``preencode_select: 'auto'``
resolves on the global (r * B_seq, N, ...) table, which is what JAX's
jitted step sees. Streaming with B_seq < B (camelyon_e2e) streams each
of the rank's r / n_dp slots and trains once on its B / n_dp rows: the
single process's select-assemble-train schedule with the work split by
slot.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
import torch.distributed as dist

from ips_tpu_torch.config import Config
from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.ops.selection import (SelectionResult, _gather_rows,
                                         ips_select, select_top_m)
from ips_tpu_torch.parallel.distributed import (all_gather_rows,
                                                all_reduce_sum,
                                                broadcast_state,
                                                local_device)
from ips_tpu_torch.parallel.mesh import (Mesh, make_mesh, row_range,
                                         row_shard, shard_rows)
from ips_tpu_torch.train.steps import IPSTrainer, compute_task_losses
from ips_tpu_torch.train.streaming import PatchSplit


def ips_select_cp(encode_fn, score_fn, patches: torch.Tensor, *, M: int,
                  I: int, n_shards: int,
                  pos_table: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  shuffle: bool = False, shuffle_style: str = "batch",
                  return_emb: bool = False, group=None) -> SelectionResult:
    """Context-parallel IPS: per-shard local top-M, then one global merge.

    patches: (B, N, ...) with N divisible by ``n_shards``. Without a
    ``group`` the shards run here in order; with one (its size
    ``n_shards``) each rank runs the shard of its group rank and the
    shards' survivors are all-gathered. With ``shuffle`` each shard draws
    its permutation from a generator of its own, seeded from
    ``generator`` (one draw of ``n_shards`` seeds, as JAX splits the key),
    so the ranks and one process draw alike.
    """
    B, N = patches.shape[:2]
    if N % n_shards:
        raise ValueError(f"N={N} not divisible by n_shards={n_shards}")
    n_local = N // n_shards
    if M >= n_local:
        raise ValueError(
            f"context parallelism needs M < N/n_shards (M={M}, "
            f"N/n_shards={n_local}); reduce n_shards or use single-shard "
            "selection")
    seeds = [None] * n_shards
    if shuffle:
        if generator is None:
            raise ValueError("shuffle=True requires a torch.Generator")
        seeds = torch.randint(2**62, (n_shards,), generator=generator,
                              device=generator.device).tolist()

    def local(s):
        sl = slice(s * n_local, (s + 1) * n_local)
        gen = (None if seeds[s] is None else torch.Generator(
            device=generator.device).manual_seed(seeds[s]))
        res = ips_select(encode_fn, score_fn, patches[:, sl], M=M, I=I,
                         pos_table=(None if pos_table is None
                                    else pos_table[sl]),
                         mask=None if mask is None else mask[:, sl],
                         generator=gen, shuffle=shuffle,
                         shuffle_style=shuffle_style, return_emb=True)
        return (res.mem_emb.float(), res.mem_idx + s * n_local,
                res.mem_mask)

    if group is None:
        g_emb, g_idx, g_valid = (torch.cat(xs, dim=1) for xs in
                                 zip(*(local(s) for s in range(n_shards))))
    else:
        if dist.get_world_size(group) != n_shards:
            raise ValueError(
                f"n_shards={n_shards} must equal the patch group's size "
                f"({dist.get_world_size(group)})")
        emb, idx, valid = local(dist.get_rank(group))
        # one gather: the indices (< 2^24) and validity ride as exact fp32
        packed = all_gather_rows(torch.cat(
            [emb, idx[..., None].float(), valid[..., None].float()], -1),
            group, dim=1)
        g_emb = packed[..., :-2]
        g_idx = packed[..., -2].long()
        g_valid = packed[..., -1] > 0

    emb_to_score = g_emb + pos_table[g_idx] if pos_table is not None \
        else g_emb
    mem_emb, mem_idx, mem_valid = select_top_m(g_emb, emb_to_score, g_idx,
                                               g_valid, M, score_fn)
    mem_patch = _gather_rows(patches, mem_idx)
    mem_pos = pos_table[mem_idx] if pos_table is not None else None
    return SelectionResult(mem_patch, mem_pos, mem_idx, mem_valid,
                           mem_emb if return_emb else None)


class ShardedIPSTrainer(IPSTrainer):
    """IPSTrainer over a (data, patch) grid of ranks: this rank's rows of
    every batch in, the global loss and predictions out (see the module
    docstring). Weights are drawn from the seed on every rank, then
    broadcast from rank 0."""

    def __init__(self, conf: Config, mesh: Optional[Mesh] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 init_opt: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh(
            conf.mesh_data, conf.mesh_patch, local_device(device))
        self.n_dp, self.n_cp = self.mesh.n_dp, self.mesh.n_cp
        if conf.B % self.n_dp:
            raise ValueError(
                f"B={conf.B} must be a multiple of the data mesh axis "
                f"({self.n_dp})")
        r = conf.B // conf.B_seq
        if conf.B_seq < conf.B and r % self.n_dp:
            raise ValueError(
                f"multi-host assembled path needs r = B/B_seq divisible by "
                f"the data-axis size (r={r}, data={self.n_dp})")
        if self.n_cp > 1:
            if conf.N % self.n_cp:
                raise ValueError(
                    f"N={conf.N} must be divisible by the patch mesh axis "
                    f"({self.n_cp})")
            # exact CP runs the single global stream; only the local merge
            # needs M local survivors in every shard
            if (conf.cp_select == "local_merge"
                    and conf.M >= conf.N // self.n_cp):
                raise ValueError(
                    f"cp_select='local_merge' needs M < N/mesh_patch "
                    f"(M={conf.M}, N/mesh_patch={conf.N // self.n_cp})")
        super().__init__(conf, device=self.mesh.device, generator=generator,
                         init_opt=init_opt)
        if self.n_dp > 1:
            for m in self.model.modules():
                if isinstance(m, MaskedBatchNorm):
                    m.group = self.mesh.data_group
        broadcast_state(self.model, self.opt)

    # -- rows ---------------------------------------------------------------
    def put_batch(self, tree):
        """This rank's rows of a global batch tree, on its device."""
        return shard_rows(tree, self.mesh)

    def _rows(self):
        """Random draws by row see the global batch (parallel/mesh.py)."""
        if self.n_dp == 1:
            return contextlib.nullcontext()
        return row_shard(self.conf.B,
                         row_range(self.conf.B, self.mesh)[0])

    def _select_rows(self):
        """Random draws by row of a selection see the global rows of the
        batch it selects: a B_seq == B batch is split over the data ranks;
        a slot of B_seq < B rows lies whole on one rank and draws its own
        rows, as one process's loader batch does."""
        if self.conf.B_seq < self.conf.B:
            return contextlib.nullcontext()
        return self._rows()

    def _slot_table_rows(self, local_rows: int) -> int:
        """The global stacked table's rows: the data ranks hold r / n_dp
        slots each."""
        return local_rows * self.n_dp

    # -- selection ----------------------------------------------------------
    def _selection_encode_wrap(self):
        """Exact context parallelism: each rank of the patch group encodes
        its n / n_cp patches of every chunk (a chunk that does not divide
        is encoded whole by each), and the embeddings are gathered back
        in patch order for the single global stream."""
        if self.n_cp <= 1 or self.conf.cp_select != "exact":
            return None
        n_cp, p, group = self.n_cp, self.mesh.coords[1], \
            self.mesh.patch_group

        def wrap(encode_fn, x):
            if x.shape[1] % n_cp:
                return encode_fn(x)
            k = x.shape[1] // n_cp
            return all_gather_rows(encode_fn(x[:, p * k:(p + 1) * k]),
                                   group, dim=1)

        return wrap

    def _stream_patch_split(self):
        """Streaming under a patch group: this rank's place (its patch
        rank, the group's size) and the gather of the embeddings over the
        group (see the module docstring); None on one patch rank. The
        streamed stream is exact whatever ``cp_select`` says, as JAX's."""
        if self.n_cp <= 1:
            return None
        group = self.mesh.patch_group
        return PatchSplit(self.mesh.coords[1], self.n_cp,
                          lambda e: all_gather_rows(e, group, dim=1))

    def _select_impl(self, patches, mask, generator=None, return_emb=False,
                     preencode=None):
        conf = self.conf
        with self._select_rows():
            if self.n_cp <= 1 or conf.cp_select == "exact":
                return super()._select_impl(patches, mask, generator,
                                            return_emb, preencode)
            # the local merge streams per-shard chunks and never
            # pre-encodes ('auto' resolves off here)
            if (conf.input_dtype == "bfloat16"
                    and patches.dtype != torch.uint8):
                patches = patches.to(torch.bfloat16)
            encode, score = self._enc_score_fns()
            res = ips_select_cp(
                encode, score, patches, M=conf.M, I=conf.I,
                n_shards=self.n_cp, pos_table=self.pos_table, mask=mask,
                generator=generator, shuffle=conf.shuffle,
                shuffle_style=conf.shuffle_style, return_emb=return_emb,
                group=self.mesh.patch_group)
        out = (res.mem_patch, res.mem_pos, res.mem_idx, res.mem_mask)
        return out + (res.mem_emb,) if return_emb else out

    @torch.no_grad()
    def select_streaming(self, *args, **kw):
        with self._select_rows():
            return super().select_streaming(*args, **kw)

    # -- losses, gradients and outputs --------------------------------------
    def _task_losses(self, preds, labels, weights):
        if self.n_dp == 1:
            return super()._task_losses(preds, labels, weights)
        w_sum = weights.detach().sum().reshape(1)
        dist.all_reduce(w_sum, group=self.mesh.data_group)
        return compute_task_losses(self.conf, preds, labels, weights,
                                   w_sum[0])

    def _reduce_grads(self) -> None:
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        # the patch replicas computed the same rows: 1 / n_cp is a power
        # of two in every shipped mesh, so the multiply is exact
        all_reduce_sum(grads, scale=1.0 / self.n_cp)

    def _global(self, out):
        """(loss, task losses, preds) of this rank's rows -> the global
        batch's: the losses' shares summed, the predictions gathered in
        data-rank order."""
        if self.n_dp == 1:
            return out
        loss, task_losses, preds = out
        group = self.mesh.data_group
        names = list(task_losses)
        sums = torch.stack([loss] + [task_losses[k] for k in names]).float()
        dist.all_reduce(sums, group=group)
        flat = all_gather_rows(torch.cat(
            [v.reshape(v.shape[0], -1).float() for v in preds.values()],
            dim=1), group)
        out_preds, off = {}, 0
        for k, v in preds.items():
            n = v[0].numel()
            out_preds[k] = flat[:, off:off + n].reshape(
                (-1,) + v.shape[1:]).to(v.dtype)
            off += n
        return (sums[0].to(loss.dtype),
                {k: sums[1 + j].to(task_losses[k].dtype)
                 for j, k in enumerate(names)}, out_preds)

    def _train_impl(self, *args):
        with self._rows():
            return self._global(super()._train_impl(*args))

    @torch.no_grad()
    def eval_step(self, *args):
        return self._global(super().eval_step(*args))

    @torch.no_grad()
    def eval_from_emb_step(self, *args):
        return self._global(super().eval_from_emb_step(*args))
