"""The (data, patch) grid of ranks and the batch-row helpers (counterpart
of ips_tpu/parallel/mesh.py).

A rank is one device of the mesh: rank ``r`` of a world of ``data x
patch`` processes sits at ``(d, p) = divmod(r, patch)``. Its data group
holds the ranks with the same ``p`` (they split the batch rows); its
patch group the ranks with the same ``d`` (they hold the same rows and
split each selection chunk's patches).

Random draws that depend on the batch size (dropout masks, per-instance
shuffles) must not change with the number of data ranks: inside
:func:`row_shard` they draw the global shape and keep this rank's rows
(:func:`rand_rows`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ips_tpu_torch.parallel.distributed import local_device

DATA_AXIS = "data"
PATCH_AXIS = "patch"


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, patch) grid of ranks.

    ``data_group`` and ``patch_group`` are process groups, None where the
    axis has one rank."""

    shape: dict                 # {DATA_AXIS: n_dp, PATCH_AXIS: n_cp}
    coords: tuple               # this rank's (d, p)
    device: torch.device
    data_group: Any = None
    patch_group: Any = None

    @property
    def n_dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_cp(self) -> int:
        return self.shape[PATCH_AXIS]

    @property
    def size(self) -> int:
        return self.n_dp * self.n_cp


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: int = 1, patch: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The grid over every rank of the process group (one rank without
    one). Every rank must call it with the same shape: the subgroups are
    made in the same order on each, as ``dist.new_group`` requires."""
    world, rank = _world()
    need = data * patch
    if need > world:
        raise ValueError(
            f"mesh ({data}x{patch}) needs {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"mesh ({data}x{patch}) covers {need} of the {world} ranks; a "
            "rank outside it would never join the gradient all-reduce")
    if device is None:
        device = local_device()
    d, p = divmod(rank, patch)
    data_group = patch_group = None
    if world > 1:
        # every rank makes every group, in one order
        for q in range(patch):
            g = dist.new_group([e * patch + q for e in range(data)])
            if q == p and data > 1:
                data_group = g
        for e in range(data):
            g = dist.new_group([e * patch + q for q in range(patch)])
            if e == d and patch > 1:
                patch_group = g
    return Mesh({DATA_AXIS: data, PATCH_AXIS: patch}, (d, p),
                torch.device(device), data_group, patch_group)


def row_range(rows: int, mesh: Mesh) -> tuple:
    """This rank's [lo, hi) of ``rows`` batch rows; all of them when the
    rows do not divide over the data axis (they are then replicated, as
    ``shard_batch`` leaves them)."""
    n_dp, d = mesh.n_dp, mesh.coords[0]
    if rows % n_dp:
        return 0, rows
    k = rows // n_dp
    return d * k, (d + 1) * k


def shard_rows(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of each array or tensor of a batch tree (dim 0),
    on the mesh's device; a leading dim that does not divide the data
    axis is kept whole (replicated). ``batch_spec``/``shard_batch`` of
    the JAX package."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_rows(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_rows(v, mesh) for v in tree)
    t = torch.as_tensor(tree)
    lo, hi = row_range(t.shape[0], mesh)
    return t[lo:hi].to(mesh.device)


# -------------------------------------------------- random draws by row
_ROWS: Optional[tuple] = None    # (global rows, this rank's first row)


@contextlib.contextmanager
def row_shard(n_global: int, start: int):
    """Within the block, :func:`rand_rows` of a local (n, ...) shape draws
    (n_global, ...) and keeps rows [start, start + n)."""
    global _ROWS
    saved, _ROWS = _ROWS, (n_global, start)
    try:
        yield
    finally:
        _ROWS = saved


def rand_rows(shape: Sequence[int], generator: torch.Generator,
              device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, where dim 0 is batch rows:
    under :func:`row_shard` the global rows are drawn and this rank's
    kept, so that every rank consumes the generator as one process
    would and gets that process's values for its rows."""
    if _ROWS is None or shape[0] == _ROWS[0]:
        return torch.rand(tuple(shape), generator=generator, device=device)
    n_global, start = _ROWS
    full = torch.rand((n_global,) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[start:start + shape[0]]
