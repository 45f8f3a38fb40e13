"""Data and exact context parallelism (counterpart of ips_tpu/parallel/).

The mapping. JAX runs one process per host over a (data, patch) mesh of
devices; PyTorch runs one process per device, so here a rank is one
device of the mesh:

  * world and grid: the world size is ``mesh_data x mesh_patch``; rank
    ``r`` sits at ``(d, p) = divmod(r, mesh_patch)``;
  * groups: the data group of a rank holds the ranks with the same ``p``
    (they split the batch rows), its patch group the ranks with the same
    ``d`` (they hold the same rows and split each chunk's encode);
  * devices: each rank runs on ``cuda:(LOCAL_RANK % device_count)``; on
    one card every rank shares ``cuda:0`` (with gloo: NCCL refuses two
    ranks on one device);
  * loader: the JAX package's process-sharded loader is data-rank-sharded
    here: data rank ``d`` loads rows ``[d B / n_dp, (d + 1) B / n_dp)`` of
    every global batch, the ranks of one patch group the same rows; with
    B_seq < B it batches whole optimizer batches, so those rows are the
    rank's r / n_dp slots;
  * a run of several processes with a 1 x 1 mesh in its config takes
    ``mesh_data = world_size // mesh_patch``, as ``ips_tpu/main.py``
    does.

Modules: :mod:`.mesh` (the grid, ``shard_rows``, row-sharded random
draws), :mod:`.distributed` (the process group and the collectives) and
:mod:`.ips_sharded` (``ips_select_cp`` and ``ShardedIPSTrainer``, whose
docstring maps streaming and B_seq < B onto the ranks). This
package imports none of them itself: the model modules import
:mod:`.mesh`, and :mod:`.ips_sharded` imports the trainer.
"""
