"""Process-group set-up and the collectives of the port (counterpart of
ips_tpu/parallel/distributed.py).

``initialize`` calls ``torch.distributed.init_process_group`` once per
process. The rendezvous comes from the config (``coordinator_address``
host:port, ``num_processes``, ``process_id``) or from the environment
that ``python -m torch.distributed.run`` sets (``MASTER_ADDR``/``PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as JAX detects its own.

The backend is chosen, never fallen back to: ``nccl`` for a run on the
card, ``gloo`` for ``cpu_collectives: gloo`` or a CPU run, ``mpi`` when
asked for and built into torch (else it raises). NCCL refuses two ranks
on one device, so ranks that share one card run with
``cpu_collectives: gloo``; ranks on cards of their own use NCCL.

Every collective here is an all-reduce or a broadcast: gloo takes CUDA
tensors for those two and for no other, so the same code runs on
gloo-CPU, gloo-CUDA and NCCL. ``all_gather_rows`` is an all-reduce of a
buffer filled with -0.0 into which each rank writes its own slice:
``-0.0 + x == x`` for every float ``x`` (signed zeros included), so the
gather is bitwise exact in any summation order.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist


def local_device(device: Optional[Union[str, torch.device]] = None
                 ) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` unless the
    caller names another (``cpu``, or a card with its index). Without a
    card a CUDA request raises, as every entry point of the port does."""
    from ips_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def backend_for(device: torch.device, cpu_collectives: str = "") -> str:
    if cpu_collectives == "mpi":
        if not dist.is_mpi_available():
            raise RuntimeError(
                "cpu_collectives='mpi' needs a torch built with MPI; this "
                "one has none (use cpu_collectives='gloo')")
        return "mpi"
    if cpu_collectives == "gloo" or device.type != "cuda":
        return "gloo"
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               cpu_collectives: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the process group once; returns whether this is a run of
    several processes. Without an address from the caller or the
    environment the run is a single process and nothing is set up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address:
        if num_processes is None or process_id is None:
            num_processes = num_processes or int(env.get("WORLD_SIZE", 0))
            process_id = (process_id if process_id is not None
                          else int(env.get("RANK", -1)))
        if num_processes < 1 or process_id < 0:
            raise ValueError(
                "coordinator_address needs num_processes and process_id "
                "(in the config, or WORLD_SIZE and RANK in the environment)")
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
        init_method = "env://"
    else:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, cpu_collectives or "")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def initialize_from_config(conf, device=None) -> bool:
    """The CLI's entry: the config's multihost knobs into ``initialize``;
    a single-process run unless ``conf.multihost``."""
    if not conf.multihost:
        return False
    return initialize(conf.coordinator_address or None,
                      conf.num_processes or None,
                      conf.process_id if conf.process_id >= 0 else None,
                      conf.cpu_collectives or None, device)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0
                    ) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all of them) concatenated along
    ``dim`` in group-rank order (``x`` itself without a process group).
    Bitwise exact for floats (see the module docstring); bool tensors
    travel as uint8."""
    if not dist.is_initialized():
        return x
    n = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    src = x.to(torch.uint8) if is_bool else x
    shape = list(src.shape)
    k = shape[dim]
    shape[dim] = n * k
    fill = -0.0 if src.is_floating_point() else 0
    out = torch.full(shape, fill, dtype=src.dtype, device=src.device)
    me = dist.get_rank(group)
    out.narrow(dim, me * k, k).copy_(src)
    dist.all_reduce(out, group=group)
    return out.bool() if is_bool else out


def host_allgather(tree: Any, group=None, device=None) -> Any:
    """Concatenate each numpy array of ``tree`` along dim 0 over
    ``group`` (rank order); ``tree`` itself without a process group. The global
    labels, row weights and predictions of the metrics. The arrays travel
    as tensors on ``device`` (the rank's device: gloo or NCCL take it)."""
    if not dist.is_initialized():
        return tree
    if isinstance(tree, dict):
        return {k: host_allgather(v, group, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_allgather(v, group, device) for v in tree)
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return all_gather_rows(t, group).cpu().numpy().astype(a.dtype, copy=False)


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   scale: float = 1.0) -> None:
    """Sum same-dtype tensors over the world in place, through one flat
    buffer, then multiply by ``scale``; the gradient all-reduce."""
    if not dist.is_initialized() and scale == 1.0:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if dist.is_initialized():
        dist.all_reduce(flat)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def broadcast_state(module: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> None:
    """Rank 0's parameters, buffers and AdamW moments to every rank: the
    replicated state of the JAX package's ``put_replicated_global``.
    Optimizer entries off the module's device (AdamW's step counts on the
    CPU) stay as they are; every rank counts the same steps."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    if optimizer is not None:
        dev = tensors[0].device
        for state in optimizer.state.values():
            tensors += [v for v in state.values()
                        if isinstance(v, torch.Tensor) and v.device == dev]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0)
