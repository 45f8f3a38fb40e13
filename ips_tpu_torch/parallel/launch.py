"""Start a world of ranks on this machine, each with a deadline.

    run_world("pkg.module:function", world=2, args=[...], timeout=120)

starts ``world`` processes of ``python -m ips_tpu_torch.parallel.launch
pkg.module:function args...``, each with the environment that ``python
-m torch.distributed.run`` sets (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR=localhost`` and ``MASTER_PORT``), and calls
``function(args)`` in each; the function joins the process group itself.
When a rank fails, or the world outlives its deadline, every rank is
killed and ``run_world`` raises with each rank's output: a collective
left waiting fails instead of hanging.

The world's rendezvous store is hosted by ``run_world`` itself, as
``torch.distributed.run``'s agent hosts it: a ``TCPStore`` on a port the
system picks, held from before the first rank starts until the last one
has ended, and ``TORCHELASTIC_USE_AGENT_STORE=True`` makes every rank's
``env://`` rendezvous a client of it. No rank listens on a number chosen
earlier, so worlds started side by side cannot take each other's port.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run_world(target: str, world: int, args: Sequence[str] = (),
              timeout: float = 120.0, env: Optional[Dict[str, str]] = None,
              python_path: Sequence[str] = ()) -> List[str]:
    """Run ``target`` ("module:function") on ``world`` ranks; returns each
    rank's output (stdout and stderr together), or raises RuntimeError
    when a rank fails or ``timeout`` seconds pass."""
    store = dist.TCPStore("localhost", 0, is_master=True,
                          wait_for_workers=False)
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [REPO, *python_path] + ([base["PYTHONPATH"]]
                                if base.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="ips_world_") as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
        procs = []
        for r in range(world):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                     MASTER_PORT=str(store.port),
                     TORCHELASTIC_USE_AGENT_STORE="True")
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ips_tpu_torch.parallel.launch",
                     target, *args], env=e, cwd=REPO, stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"the world outlived its {timeout:g} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [_tail(path) for path in logs]
    if failed:
        raise RuntimeError(f"{target} on {world} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
    return outs


def _rank_entry(argv: Sequence[str]) -> None:
    """One rank: TF32 off (as every entry point of the port), then the
    target with the remaining arguments; a process group the target left
    open ends before the interpreter does (torch can abort at exit with
    its threads still running)."""
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    module, _, name = argv[0].partition(":")
    getattr(importlib.import_module(module), name)(list(argv[1:]))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_entry(sys.argv[1:])
