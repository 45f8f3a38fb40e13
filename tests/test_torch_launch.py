"""``ips_tpu_torch.parallel.launch.run_world`` on the CPU: the world's
rendezvous port is held for as long as the world runs, worlds started
side by side all finish, and a rank that fails takes the world down with
every rank's output.

The rank functions below run in the world's processes (this module is
imported there by name); they import nothing of JAX.
"""

import errno
import os
import socket
import threading
import time

import pytest

from ips_tpu_torch.parallel.launch import run_world

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 60
# worlds started at once from threads, and how many times
PARALLEL_WORLDS, ROUNDS = 6, 3


# ------------------------------------------------------------ rank functions
def _join():
    import torch
    torch.set_num_threads(1)
    from ips_tpu_torch.parallel.distributed import initialize
    assert initialize(device="cpu")
    import torch.distributed as dist
    return dist.get_rank()


def _sum_of_ranks():
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    return float(t)


def hold(argv):
    """Joins, writes its MASTER_PORT, waits for the test's go, then
    all-reduces and writes the sum."""
    out_dir, = argv
    r = _join()
    with open(os.path.join(out_dir, f"port{r}"), "w") as f:
        f.write(os.environ["MASTER_PORT"])
    go = os.path.join(out_dir, "go")
    deadline = time.monotonic() + WORLD_TIMEOUT
    while not os.path.exists(go):
        assert time.monotonic() < deadline, "no go from the test"
        time.sleep(0.05)
    with open(os.path.join(out_dir, f"sum{r}"), "w") as f:
        f.write(str(_sum_of_ranks()))


def trivial(argv):
    _join()
    total = _sum_of_ranks()
    assert total == 3.0, total
    print(f"sum {total:g}", flush=True)


def fail(argv):
    r = _join()
    print(f"rank {r} joined", flush=True)
    if r == 1:
        raise ValueError("rank 1 fails on purpose")
    import torch.distributed as dist
    dist.barrier()          # never completes: rank 1 has gone


# --------------------------------------------------------------------- tests
def _wait_for(paths, thread, limit=WORLD_TIMEOUT):
    deadline = time.monotonic() + limit
    while not all(os.path.exists(p) for p in paths):
        assert thread.is_alive(), "the world ended early"
        assert time.monotonic() < deadline, f"no {paths}"
        time.sleep(0.05)


def test_master_port_is_held_while_the_world_runs(tmp_path):
    result = {}

    def world():
        try:
            result["out"] = run_world("test_torch_launch:hold", 2,
                                      [str(tmp_path)],
                                      timeout=WORLD_TIMEOUT,
                                      python_path=[TESTS])
        except BaseException as e:   # the test thread reports it
            result["error"] = e

    t = threading.Thread(target=world)
    t.start()
    try:
        ports = [tmp_path / f"port{r}" for r in range(2)]
        _wait_for(ports, t)
        port, other = (int(p.read_text()) for p in ports)
        assert port == other and port > 0
        # both ranks have joined: the port is still bound
        with socket.socket() as s:
            with pytest.raises(OSError) as e:
                s.bind(("localhost", port))
        assert e.value.errno == errno.EADDRINUSE
    finally:
        (tmp_path / "go").touch()
        t.join(WORLD_TIMEOUT + 10)
    assert "error" not in result, result.get("error")
    assert [float((tmp_path / f"sum{r}").read_text()) for r in range(2)] \
        == [3.0, 3.0]


def test_worlds_started_at_once_all_finish():
    for round_ in range(ROUNDS):
        outs, errors = {}, {}

        def world(i):
            try:
                outs[i] = run_world("test_torch_launch:trivial", 2,
                                    timeout=WORLD_TIMEOUT,
                                    python_path=[TESTS])
            except BaseException as e:
                errors[i] = e

        threads = [threading.Thread(target=world, args=(i,))
                   for i in range(PARALLEL_WORLDS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WORLD_TIMEOUT + 10)
        assert not errors, f"round {round_}: {errors}"
        assert sorted(outs) == list(range(PARALLEL_WORLDS))
        for ranks in outs.values():
            assert all("sum 3" in o for o in ranks)


def test_failing_rank_fails_the_world_with_every_output():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        run_world("test_torch_launch:fail", 2, timeout=WORLD_TIMEOUT,
                  python_path=[TESTS])
    assert time.monotonic() - t0 < WORLD_TIMEOUT    # not the deadline
    msg = str(e.value)
    assert "rank 1 exited with 1" in msg
    assert "--- rank 0 ---" in msg and "--- rank 1 ---" in msg
    assert "rank 0 joined" in msg
    assert "ValueError: rank 1 fails on purpose" in msg
