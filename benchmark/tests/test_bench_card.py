"""On the card: one short run of every cell through the benchmark's own
command, each printing a correct result line. Skipped without a card.

    python -m pytest -m gpu benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import core

CELLS = [w["name"] for w in core.load_json(
    os.path.join(core.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
