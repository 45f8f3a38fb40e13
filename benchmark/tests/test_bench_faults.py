"""A whole run of each cell at a tiny size on the CPU, past the check for
a card, with the limits of the cell: the program as it is comes out
correct, and with each fault that the cell can have planted underneath
the timed path (``benchmark/faults.py``), ``correct`` comes out false."""

import pytest
import torch

import run
from benchmark import faults
from benchmark.tests import tiny

SEED = 2 ** 31 + 4242


def _measure(name, tmp_path, plant=None):
    undo = []
    try:
        return run.measure(
            tiny.cell(name), SEED, 0.5, False, torch.device("cpu"),
            str(tmp_path), t_start=0.0,
            break_program=None if plant is None
            else lambda obj: undo.append(plant(obj)))
    finally:
        for u in undo:
            u()


@pytest.mark.parametrize("name", ["mnist.train", "camelyon_e2e.train"])
def test_training_cells(name, tmp_path):
    assert _measure(name, tmp_path)["correct"]
    res = _measure(name, tmp_path, faults.state_unchanged)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert not _measure(name, tmp_path, faults.half_batch)["correct"]


def test_streamed_selection_is_judged(tmp_path):
    sound = _measure("camelyon_e2e.train", tmp_path)
    assert sound["checks"]["sel_lift_gap"]["value"] < 1e-3
    res = _measure("camelyon_e2e.train", tmp_path, faults.scores_ignored)
    assert not res["correct"]
    assert res["checks"]["sel_lift_gap"]["value"] > 0.3


def test_serving_cell(tmp_path):
    assert _measure("mnist.serve", tmp_path)["correct"]
    res = _measure("mnist.serve", tmp_path, faults.answer_altered)
    assert not res["correct"]
    assert res["checks"]["prob_gap"]["value"] > 0.5
