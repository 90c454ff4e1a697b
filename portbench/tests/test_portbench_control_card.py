"""The control on the card: the reference in float32 with TF32 on, put in
the program's place, comes out as not correct by the cell's limits, at a
size a test run holds (the cells' widths and depths, a smaller data set).
Run on the card: `python -m pytest portbench/tests -m cuda -q`."""
import copy

import pytest

from portbench.tests import tiny

SMALL = {
    "tacos-eval": {"traffic": {"videos": 4, "sentences": 200}},
    "charades-eval": {"traffic": {"videos": 120, "sentences": 330}},
    "tacos-train": {"traffic": {"videos": 10, "sentences": 400, "batches": 3}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails(card, cell):
    from portbench import control, harness

    h = harness.Run(cell, 5, 0.0, False, device="cuda", overrides=copy.deepcopy(SMALL[cell]))
    fn = control.train_control if h.cell["driver"] == "train" else control.eval_control
    values = fn(h)
    limits = h.cell["limits"]
    assert any(v > limits[k] for k, v in values.items() if k in limits), values


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_program_passes(card, cell):
    """The program at the same small size, on the card, is correct."""
    import time

    from portbench import harness

    h = harness.Run(cell, 5, 1.0, False, device="cuda", t_start=time.perf_counter(),
                    overrides=copy.deepcopy(SMALL[cell]))
    result, checks = harness.load_driver(h.cell["driver"]).run(h)
    assert result["correct"], checks


def test_tiny_sizes_exist():
    assert set(SMALL) == set(tiny.OVERRIDES)
