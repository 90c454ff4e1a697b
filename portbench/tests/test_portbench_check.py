"""The correctness check: the reference against the program's eval and
train steps at a small size on the CPU (a sound run is correct, and the
gaps are round-off), and a run with the timed path broken underneath comes
out not correct, once for each fault the cell can have."""
import pytest

from portbench.tests import tiny

CELLS = ["tacos-eval", "charades-eval", "tacos-train"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = tiny.run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0
    for name, c in checks.items():
        assert c["value"] <= (0 if c["limit"] == 0 else 1e-5), (name, c)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in ("stale", "drop_half")]
                         + [(c, "alter_answer") for c in CELLS[:2]]
                         + [("tacos-train", "late_stale")])
def test_broken_run_is_not_correct(cell, fault):
    result, checks = tiny.run(cell, fault=fault)
    assert not result["correct"], (fault, checks)
