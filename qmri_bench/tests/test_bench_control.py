"""The control of every cell comes out not correct, where the program comes
out correct (``control.py`` runs the same on the card at the cells' sizes).
A cell's control has to fail one of its numbers."""

import pytest

from qmri_bench.tests.conftest import CELLS, small_run


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    r = small_run(cell, control=True)
    assert r["correct"]
    failed = [k for k, c in r["checks"].items() if r["control"][k] > c["limit"]]
    assert failed, (r["control"], r["checks"])
