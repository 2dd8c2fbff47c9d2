"""The control on the card at each cell's own size: the plain reference in
the program's place, computed with TF32 products, compared with the
float64 reference as a run compares the program, has to come out not
correct under the cell's limits (bench_port/control.py reads it on more
seeds)."""

import pytest

from bench_port import cell as cells
from bench_port import check, control

WORKLOADS = ("p2d_scaled.pallas", "p2d_scaled.ens4", "p2d_scaled.taylor", "p2d_e256.mesh4")


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_tf32_control_is_not_correct(card, workload):
    cell = cells.load(workload)
    numbers = control.in_place(cell, 11, card, tf32=True, half=False)
    assert not check.verdict(numbers, cell["limits"]), numbers
