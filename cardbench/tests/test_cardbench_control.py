"""The comparison fails what it must: the control (the reference computed
on fp8 values, one step below the configuration's bf16) in the program's
place, and the timed path broken underneath in each way a serving cell
can break: rows of the batch left out (half, or about 30%), boxes moved
or labels altered where they are produced on about 30% of the rows.  Each
drives the rest of a run on the CPU at a small batch, with the cell's own
limits; the sound program passes beside them."""

import pytest

from cardbench import harness
from cardbench.control import FAULTS, control_call
from cardbench.tests.conftest import small_cell

CELLS = ["litepi-v2.card-b256", "yolo11n-resnet18.card-b256"]
SEED = 3_000_000_019


def run(cell, **kw):
    return harness.run(cell, SEED, 1.0, False, device="cpu", **kw)["result"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_passes_and_control_fails(name):
    cell = small_cell(name)
    assert run(cell)["correct"] is True
    assert run(cell, make_call=control_call)["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    # at 10 rows the 30% faults break 3 of each batch
    result = run(small_cell(name, batch=10 if fault.endswith("30") else 4), wrap=FAULTS[fault])
    assert result["correct"] is False
