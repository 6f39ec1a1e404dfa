"""The control of the output check (the plain reference in bfloat16 in the
program's place) comes out not correct, through the benchmark's own run,
at a size a test run holds; the same runs on the card at the cell's size
come from ``python3 -m rtbench.tools.control``."""

import pytest

from rtbench import control, core
from rtbench.tests.conftest import TINY, tiny_cell

CELLS = tuple(w["name"] for w in core.load_json(core.CHECKOUT / "BENCHMARK.json")["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(cell):
    out = core.execute(tiny_cell(cell), 20261019, 0.05, False, device="cpu", t_start=0.0,
                       size=TINY, stand_in=control.stand_in)
    assert not out["correct"]
    gap = next(c for name, c in out["checks"].items() if name.endswith("_gap_pct"))
    assert gap["value"] > gap["limit"]
