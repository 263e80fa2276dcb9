"""The control: the plain reference computed in bfloat16, the precision
below the configurations' float32, in the program's place, fails the
limits of ``correct``; the float32 program passes them.  At a size the CPU
holds; on the card at the cells' size, ``python3 benchmark/calibrate.py``."""

import pytest

from benchmark import calibrate, check
from bench_small import SMALL
from test_bench_reference import CONFIGS, cell_of


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_and_program_passes(name):
    cell = cell_of(name)
    cell.traffic.update(SMALL)
    rows = list(calibrate.readings(cell, [2**31 + 5], 1, "cpu"))
    limits = cell.config["limits"]
    program = [r for r in rows if r["kind"] == "program"]
    control = [r for r in rows if r["kind"] == "bf16"]
    assert len(program) == len(control) == SMALL["check_calls"]
    assert all(check.verdict(r, limits) for r in program)
    assert not any(check.verdict(r, limits) for r in control)
    s = calibrate.summary(rows)
    for k in check.NUMBERS:
        assert s["bf16"][k] > limits[k] >= s["program"][k]
