"""The cell ``spartacus_rrtmg.allday16k`` at a small size on the CPU:
ecRad's ``spartacus`` target on the CY49R1 optics (RRTMG at 112 / 140
g-points), through the port's normal path, against the plain reference at
float64.  The sound program is correct; the program that leaves RRTMG's
g-points in their natural order (so that the ng3D prefix of the 3D
exponential falls on other g-points) is not; the bfloat16 control fails the
limits; and a traced run reads the layer matrices' and the g reordering's
spans."""

import time

import numpy as np
import pytest

from benchmark import calibrate, check, run
from bench_small import SMALL

CELL = "spartacus_rrtmg.allday16k"


def _cell():
    cell = run.load_cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def test_configuration_is_the_flagships_with_spartacus():
    """The configuration is mcica_rrtmg's, field for field, but the two
    solver names, with spartacus_ecckd's cloud sizes."""
    cell = _cell()
    flagship = run.load_cell("mcica_rrtmg.slab16k").config
    spartacus = run.load_cell("spartacus_ecckd.slab16k").config
    fields = dict(cell.config["config"])
    assert fields.pop("sw_solver") == fields.pop("lw_solver") == "SPARTACUS"
    want = dict(flagship["config"])
    del want["sw_solver"], want["lw_solver"]
    assert fields == want
    assert cell.config["driver"] == spartacus["driver"]
    assert cell.config["limits"] == flagship["limits"]
    assert cell.config["reduced"] == flagship["reduced"]
    assert run.mix_value(cell.traffic, "sun") == "day"


def _natural_order(config, is_sw):
    """RRTMG's g-points left in their natural order."""
    return np.arange(config.n_g_sw if is_sw else config.n_g_lw)


@pytest.mark.parametrize("fault", (None, _natural_order),
                         ids=("sound", "natural_order"))
def test_natural_g_order_is_not_correct(monkeypatch, fault):
    from ecrad_torch import interface
    if fault is not None:
        monkeypatch.setattr(interface, "_spartacus_perm", fault)
    out = run.run_cell(_cell(), 2**31 + 41, 0.5, False, "cpu", time.time())
    assert out["correct"] is (fault is None), out["checked"]
    assert out["checked"]["nonfinite"]["value"] == 0


def test_control_fails_and_program_passes():
    cell = _cell()
    rows = list(calibrate.readings(cell, [2**31 + 43], 1, "cpu"))
    limits = cell.config["limits"]
    prog = [r for r in rows if r["kind"] == "program"]
    control = [r for r in rows if r["kind"] == "bf16"]
    assert len(prog) == len(control) == SMALL["check_calls"]
    assert all(check.verdict(r, limits) for r in prog)
    assert not any(check.verdict(r, limits) for r in control)


def test_traced_run_reads_the_layer_matrices_and_the_reorder():
    """A traced run reads the two SPARTACUS spans, each a part of the
    solvers' layer, and no metric of the McICA generator or the region
    set-up (whose lists name other cells)."""
    out = run.run_cell(_cell(), 2**31 + 47, 0.5, True, "cpu", time.time())
    assert out["correct"] is True
    metrics = out["metrics"]
    for name in ("layer_mats_dev_ms_per_kcol", "reorder_dev_ms_per_kcol"):
        assert metrics[name]["value"] is not None, name
        assert metrics[name]["unit"] == "ms/kcol"
    assert metrics["solvers_host_ms_per_kcol"]["value"] > 0
    assert not any(k.startswith(("generator", "cumulator", "sampler",
                                 "regions")) for k in metrics)
