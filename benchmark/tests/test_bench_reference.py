"""The plain reference against the port's own CPU path, at 32 columns in
float64, with the sample drawn at float64 on both sides."""

import pytest
import torch

from benchmark import check, inputs, program, run
from benchmark.reference import step

CONFIGS = ("mcica_rrtmg", "ecckd_mcica")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_in_float64(name):
    cell = run.load_cell(f"{name}.rank2k")
    profiles = inputs.read_profiles()
    solar = profiles["solar_irradiance"]
    pool = inputs.make_pool(inputs.profiles_on(profiles, "cpu",
                                               torch.float64),
                            2**31 + 99, 1, 32)
    prog = program.build(cell.config_path, "cpu", torch.float64)
    got = program.call(prog, pool[0], 32, solar).fields()
    ref = step.setup(cell.config_path, "cpu", torch.float64, torch.float64)
    want = step.fluxes(ref, pool[0], solar)
    gaps = check.gaps(got, want)
    assert gaps["nonfinite"] == 0
    for k in ("lw_gap_wm2", "sw_direct_gap_wm2", "sw_gap_wm2"):
        assert gaps[k] < 1e-9, k
    assert gaps["fraction_gap"] < 1e-12
    # the columns are not all alike: the sample and the sun differ
    assert float(want["sw_dn"][:, -1].std()) > 1.0
