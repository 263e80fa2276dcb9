"""The plain reference against the port's own CPU path, at 32 columns in
float64, with the sample drawn at float64 on both sides.  SPARTACUS's LW
agrees to 1e-6 W m-2, the port's own bar against the JAX package for it:
the 6x6 exponential's generator is near singular in thin regions, and its
two solves lose digits there."""

import json

import pytest
import torch

from benchmark import check, inputs, program, run
from benchmark.reference import step

CONFIGS = ("mcica_rrtmg", "ecckd_mcica", "mcica_rrtmg_spectral",
           "spartacus_ecckd")
# the largest gap of the LW fluxes, W m-2, where the others' 1e-9 is not
LW_BOUND = {"spartacus_ecckd": 1e-6}


def cell_of(name: str):
    """The first cell of BENCHMARK.json on the configuration ``name``."""
    with open(f"{run.ROOT}/BENCHMARK.json") as f:
        cells = json.load(f)["workloads"]
    return run.load_cell(next(w["name"] for w in cells
                              if w["config"] == name))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_in_float64(name):
    cell = cell_of(name)
    profiles = inputs.read_profiles(driver=cell.config.get("driver"))
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
    assert gaps["lw_gap_wm2"] < LW_BOUND.get(name, 1e-9)
    for k in ("sw_direct_gap_wm2", "sw_gap_wm2"):
        assert gaps[k] < 1e-9, k
    assert gaps["fraction_gap"] < 1e-12
    # the columns are not all alike: the sample and the sun differ
    assert float(want["sw_dn"][:, -1].std()) > 1.0
    if cell.config["config"]["do_save_spectral_flux"]:
        # the per-band profiles add up to the broadband ones
        for k in ("lw_up", "sw_dn", "sw_dn_direct_clear"):
            assert torch.allclose(want[k + "_band"].sum(-1), want[k],
                                  rtol=1e-12, atol=1e-9), k
