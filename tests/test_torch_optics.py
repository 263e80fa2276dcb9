"""The port's optical properties (RRTMG gas optics, general aerosols,
SOCRATES/Fu cloud optics, surface albedos and emissivities) against the
JAX package's compute_radiative_properties on the 32 meridian columns of
the flagship configuration (CPU, f64).

Same gathers and formulas; XLA's exp/log differ from libm's by an ulp, so
the bar is f64 roundoff: rtol 1e-10."""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from ecrad_tpu.interface import compute_radiative_properties
from ecrad_torch import flagship
from ecrad_torch.interface import _optical_properties

torch.set_num_threads(2)

RTOL = 1e-10
ARGS = ("pressure_hl", "temperature_hl", "gas_mmr", "cos_sza",
        "skin_temperature", "sw_albedo", "sw_albedo_direct",
        "lw_emissivity", "cloud", "aerosol")


@pytest.fixture(scope="module")
def both():
    jstep, jargs = __graft_entry__._build(ncol=32, dtype="float64")
    jkw = dict(zip(ARGS, jargs), solar_irradiance=jstep.solar)
    ref = jax.jit(lambda kw: compute_radiative_properties(
        jstep.config, jstep.tables, **kw))(jkw)
    tstep, targs = flagship.build(ncol=32, dtype=torch.float64)
    op = _optical_properties(tstep.config, tstep.tables,
                             solar_irradiance=tstep.solar,
                             **dict(zip(ARGS, targs)))
    go = op["go"]
    got = dict(
        od_sw=op["od_sw"], ssa_sw=op["ssa_sw"], asymmetry_sw=op["g_sw_arr"],
        incoming_sw=go.incoming_sw, sw_albedo=op["sw_albedo_diffuse_g"],
        sw_albedo_direct=op["sw_albedo_direct_g"],
        od_lw=op["od_lw"], ssa_lw=op["ssa_lw"], asymmetry_lw=op["g_lw_arr"],
        planck_hl=go.planck_hl,
        lw_emission=go.lw_emission * (1.0 - op["lw_albedo_g"]),
        lw_emissivity=1.0 - op["lw_albedo_g"],
        cloud_fraction=op["frac"])
    for band in ("sw", "lw"):
        got[f"od_{band}_cloud"] = op["cl"][f"od_{band}"]
        got[f"ssa_{band}_cloud"] = op["cl"][f"ssa_{band}"]
        got[f"asymmetry_{band}_cloud"] = op["cl"][f"g_{band}"]
    return got, {k: np.asarray(v) for k, v in ref.items()}


GROUPS = {
    "rrtmg_sw": ("od_sw", "ssa_sw", "incoming_sw"),
    "rrtmg_lw": ("od_lw", "planck_hl", "lw_emission"),
    "aerosol": ("asymmetry_sw", "ssa_lw", "asymmetry_lw"),
    "cloud": ("cloud_fraction", "od_sw_cloud", "ssa_sw_cloud",
              "asymmetry_sw_cloud", "od_lw_cloud", "ssa_lw_cloud",
              "asymmetry_lw_cloud"),
    "surface": ("sw_albedo", "sw_albedo_direct", "lw_emissivity"),
}


def test_all_fields_covered(both):
    got, ref = both
    assert set(got) == set(ref)
    assert set(sum(GROUPS.values(), ())) == set(ref)


@pytest.mark.parametrize("group", list(GROUPS))
def test_optical_properties_match_jax(both, group):
    got, ref = both
    for name in GROUPS[group]:
        g = got[name].numpy()
        assert g.shape == ref[name].shape, name
        np.testing.assert_allclose(g, ref[name], rtol=RTOL, atol=0,
                                   err_msg=name)
    if group == "aerosol":
        # the aerosol merge really acted on the SW asymmetry
        assert np.abs(ref["asymmetry_sw"]).max() > 0.1
