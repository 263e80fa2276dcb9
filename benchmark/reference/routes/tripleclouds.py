"""The Tripleclouds route: ecRad's Tripleclouds solvers
(``solvers/tripleclouds_sw.py``, ``solvers/tripleclouds_lw.py``) in both
band sets, on the regions the columns' cloud fraction, fractional std and
overlap parameter make.  No McICA sample.
"""

from __future__ import annotations

from benchmark.reference.config import Config
from benchmark.reference.solvers.tripleclouds_lw import (
    solver_tripleclouds_lw)
from benchmark.reference.solvers.tripleclouds_sw import (
    solver_tripleclouds_sw)

NEEDS_SAMPLE = False


def check_supported(config: Config):
    """Three regions, broadband flux output, the SW gases not
    delta-scaled, the LW aerosols absorbing only."""
    if (config.nregions != 3 or config.do_save_spectral_flux
            or config.do_save_gpoint_flux
            or config.do_sw_delta_scaling_with_gases
            or config.do_lw_aerosol_scattering):
        raise NotImplementedError("the reference's Tripleclouds route takes "
                                  "three regions and broadband output, "
                                  "without delta scaling of the SW gases "
                                  "or LW aerosol scattering")


def solve(config: Config, tables, op, cloud, cos_sza):
    """(LwFluxes, SwFluxes) of both band sets."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    regions = (frac, cloud["fractional_std"], cloud["overlap_param"])
    lw_albedo_g = op["lw_albedo_g"]
    lw = solver_tripleclouds_lw(
        config, op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
        cl["ssa_lw"], cl["g_lw"], tables.band_from_g_lw, *regions,
        go.planck_hl, go.lw_emission * (1.0 - lw_albedo_g), lw_albedo_g)
    sw = solver_tripleclouds_sw(
        config, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
        cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw, *regions,
        go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
        op["sw_albedo_direct_g"])
    return lw, sw
