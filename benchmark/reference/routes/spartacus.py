"""The SPARTACUS route: ecRad's 3D cloud solvers
(``solvers/spartacus_sw.py``, ``solvers/spartacus_lw.py``) in both band
sets, on the columns' cloud effective sizes (``inv_cloud_effective_size``
and ``inv_inhom_effective_size`` in ``cloud``, which the benchmark's inputs
derive from a configuration's ``driver`` group).  No McICA sample.
"""

from __future__ import annotations

from benchmark.reference.config import Config, GasModel
from benchmark.reference.solvers.spartacus_lw import solver_spartacus_lw
from benchmark.reference.solvers.spartacus_sw import solver_spartacus_sw

NEEDS_SAMPLE = False


def check_supported(config: Config):
    """The solvers on a gas model's own g order (ecCKD: RRTMG's SPARTACUS
    reorders its g-points by optical depth, which this route does not),
    three regions, broadband flux output, the SW gases not delta-scaled."""
    if GasModel.RRTMG in (config.gas_model_sw, config.gas_model_lw):
        raise NotImplementedError("the reference's SPARTACUS route does not "
                                  "reorder RRTMG's g-points")
    if (config.nregions != 3 or config.do_save_spectral_flux
            or config.do_save_gpoint_flux
            or config.do_sw_delta_scaling_with_gases):
        raise NotImplementedError("the reference's SPARTACUS route takes "
                                  "three regions and broadband output, "
                                  "without delta scaling of the SW gases")


def solve(config: Config, tables, op, cloud, cos_sza):
    """(LwFluxes, SwFluxes) of both band sets."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    geometry = (frac, cloud["fractional_std"], cloud["overlap_param"],
                cloud["inv_cloud_effective_size"],
                cloud.get("inv_inhom_effective_size"),
                op["pressure_hl"], op["temperature_hl"])
    lw_albedo_g = op["lw_albedo_g"]
    lw = solver_spartacus_lw(
        config, op["od_lw"], op["ssa_lw"], op["g_lw_arr"], cl["od_lw"],
        cl["ssa_lw"], cl["g_lw"], tables.band_from_g_lw, *geometry,
        go.planck_hl, go.lw_emission * (1.0 - lw_albedo_g), lw_albedo_g)
    sw = solver_spartacus_sw(
        config, op["od_sw"], op["ssa_sw"], op["g_sw_arr"], cl["od_sw"],
        cl["ssa_sw"], cl["g_sw"], tables.band_from_g_sw, *geometry,
        go.incoming_sw, cos_sza, op["sw_albedo_diffuse_g"],
        op["sw_albedo_direct_g"])
    return lw, sw
