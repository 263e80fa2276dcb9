"""The McICA route: the fused McICA solvers (``solvers/mcica.py``) in both
band sets, on the stochastic cloud sample drawn from the columns' seeds.

With ``do_save_spectral_flux`` the solvers' per-g flux profiles, which
their plain sweeps compute, are summed over each band's g-points (a 0/1
matrix product in the reference's dtype) into the per-band profiles.
"""

from __future__ import annotations

from benchmark.reference.config import Config
from benchmark.reference.interface import band_map
from benchmark.reference.solvers import mcica

NEEDS_SAMPLE = True


def check_supported(config: Config):
    """The McICA solvers on their fused route: LW cloud scattering on, LW
    aerosol scattering off, no flux output per g-point."""
    if (config.do_save_gpoint_flux or config.do_lw_aerosol_scattering
            or not config.do_lw_cloud_scattering):
        raise NotImplementedError("the reference's McICA route covers the "
                                  "McICA configurations of the benchmark "
                                  "only")


def band_matrix(config: Config, band_from_g, nbands: int, dtype):
    """The 0/1 map of g-points to bands for the per-band profiles of
    do_save_spectral_flux, else None."""
    return (band_map(band_from_g, nbands, dtype)
            if config.do_save_spectral_flux else None)


def solve(config: Config, tables, op, cloud, cos_sza):
    """(LwFluxes, SwFluxes) of both band sets; ``cloud`` carries the McICA
    sample."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    dtype = op["od_lw"].dtype

    lw_albedo_g = op["lw_albedo_g"]
    lw_emission = go.lw_emission * (1.0 - lw_albedo_g)
    lw = mcica.solver_mcica_lw(
        op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
        cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
        tables.band_from_g_lw,
        cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
        frac, go.planck_hl, lw_emission, lw_albedo_g,
        cloud_fraction_threshold=config.cloud_fraction_threshold,
        do_lw_cloud_scattering=config.do_lw_cloud_scattering,
        do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
        do_lw_derivatives=config.do_lw_derivatives,
        spec_matrix=band_matrix(config, tables.band_from_g_lw,
                                config.n_bands_lw, dtype))

    sw = mcica.solver_mcica_sw(
        op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
        cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
        tables.band_from_g_sw,
        cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
        frac, go.incoming_sw, cos_sza,
        op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
        cloud_fraction_threshold=config.cloud_fraction_threshold,
        do_sw_delta_scaling_with_gases=(
            config.do_sw_delta_scaling_with_gases),
        spec_matrix=band_matrix(config, tables.band_from_g_sw,
                                config.n_bands_sw, dtype))
    return lw, sw
