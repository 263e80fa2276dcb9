"""Radiation scheme orchestration (port of ``ecrad_tpu/interface.py``
for the RRTMG configurations with McICA and Tripleclouds solvers).

Equivalent of radiation/radiation_interface.F90: ``setup_radiation``
(host-side: loads the LUTs, computes the spectral mappings, and returns
the consolidated Config plus a :class:`Tables` of torch tensors on one
device) and ``radiation`` (gas optics, aerosol, cloud optics, McICA and
Tripleclouds solvers).  Configurations outside the port's slice raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ecrad_torch import constants
from ecrad_torch.config import Config, GasModel, PdfShape, Solver
from ecrad_torch.containers import Flux
from ecrad_torch.data import find_data_file
from ecrad_torch.optics import aerosol as aerosol_mod
from ecrad_torch.optics import cloud as cloud_optics_mod
from ecrad_torch.optics import rrtmg, rrtmg_data
from ecrad_torch.solvers import mcica, tripleclouds
from ecrad_torch.solvers.cloud_generator import fit_pdf_cheb


class Tables(NamedTuple):
    """Setup-time derived arrays, as tensors on one device (integer
    index arrays int64, everything else in the working dtype; scalars
    stay Python numbers)."""
    gas: Dict                                  # {"rrtmg": tables}
    sw_albedo_weights: torch.Tensor            # (nalbedo, nbands_sw)
    lw_emiss_weights: torch.Tensor             # (nemiss, nbands_lw)
    i_albedo_from_band_sw: Optional[torch.Tensor]
    i_emiss_from_band_lw: Optional[torch.Tensor]
    band_from_g_sw: torch.Tensor               # (n_g_sw,) 0-based
    band_from_g_lw: torch.Tensor
    cloud: Optional[Dict] = None               # cloud-optics tables
    aerosol: Optional[Dict] = None             # aerosol-optics tables
    pdf_sampler: Optional[Dict] = None         # McICA PDF LUT + fit


def _to_tensors(x, device, dtype):
    """Arrays -> tensors (float in ``dtype``, integers int64, bool as
    is); 0-d arrays -> Python scalars; dicts recursively; other leaves
    unchanged.  Accepts anything with ``__array__``."""
    if isinstance(x, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str, tuple)):
        return x
    a = np.asarray(x)
    if a.ndim == 0:
        return a.item()
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def tables_from_numpy(jax_tables, device, dtype) -> Tables:
    """The JAX package's ``Tables`` (numpy or jnp leaves) as the port's
    Tables: same leaves, converted with ``np.asarray``.  The TPU-only
    level windows (``gas["rrtmg"]["windows"]``) are dropped."""
    kw = {}
    for name in Tables._fields:
        value = getattr(jax_tables, name)
        if name == "gas":
            value = {k: {kk: vv for kk, vv in v.items() if kk != "windows"}
                     for k, v in value.items()}
        kw[name] = _to_tensors(value, device, dtype)
    return Tables(**kw)


def _check_supported(config: Config):
    """The configurations this port covers."""
    if (config.gas_model_sw != GasModel.RRTMG
            or config.gas_model_lw != GasModel.RRTMG):
        raise NotImplementedError("the port has RRTMG gas optics only")
    ported = (Solver.MCICA, Solver.TRIPLECLOUDS)
    if (config.do_sw and config.sw_solver not in ported) or (
            config.do_lw and config.lw_solver not in ported):
        raise NotImplementedError(
            "the port has the McICA and Tripleclouds solvers only")
    if config.use_general_cloud_optics:
        raise NotImplementedError("general cloud optics are not ported")
    for flag in ("use_spectral_solar_scaling", "use_spectral_solar_cycle",
                 "do_save_spectral_flux", "do_save_gpoint_flux",
                 "do_toa_spectral_flux"):
        if getattr(config, flag):
            raise NotImplementedError(f"{flag} is not ported")


def setup_radiation(config: Config, device, dtype, data_dir: str = None):
    """Host-side setup (radiation_interface.F90:37-156) for the RRTMG +
    SOCRATES/Fu + general aerosol + McICA configurations.

    data_dir overrides config.directory_name for locating optics files.
    Returns (consolidated config, Tables on ``device`` in ``dtype``).
    """
    _check_supported(config)
    gas_rrtmg = rrtmg.setup_tables()
    ddir = data_dir or config.directory_name

    # --- band structure (radiation_ifs_rrtm.F90:106-115,151-152): RRTMG
    # supports only band-wise cloud/aerosol/surface optics
    kw = dict(n_g_sw=rrtmg_data.NG_SW, n_bands_sw=rrtmg_data.NBANDS_SW,
              do_cloud_aerosol_per_sw_g_point=False,
              n_g_lw=rrtmg_data.NG_LW, n_bands_lw=rrtmg_data.NBANDS_LW,
              do_cloud_aerosol_per_lw_g_point=False)
    band_from_g_sw = gas_rrtmg["sw_band_from_g"]
    band_from_g_lw = gas_rrtmg["lw_band_from_g"]
    wn1_sw, wn2_sw = rrtmg_data.SW_WAVENUM1, rrtmg_data.SW_WAVENUM2
    wn1_lw, wn2_lw = rrtmg_data.LW_WAVENUM1, rrtmg_data.LW_WAVENUM2
    from ecrad_torch.optics.spectral_def import SpectralDefinition
    specdef_sw = SpectralDefinition.bands_only(wn1_sw, wn2_sw,
                                               is_solar=True)
    specdef_lw = SpectralDefinition.bands_only(wn1_lw, wn2_lw,
                                               is_solar=False)
    config = config.replace(**kw)

    # --- surface albedo/emissivity interval consolidation
    # (radiation_config.F90:1947-2103)
    i_sw_idx = [i for i in config.i_sw_albedo_index if i and i > 0] or [1]
    sw_bounds = list(config.sw_albedo_wavelength_bound[:len(i_sw_idx) - 1])
    sw_albedo_weights = specdef_sw.calc_mapping_from_bands(
        sw_bounds, i_sw_idx, use_bands=True)
    kw["n_albedo_intervals"] = int(max(i_sw_idx))
    kw["n_canopy_bands_sw"] = (kw["n_g_sw"]
                               if config.use_canopy_full_spectrum_sw
                               else int(max(i_sw_idx)))
    i_albedo_from_band_sw = (np.argmax(sw_albedo_weights, axis=0)
                             if config.do_nearest_spectral_sw_albedo
                             else None)

    i_lw_idx = [i for i in config.i_lw_emiss_index if i and i > 0] or [1]
    lw_bounds = list(config.lw_emiss_wavelength_bound[:len(i_lw_idx) - 1])
    lw_emiss_weights = specdef_lw.calc_mapping_from_bands(
        lw_bounds, i_lw_idx, use_bands=True)
    kw["n_emiss_intervals"] = int(max(i_lw_idx))
    kw["n_canopy_bands_lw"] = (kw["n_g_lw"]
                               if config.use_canopy_full_spectrum_lw
                               else int(max(i_lw_idx)))
    i_emiss_from_band_lw = (np.argmax(lw_emiss_weights, axis=0)
                            if config.do_nearest_spectral_lw_emiss
                            else None)

    kw["do_clouds"] = True
    kw["is_homogeneous"] = False
    kw["is_consolidated"] = True

    # --- cloud optics + McICA PDF LUT
    cloud_tables = cloud_optics_mod.setup_cloud_optics(config, ddir)
    from ecrad_torch.io.netcdf import NcFile
    if config.cloud_pdf_override_file_name:
        pdf_file = config.cloud_pdf_override_file_name
    elif config.cloud_pdf_shape == PdfShape.GAMMA:
        pdf_file = "mcica_gamma.nc"
    else:
        pdf_file = "mcica_lognormal.nc"
    with NcFile(find_data_file(ddir, pdf_file)) as f:
        pdf_tables = {"fsd": f.get("fsd"), "val": f.get("x").T}
    pdf_tables["cheb_fit"] = fit_pdf_cheb(pdf_tables)

    aerosol_tables = None
    if config.use_aerosols and config.aerosol_type_name:
        raise NotImplementedError(
            "name-based aerosol type selection is not ported; give "
            "i_aerosol_type_map")
    if config.use_aerosols and config.n_aerosol_types > 0:
        aerosol_tables = aerosol_mod.setup_aerosol_optics(
            config, ddir, wn1_sw, wn2_sw, wn1_lw, wn2_lw)

    new_config = config.replace(**kw)
    host = Tables(
        gas={"rrtmg": gas_rrtmg},
        sw_albedo_weights=sw_albedo_weights,
        lw_emiss_weights=lw_emiss_weights,
        i_albedo_from_band_sw=i_albedo_from_band_sw,
        i_emiss_from_band_lw=i_emiss_from_band_lw,
        band_from_g_sw=band_from_g_sw,
        band_from_g_lw=band_from_g_lw,
        cloud=cloud_tables,
        aerosol=aerosol_tables,
        pdf_sampler=pdf_tables,
    )
    return new_config, tables_from_numpy(host, device, dtype)


# ---------------------------------------------------------------------------

def get_albedos(config: Config, tables: Tables, sw_albedo,
                sw_albedo_direct, lw_emissivity):
    """Surface albedo/emissivity intervals -> per-g-point values
    (radiation_single_level.F90:216-372)."""
    band_g_sw = tables.band_from_g_sw
    band_g_lw = tables.band_from_g_lw

    if config.do_nearest_spectral_sw_albedo:
        idx = tables.i_albedo_from_band_sw[band_g_sw]
        sw_albedo_diffuse_g = sw_albedo[:, idx]
        sw_albedo_direct_g = (sw_albedo_direct[:, idx]
                              if sw_albedo_direct is not None
                              else sw_albedo_diffuse_g)
    else:
        w = tables.sw_albedo_weights                    # (nalb, nband)
        sw_albedo_diffuse_g = (sw_albedo @ w)[:, band_g_sw]
        sw_albedo_direct_g = ((sw_albedo_direct @ w)[:, band_g_sw]
                              if sw_albedo_direct is not None
                              else sw_albedo_diffuse_g)

    if config.do_nearest_spectral_lw_emiss:
        idx = tables.i_emiss_from_band_lw[band_g_lw]
        lw_albedo_g = 1.0 - lw_emissivity[:, idx]
    else:
        w = tables.lw_emiss_weights
        lw_albedo_g = ((1.0 - lw_emissivity) @ w)[:, band_g_lw]

    return sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g


def indexed_sum_g(x_g, band_from_g, nbands: int):
    """Sum a g-point array into bands along the last axis
    (radiation_flux.F90 indexed_sum); band_from_g 0-based.  A 0/1 matrix
    product, which sums in a fixed order on every device."""
    bands = torch.arange(nbands, dtype=torch.int64, device=x_g.device)
    onehot = (band_from_g[:, None] == bands[None, :]).to(x_g.dtype)
    return x_g @ onehot


def _optical_properties(config: Config, tables: Tables, *,
                        pressure_hl, temperature_hl, gas_mmr,
                        cos_sza, skin_temperature, sw_albedo,
                        sw_albedo_direct, lw_emissivity,
                        solar_irradiance, cloud=None, aerosol=None):
    """Surface + gas + aerosol + cloud optical properties — the front
    half of radiation() (radiation_interface.F90:200-383)."""
    _check_supported(config)
    sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g = get_albedos(
        config, tables, sw_albedo, sw_albedo_direct, lw_emissivity)

    gdict = {name: gas_mmr[:, :, constants.GAS_INDEX[name]]
             for name in ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12",
                          "hcfc22", "ccl4", "o3")}
    go = rrtmg.gas_optics(
        tables.gas["rrtmg"], pressure_hl, temperature_hl, gdict,
        cos_sza=cos_sza, do_lw=config.do_lw, do_sw=config.do_sw,
        skin_temperature=skin_temperature,
        solar_irradiance=solar_irradiance,
        min_gas_od_lw=config.min_gas_od_lw,
        min_gas_od_sw=config.min_gas_od_sw)

    od_lw, planck_hl = go.od_lw, go.planck_hl
    od_sw, ssa_sw = go.od_sw, go.ssa_sw
    ssa_lw = g_lw_arr = g_sw_arr = None
    if config.do_lw:
        ssa_lw = torch.zeros_like(od_lw)
        g_lw_arr = torch.zeros_like(od_lw)
    if config.do_sw:
        g_sw_arr = torch.zeros_like(od_sw)

    if config.use_aerosols and aerosol is not None:
        if "od_sw" in aerosol:
            raise NotImplementedError(
                "directly specified aerosol optics are not ported")
        if tables.aerosol is not None:
            # RH-dependent aerosol merge (radiation_aerosol_optics.F90:487+)
            p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
            t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
            h2o_mmr = gas_mmr[:, :, constants.GAS_INDEX["h2o"]]
            rh = h2o_mmr / aerosol_mod.h2o_sat_liq(p_fl, t_fl)
            aer = aerosol_mod.aerosol_band_properties(
                config, tables.aerosol, pressure_hl,
                aerosol["mixing_ratio"], rh)
            od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr = \
                aerosol_mod.add_aerosol_optics(
                    config, aer, tables.band_from_g_sw,
                    tables.band_from_g_lw, od_sw, ssa_sw, g_sw_arr, od_lw,
                    ssa_lw, g_lw_arr)

    # --- cloud optics (radiation_interface.F90:357-383)
    do_clouds = config.do_clouds and cloud is not None
    frac = cl = None
    if do_clouds:
        # crop_cloud_fraction (radiation_cloud.F90)
        total_water = cloud["q_liq"] + cloud["q_ice"]
        keep = ((cloud["fraction"] >= config.cloud_fraction_threshold)
                & (total_water >= config.cloud_mixing_ratio_threshold))
        frac = torch.where(keep, cloud["fraction"],
                           torch.zeros_like(cloud["fraction"]))
        cl = cloud_optics_mod.cloud_optics(
            config, tables.cloud, pressure_hl, temperature_hl,
            frac, cloud["q_liq"], cloud["q_ice"],
            cloud["re_liq"], cloud["re_ice"])

    return dict(
        sw_albedo_direct_g=sw_albedo_direct_g,
        sw_albedo_diffuse_g=sw_albedo_diffuse_g,
        lw_albedo_g=lw_albedo_g, go=go,
        od_lw=od_lw, ssa_lw=ssa_lw, g_lw_arr=g_lw_arr,
        od_sw=od_sw, ssa_sw=ssa_sw, g_sw_arr=g_sw_arr,
        do_clouds=do_clouds, frac=frac, cl=cl)


def radiation(config: Config, tables: Tables, *,
              pressure_hl, temperature_hl, gas_mmr,
              cos_sza, skin_temperature, sw_albedo, sw_albedo_direct,
              lw_emissivity, solar_irradiance,
              cloud=None, aerosol=None) -> Flux:
    """The hot path (radiation_interface.F90:200-517) for the McICA and
    Tripleclouds configurations.

    gas_mmr: (ncol, nlev, NUM_GASES) mass mixing ratios in
    constants.GAS_NAMES order.  For a McICA solver cloud must carry the
    stochastic sample (od_scaling_*, total_cloud_cover_*; see
    pipeline.add_cloud_sample); Tripleclouds reads fractional_std and
    overlap_param.
    """
    op = _optical_properties(
        config, tables, pressure_hl=pressure_hl,
        temperature_hl=temperature_hl, gas_mmr=gas_mmr,
        cos_sza=cos_sza, skin_temperature=skin_temperature,
        sw_albedo=sw_albedo, sw_albedo_direct=sw_albedo_direct,
        lw_emissivity=lw_emissivity, solar_irradiance=solar_irradiance,
        cloud=cloud, aerosol=aerosol)
    go, frac, cl = op["go"], op["frac"], op["cl"]
    if not op["do_clouds"]:
        raise NotImplementedError("the cloudless solvers are not ported")
    flux_kw = {}

    if config.do_lw:
        lw_albedo_g = op["lw_albedo_g"]
        lw_emission = go.lw_emission * (1.0 - lw_albedo_g)
        if config.lw_solver == Solver.TRIPLECLOUDS:
            lw = tripleclouds.solver_tripleclouds_lw(
                config, op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                tables.band_from_g_lw, frac, cloud["fractional_std"],
                cloud["overlap_param"], go.planck_hl, lw_emission,
                lw_albedo_g)
        else:
            lw = mcica.solver_mcica_lw(
                op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
                cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
                tables.band_from_g_lw,
                cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
                frac, go.planck_hl, lw_emission, lw_albedo_g,
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_lw_cloud_scattering=config.do_lw_cloud_scattering,
                do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
                do_lw_derivatives=config.do_lw_derivatives)
        flux_kw.update(
            lw_up=lw.flux_up, lw_dn=lw.flux_dn,
            lw_up_clear=lw.flux_up_clear, lw_dn_clear=lw.flux_dn_clear,
            cloud_cover_lw=lw.cloud_cover)
        if config.do_lw_derivatives:
            flux_kw["lw_derivatives"] = lw.lw_derivatives
        if config.do_canopy_fluxes_lw:
            lw_dn_surf_g = lw.lw_dn_surf_g
            if config.use_canopy_full_spectrum_lw:
                flux_kw["lw_dn_surf_canopy"] = lw_dn_surf_g
            elif config.do_nearest_spectral_lw_emiss:
                idx = tables.i_emiss_from_band_lw[tables.band_from_g_lw]
                flux_kw["lw_dn_surf_canopy"] = indexed_sum_g(
                    lw_dn_surf_g, idx, config.n_canopy_bands_lw)
            else:
                lw_dn_band = indexed_sum_g(
                    lw_dn_surf_g, tables.band_from_g_lw, config.n_bands_lw)
                flux_kw["lw_dn_surf_canopy"] = \
                    lw_dn_band @ tables.lw_emiss_weights.T

    if config.do_sw:
        if config.sw_solver == Solver.TRIPLECLOUDS:
            # Tripleclouds sets the cloud cover of night columns too
            sw = tripleclouds.solver_tripleclouds_sw(
                config, op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                tables.band_from_g_sw, frac, cloud["fractional_std"],
                cloud["overlap_param"], go.incoming_sw, cos_sza,
                op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"])
        else:
            sw = mcica.solver_mcica_sw(
                op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
                cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
                tables.band_from_g_sw,
                cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
                frac, go.incoming_sw, cos_sza,
                op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
                cloud_fraction_threshold=config.cloud_fraction_threshold,
                do_sw_delta_scaling_with_gases=(
                    config.do_sw_delta_scaling_with_gases))
        flux_kw.update(
            sw_up=sw.flux_up, sw_dn=sw.flux_dn,
            sw_dn_direct=sw.flux_dn_direct,
            sw_up_clear=sw.flux_up_clear, sw_dn_clear=sw.flux_dn_clear,
            sw_dn_direct_clear=sw.flux_dn_direct_clear,
            cloud_cover_sw=sw.cloud_cover)

        bfg = tables.band_from_g_sw
        nb = config.n_bands_sw
        if config.do_surface_sw_spectral_flux:
            dir_band = indexed_sum_g(sw.sw_dn_direct_surf_g, bfg, nb)
            diff_band = indexed_sum_g(sw.sw_dn_diffuse_surf_g, bfg, nb)
            flux_kw["sw_dn_direct_surf_band"] = dir_band
            flux_kw["sw_dn_surf_band"] = dir_band + diff_band
            dir_clear_band = indexed_sum_g(sw.sw_dn_direct_surf_clear_g,
                                           bfg, nb)
            diff_clear_band = indexed_sum_g(sw.sw_dn_diffuse_surf_clear_g,
                                            bfg, nb)
            flux_kw["sw_dn_surf_clear_band"] = (dir_clear_band
                                               + diff_clear_band)
            flux_kw["sw_dn_direct_surf_clear_band"] = dir_clear_band
        if config.do_canopy_fluxes_sw:
            if config.use_canopy_full_spectrum_sw:
                flux_kw["sw_dn_diffuse_surf_canopy"] = \
                    sw.sw_dn_diffuse_surf_g
                flux_kw["sw_dn_direct_surf_canopy"] = sw.sw_dn_direct_surf_g
            elif config.do_nearest_spectral_sw_albedo:
                idx = tables.i_albedo_from_band_sw[bfg]
                flux_kw["sw_dn_diffuse_surf_canopy"] = indexed_sum_g(
                    sw.sw_dn_diffuse_surf_g, idx, config.n_canopy_bands_sw)
                flux_kw["sw_dn_direct_surf_canopy"] = indexed_sum_g(
                    sw.sw_dn_direct_surf_g, idx, config.n_canopy_bands_sw)
            else:
                # weights-based canopy mapping (radiation_flux.F90:498-518)
                dir_band = indexed_sum_g(sw.sw_dn_direct_surf_g, bfg, nb)
                tot_band = dir_band + indexed_sum_g(
                    sw.sw_dn_diffuse_surf_g, bfg, nb)
                w = tables.sw_albedo_weights                 # (nalb, nband)
                canopy_dir = dir_band @ w.T
                flux_kw["sw_dn_direct_surf_canopy"] = canopy_dir
                flux_kw["sw_dn_diffuse_surf_canopy"] = (tot_band @ w.T
                                                       - canopy_dir)

    return Flux(**flux_kw)

