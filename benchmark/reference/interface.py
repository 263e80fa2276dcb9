"""Radiation scheme orchestration for the benchmark's plain reference: a
frozen copy of the port's ``interface.py``, cut to what the benchmark's
configurations take (RRTMG or ecCKD gas optics, band-wise SOCRATES/Fu or
general cloud optics, general aerosols by type index, LW derivatives and
canopy fluxes); the solvers are a route found by name (``routes/``).

Equivalent of radiation/radiation_interface.F90: ``setup_radiation``
(host side: reads the tables from the data files, computes the spectral
mappings and returns the consolidated Config and a :class:`Tables` of
torch tensors on one device) and ``radiation`` (gas optics, aerosol,
cloud optics, the route's solvers, and the Flux fields of their outputs).
Anything else raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import constants
from benchmark.reference.config import Config, GasModel, PdfShape
from benchmark.reference.containers import Flux
from benchmark.reference.data import find_data_file
from benchmark.reference.optics import aerosol as aerosol_mod
from benchmark.reference.optics import cloud as cloud_optics_mod
from benchmark.reference.optics import ecckd as ecckd_mod
from benchmark.reference.optics import general_cloud as general_cloud_mod
from benchmark.reference.optics import rrtmg, rrtmg_data
from benchmark.reference.optics.spectral_def import SpectralDefinition

# The ecCKD definition files read unless the configuration names others
ECCKD_SW_FILE = "ecckd-1.4_sw_climate_rgb-32b_ckd-definition.nc"
ECCKD_LW_FILE = "ecckd-1.0_lw_climate_fsck-32b_ckd-definition.nc"


class Tables(NamedTuple):
    """Setup-time derived arrays, as tensors on one device (integer
    index arrays int64, everything else in the working dtype; scalars,
    strings and the ecCKD metadata stay Python values)."""
    gas: Optional[Dict]            # {"rrtmg": tables, "sw"/"lw": ecCKD}
    sw_albedo_weights: torch.Tensor            # (nalbedo, nbands_sw)
    lw_emiss_weights: torch.Tensor             # (nemiss, nbands_lw)
    i_albedo_from_band_sw: Optional[torch.Tensor]
    i_emiss_from_band_lw: Optional[torch.Tensor]
    band_from_g_sw: torch.Tensor               # (n_g_sw,) 0-based
    band_from_g_lw: torch.Tensor
    cloud: Optional[Dict] = None               # cloud-optics tables
    aerosol: Optional[Dict] = None             # aerosol-optics tables
    gas_meta: Optional[Dict] = None            # {"sw"/"lw": ecCKD meta}


def _to_tensors(x, device, dtype):
    """Arrays -> tensors (float in ``dtype``, integers int64, bool as
    is); 0-d arrays -> Python scalars; dicts and lists recursively; other
    leaves unchanged."""
    if isinstance(x, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_tensors(v, device, dtype) for v in x]
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


def _check_supported(config: Config):
    """What the shared part follows: RRTMG or ecCKD gas optics, both band
    sets, clouds on, no TOA spectral fluxes, no solar cycle or spectral
    solar scaling, aerosols by type index.  The route checks the rest."""
    if (GasModel.MONOCHROMATIC in (config.gas_model_sw, config.gas_model_lw)
            or config.do_toa_spectral_flux
            or config.use_spectral_solar_scaling
            or config.use_spectral_solar_cycle
            or config.aerosol_type_name
            or not (config.do_sw and config.do_lw)):
        raise NotImplementedError("the reference covers the configurations "
                                  "of the benchmark only")


def pdf_file_name(config: Config) -> str:
    """The McICA PDF table's file (radiation_config.F90 setup_pdf)."""
    if config.cloud_pdf_override_file_name:
        return config.cloud_pdf_override_file_name
    if config.cloud_pdf_shape == PdfShape.GAMMA:
        return "mcica_gamma.nc"
    return "mcica_lognormal.nc"


def crop_cloud_fraction(config: Config, cloud: dict):
    """The cloud fraction with layers below the fraction or total water
    thresholds cleared (radiation_cloud.F90 crop_cloud_fraction)."""
    total_water = cloud["q_liq"] + cloud["q_ice"]
    keep = ((cloud["fraction"] >= config.cloud_fraction_threshold)
            & (total_water >= config.cloud_mixing_ratio_threshold))
    return torch.where(keep, cloud["fraction"],
                       torch.zeros_like(cloud["fraction"]))


def _gas_model_setup(config: Config, band: str, ddir: str, gas_tables,
                     gas_meta):
    """One band set's gas model ("sw" or "lw"; radiation_interface.F90
    setup_radiation): returns (its Config fields, band_from_g (0-based),
    spectral definition); the model's tables go into gas_tables, an
    ecCKD model's metadata into gas_meta."""
    is_sw = band == "sw"
    model = config.gas_model_sw if is_sw else config.gas_model_lw
    if model == GasModel.RRTMG:
        # RRTMG supports only band-wise cloud/aerosol/surface optics, on a
        # band-bounds-only spectral definition
        # (radiation_ifs_rrtm.F90:106-115,151-159)
        if "rrtmg" not in gas_tables:
            gas_tables["rrtmg"] = rrtmg.setup_tables()
        if is_sw:
            ng, nb = rrtmg_data.NG_SW, rrtmg_data.NBANDS_SW
            wn = rrtmg_data.SW_WAVENUM1, rrtmg_data.SW_WAVENUM2
        else:
            ng, nb = rrtmg_data.NG_LW, rrtmg_data.NBANDS_LW
            wn = rrtmg_data.LW_WAVENUM1, rrtmg_data.LW_WAVENUM2
        return ({f"n_g_{band}": ng, f"n_bands_{band}": nb,
                 f"do_cloud_aerosol_per_{band}_g_point": False},
                gas_tables["rrtmg"][f"{band}_band_from_g"],
                SpectralDefinition.bands_only(*wn, is_solar=is_sw))
    override = (config.gas_optics_sw_override_file_name if is_sw
                else config.gas_optics_lw_override_file_name)
    default = ECCKD_SW_FILE if is_sw else ECCKD_LW_FILE
    tables, specdef, meta = ecckd_mod.load_ckd_model(
        find_data_file(ddir, override or default))
    gas_tables[band], gas_meta[band] = tables, meta
    per_g = getattr(config, f"do_cloud_aerosol_per_{band}_g_point")
    return ({f"n_g_{band}": specdef.ng,
             f"n_bands_{band}": specdef.ng if per_g else specdef.nband},
            np.arange(specdef.ng) if per_g else specdef.band_number,
            specdef)


def _surface_weights(specdef, bounds, idx, per_g):
    """The (n_intervals, nbands) surface albedo or emissivity weights
    (radiation_config.F90:1947-2103)."""
    return specdef.calc_mapping_from_bands(bounds, idx, use_bands=not per_g)


def setup_radiation(config: Config, route, device, dtype, data_dir: str):
    """Host-side setup (radiation_interface.F90:37-156): the gas model of
    each band set, the surface mappings, the cloud optics tables and the
    aerosol optics, read from the data files in ``data_dir``, for the
    solvers' ``route`` (``routes.find``).  Returns (consolidated config,
    Tables on ``device`` in ``dtype``)."""
    _check_supported(config)
    route.check_supported(config)
    ddir = data_dir

    # --- band structure, per band set
    gas_tables, gas_meta = {}, {}
    kw_sw, band_from_g_sw, specdef_sw = _gas_model_setup(
        config, "sw", ddir, gas_tables, gas_meta)
    kw_lw, band_from_g_lw, specdef_lw = _gas_model_setup(
        config, "lw", ddir, gas_tables, gas_meta)
    kw = {**kw_sw, **kw_lw}
    # the forced flags hold for the setup below
    config = config.replace(**kw)

    # --- surface albedo/emissivity interval consolidation
    # (radiation_config.F90:1947-2103), per band or per g-point
    i_sw_idx = [i for i in config.i_sw_albedo_index if i and i > 0] or [1]
    sw_bounds = list(config.sw_albedo_wavelength_bound[:len(i_sw_idx) - 1])
    sw_albedo_weights = _surface_weights(
        specdef_sw, sw_bounds, i_sw_idx,
        config.do_cloud_aerosol_per_sw_g_point)
    kw["n_albedo_intervals"] = int(max(i_sw_idx))
    kw["n_canopy_bands_sw"] = (kw["n_g_sw"]
                               if config.use_canopy_full_spectrum_sw
                               else int(max(i_sw_idx)))
    i_albedo_from_band_sw = (np.argmax(sw_albedo_weights, axis=0)
                             if config.do_nearest_spectral_sw_albedo
                             else None)

    i_lw_idx = [i for i in config.i_lw_emiss_index if i and i > 0] or [1]
    lw_bounds = list(config.lw_emiss_wavelength_bound[:len(i_lw_idx) - 1])
    lw_emiss_weights = _surface_weights(
        specdef_lw, lw_bounds, i_lw_idx,
        config.do_cloud_aerosol_per_lw_g_point)
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

    # --- cloud optics
    if config.use_general_cloud_optics:
        cloud_tables = general_cloud_mod.setup_general_cloud_optics(
            config, ddir, specdef_sw, specdef_lw)
        kw["n_cloud_types"] = len(cloud_tables["type_names"])
    else:
        if GasModel.ECCKD in (config.gas_model_sw, config.gas_model_lw):
            raise NotImplementedError(
                "the band-wise cloud optics take RRTMG bands; use general "
                "cloud optics with ecCKD")
        cloud_tables = cloud_optics_mod.setup_cloud_optics(config, ddir)

    aerosol_tables = None
    if config.use_aerosols and config.n_aerosol_types > 0:
        wn = [w for d in (specdef_sw, specdef_lw)
              for w in (d.wavenumber1_band, d.wavenumber2_band)]
        aerosol_tables = aerosol_mod.setup_aerosol_optics(
            config, ddir, *wn, specdef_sw=specdef_sw, specdef_lw=specdef_lw)

    new_config = config.replace(**kw)
    host = dict(
        gas=gas_tables,
        sw_albedo_weights=sw_albedo_weights,
        lw_emiss_weights=lw_emiss_weights,
        i_albedo_from_band_sw=i_albedo_from_band_sw,
        i_emiss_from_band_lw=i_emiss_from_band_lw,
        band_from_g_sw=band_from_g_sw,
        band_from_g_lw=band_from_g_lw,
        cloud=cloud_tables,
        aerosol=aerosol_tables,
        gas_meta=gas_meta,
    )
    return new_config, Tables(**{k: _to_tensors(v, device, dtype)
                                 for k, v in host.items()})


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


def band_map(band_from_g, nbands: int, dtype):
    """The (ng, nbands) 0/1 matrix of g-points to their bands; band_from_g
    0-based."""
    bands = torch.arange(nbands, dtype=torch.int64,
                         device=band_from_g.device)
    return (band_from_g[:, None] == bands[None, :]).to(dtype)


def indexed_sum_g(x_g, band_from_g, nbands: int):
    """Sum a g-point array into bands along the last axis
    (radiation_flux.F90 indexed_sum); band_from_g 0-based.  A 0/1 matrix
    product, which sums in a fixed order on every device."""
    return x_g @ band_map(band_from_g, nbands, x_g.dtype)


def _ecckd_gas_optics(config: Config, tables: Tables, pressure_hl,
                      temperature_hl, gdict, cos_sza, skin_temperature,
                      solar_irradiance):
    """The ecCKD gas optics of the band sets that use it
    (radiation_ecckd_interface.F90:174-340), as RRTMGGasOptics fields:
    pressure-weighted full-level temperature, gases as volume mixing
    ratios; the LW optical depth floored at min_gas_od_lw, the SW one not
    (ssa is the Rayleigh share), the incoming flux 0 where the sun is
    down."""
    phl, thl = pressure_hl, temperature_hl
    t_fl = ((thl[:, :-1] * phl[:, :-1] + thl[:, 1:] * phl[:, 1:])
            / (phl[:, :-1] + phl[:, 1:]))
    gas_vmr = {name: mmr * (constants.MOLAR_MASS_DRY_AIR
                            / constants.MOLAR_MASS[name])
               for name, mmr in gdict.items()}
    out = {}
    if config.gas_model_sw == GasModel.ECCKD:
        t, meta = tables.gas["sw"], tables.gas_meta["sw"]
        od, ray = ecckd_mod.calc_optical_depth(t, meta, phl, t_fl, gas_vmr)
        od = od + ray
        inc = ecckd_mod.calc_incoming_sw(t, solar_irradiance, phl.shape[0],
                                         solar_cycle_multiplier=0.0)
        out.update(od_sw=od, ssa_sw=ray / od,
                   incoming_sw=torch.where((cos_sza > 0.0)[:, None], inc,
                                           torch.zeros_like(inc)))
    if config.gas_model_lw == GasModel.ECCKD:
        t, meta = tables.gas["lw"], tables.gas_meta["lw"]
        od, _ = ecckd_mod.calc_optical_depth(t, meta, phl, t_fl, gas_vmr)
        out.update(od_lw=torch.clamp(od, min=config.min_gas_od_lw),
                   planck_hl=ecckd_mod.calc_planck(t, meta, thl),
                   lw_emission=ecckd_mod.calc_planck(t, meta,
                                                     skin_temperature))
    return out


def optical_properties(config: Config, tables: Tables, *,
                       pressure_hl, temperature_hl, gas_mmr,
                       cos_sza, skin_temperature, sw_albedo,
                       sw_albedo_direct, lw_emissivity,
                       solar_irradiance, cloud, aerosol=None):
    """Surface + gas + aerosol + cloud optical properties — the front
    half of radiation() (radiation_interface.F90:200-383), with the
    half-level pressure and temperature beside them for the routes that
    read the layers' geometry."""
    _check_supported(config)
    sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g = get_albedos(
        config, tables, sw_albedo, sw_albedo_direct, lw_emissivity)

    gdict = {name: gas_mmr[:, :, constants.GAS_INDEX[name]]
             for name in ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12",
                          "hcfc22", "ccl4", "o3")}
    go_kw = {}
    do_lw_rrtmg = config.gas_model_lw == GasModel.RRTMG
    do_sw_rrtmg = config.gas_model_sw == GasModel.RRTMG
    if do_lw_rrtmg or do_sw_rrtmg:
        r = rrtmg.gas_optics(
            tables.gas["rrtmg"], pressure_hl, temperature_hl, gdict,
            cos_sza=cos_sza, do_lw=do_lw_rrtmg, do_sw=do_sw_rrtmg,
            skin_temperature=skin_temperature,
            solar_irradiance=solar_irradiance,
            min_gas_od_lw=config.min_gas_od_lw,
            min_gas_od_sw=config.min_gas_od_sw,
            spectral_solar_scaling=None)
        if do_lw_rrtmg:
            go_kw.update(od_lw=r.od_lw, planck_hl=r.planck_hl,
                         lw_emission=r.lw_emission)
        if do_sw_rrtmg:
            go_kw.update(od_sw=r.od_sw, ssa_sw=r.ssa_sw,
                         incoming_sw=r.incoming_sw)
    if GasModel.ECCKD in (config.gas_model_sw, config.gas_model_lw):
        go_kw.update(_ecckd_gas_optics(
            config, tables, pressure_hl, temperature_hl, gdict, cos_sza,
            skin_temperature, solar_irradiance))
    go = rrtmg.RRTMGGasOptics(**go_kw)

    od_lw, planck_hl = go.od_lw, go.planck_hl
    od_sw, ssa_sw = go.od_sw, go.ssa_sw
    ssa_lw = torch.zeros_like(od_lw)
    g_lw_arr = torch.zeros_like(od_lw)
    g_sw_arr = torch.zeros_like(od_sw)

    if config.use_aerosols and aerosol is not None \
            and tables.aerosol is not None:
        # RH-dependent aerosol merge (radiation_aerosol_optics.F90:487+)
        p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
        t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
        h2o_mmr = gas_mmr[:, :, constants.GAS_INDEX["h2o"]]
        rh = h2o_mmr / aerosol_mod.h2o_sat_liq(p_fl, t_fl)
        aer = aerosol_mod.aerosol_band_properties(
            config, tables.aerosol, pressure_hl, aerosol["mixing_ratio"], rh)
        od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr = \
            aerosol_mod.add_aerosol_optics(
                config, aer, tables.band_from_g_sw, tables.band_from_g_lw,
                od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr)

    # --- cloud optics (radiation_interface.F90:357-383)
    frac = crop_cloud_fraction(config, cloud)
    if config.use_general_cloud_optics:
        cl = general_cloud_mod.general_cloud_optics(
            config, tables.cloud, pressure_hl, frac,
            torch.stack([cloud["q_liq"], cloud["q_ice"]], dim=-1),
            torch.stack([cloud["re_liq"], cloud["re_ice"]], dim=-1))
    else:
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
        frac=frac, cl=cl, pressure_hl=pressure_hl,
        temperature_hl=temperature_hl)


def radiation(config: Config, tables: Tables, route, *,
              pressure_hl, temperature_hl, gas_mmr,
              cos_sza, skin_temperature, sw_albedo, sw_albedo_direct,
              lw_emissivity, solar_irradiance, cloud, aerosol=None) -> Flux:
    """The fluxes (radiation_interface.F90:200-517): the optical
    properties, the solvers of ``route`` (``routes.find``), and the Flux
    fields of their outputs.  gas_mmr: (ncol, nlev, NUM_GASES) mass mixing
    ratios in constants.GAS_NAMES order; ``cloud`` carries the stochastic
    sample where the route needs it (od_scaling_*, total_cloud_cover_*;
    see reference.step)."""
    op = optical_properties(
        config, tables, pressure_hl=pressure_hl,
        temperature_hl=temperature_hl, gas_mmr=gas_mmr,
        cos_sza=cos_sza, skin_temperature=skin_temperature,
        sw_albedo=sw_albedo, sw_albedo_direct=sw_albedo_direct,
        lw_emissivity=lw_emissivity, solar_irradiance=solar_irradiance,
        cloud=cloud, aerosol=aerosol)
    lw, sw = route.solve(config, tables, op, cloud, cos_sza)
    return Flux(**_lw_fluxes(config, tables, lw),
                **_sw_fluxes(config, tables, sw))


def _lw_fluxes(config: Config, tables: Tables, lw) -> dict:
    """The Flux fields of the LW solvers' output: profiles, cloud cover,
    derivatives, per-band profiles, canopy fluxes."""
    flux_kw = dict(
        lw_up=lw.flux_up, lw_dn=lw.flux_dn,
        lw_up_clear=lw.flux_up_clear, lw_dn_clear=lw.flux_dn_clear,
        cloud_cover_lw=lw.cloud_cover)
    if config.do_lw_derivatives:
        flux_kw["lw_derivatives"] = lw.lw_derivatives
    if lw.flux_up_s is not None:
        # per band, or per g-point with do_save_gpoint_flux
        flux_kw.update(lw_up_band=lw.flux_up_s, lw_dn_band=lw.flux_dn_s,
                       lw_up_clear_band=lw.flux_up_clear_s,
                       lw_dn_clear_band=lw.flux_dn_clear_s)
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
    return flux_kw


def _sw_fluxes(config: Config, tables: Tables, sw) -> dict:
    """The Flux fields of the SW solvers' output: profiles, cloud cover,
    per-band profiles, surface bands, canopy fluxes."""
    flux_kw = dict(
        sw_up=sw.flux_up, sw_dn=sw.flux_dn,
        sw_dn_direct=sw.flux_dn_direct,
        sw_up_clear=sw.flux_up_clear, sw_dn_clear=sw.flux_dn_clear,
        sw_dn_direct_clear=sw.flux_dn_direct_clear,
        cloud_cover_sw=sw.cloud_cover)
    if sw.flux_up_s is not None:
        flux_kw.update(sw_up_band=sw.flux_up_s, sw_dn_band=sw.flux_dn_s,
                       sw_dn_direct_band=sw.flux_dn_direct_s,
                       sw_up_clear_band=sw.flux_up_clear_s,
                       sw_dn_clear_band=sw.flux_dn_clear_s,
                       sw_dn_direct_clear_band=sw.flux_dn_direct_clear_s)

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
        flux_kw["sw_dn_surf_clear_band"] = dir_clear_band + diff_clear_band
        flux_kw["sw_dn_direct_surf_clear_band"] = dir_clear_band
    if config.do_canopy_fluxes_sw:
        if config.use_canopy_full_spectrum_sw:
            flux_kw["sw_dn_diffuse_surf_canopy"] = sw.sw_dn_diffuse_surf_g
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
    return flux_kw
