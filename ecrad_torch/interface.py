"""Radiation scheme orchestration (port of ``ecrad_tpu/interface.py``
for the RRTMG and ecCKD configurations, in either band, and monochromatic
optics, with the Cloudless, Homogeneous, McICA, Tripleclouds and
SPARTACUS solvers).

Equivalent of radiation/radiation_interface.F90: ``setup_radiation``
(host-side: loads the LUTs, computes the spectral mappings, and returns
the consolidated Config plus a :class:`Tables` of torch tensors on one
device) and ``radiation`` (gas optics, aerosol, cloud optics, the
solvers).  Configurations the JAX package rejects raise
NotImplementedError here too, and so do ecCKD gas optics with the
band-wise cloud optics, which the JAX package runs into non-finite
fluxes.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ecrad_torch import constants, kernels, profiling
from ecrad_torch.config import Config, GasModel, PdfShape, Solver
from ecrad_torch.containers import Flux
from ecrad_torch.data import find_data_file
from ecrad_torch.optics import aerosol as aerosol_mod
from ecrad_torch.optics import cloud as cloud_optics_mod
from ecrad_torch.optics import ecckd as ecckd_mod
from ecrad_torch.optics import general_cloud as general_cloud_mod
from ecrad_torch.optics import monochromatic as mono_mod
from ecrad_torch.optics import cuda_rrtmg, rrtmg, rrtmg_data
from ecrad_torch.optics.aerosol_description import resolve_aerosol_type_names
from ecrad_torch.optics.spectral_def import SpectralDefinition
from ecrad_torch.solvers import cloudless, mcica, spartacus, tripleclouds
from ecrad_torch.solvers.cloud_generator import fit_pdf_cheb

# The ecCKD definition files read unless the configuration names others
ECCKD_SW_FILE = "ecckd-1.4_sw_climate_rgb-32b_ckd-definition.nc"
ECCKD_LW_FILE = "ecckd-1.0_lw_climate_fsck-32b_ckd-definition.nc"


class Tables(NamedTuple):
    """Setup-time derived arrays, as tensors on one device (integer
    index arrays int64, everything else in the working dtype; scalars,
    strings and the ecCKD metadata stay Python values)."""
    gas: Optional[Dict]            # {"rrtmg": tables, "sw"/"lw": ecCKD};
    #                                None for monochromatic optics
    sw_albedo_weights: torch.Tensor            # (nalbedo, nbands_sw)
    lw_emiss_weights: torch.Tensor             # (nemiss, nbands_lw)
    i_albedo_from_band_sw: Optional[torch.Tensor]
    i_emiss_from_band_lw: Optional[torch.Tensor]
    band_from_g_sw: torch.Tensor               # (n_g_sw,) 0-based
    band_from_g_lw: torch.Tensor
    cloud: Optional[Dict] = None               # cloud-optics tables
    aerosol: Optional[Dict] = None             # aerosol-optics tables
    pdf_sampler: Optional[Dict] = None         # McICA PDF LUT + fit
    gas_meta: Optional[Dict] = None            # {"sw"/"lw": ecCKD meta}
    # the spectral definitions, host objects (the drivers' UV, PAR and
    # SW diagnostic mappings)
    specdef_sw: Optional[SpectralDefinition] = None
    specdef_lw: Optional[SpectralDefinition] = None


def _to_tensors(x, device, dtype):
    """Arrays -> tensors (float in ``dtype``, integers int64, bool as
    is); 0-d arrays -> Python scalars; dicts and lists recursively; other
    leaves unchanged.  Accepts anything with ``__array__``."""
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


def tables_from_numpy(jax_tables, device, dtype) -> Tables:
    """The JAX package's ``Tables`` (numpy or jnp leaves) as the port's
    Tables: same leaves, converted with ``np.asarray``.  The TPU-only
    level windows (``gas["rrtmg"]["windows"]``) are dropped, and so are
    the spectral definitions, which are host objects of the JAX
    package.  RRTMG tables without the kernels' packed buffers get them
    (``cuda_rrtmg.pack_tables``)."""
    kw = {}
    for name in Tables._fields:
        if name.startswith("specdef"):
            continue
        value = getattr(jax_tables, name)
        if name == "gas" and value is not None:
            value = {k: {kk: vv for kk, vv in v.items() if kk != "windows"}
                     for k, v in value.items()}
            rrtmg_tables = value.get("rrtmg")
            if rrtmg_tables is not None and "kernel:lw" not in rrtmg_tables:
                rrtmg_tables.update(cuda_rrtmg.pack_tables(rrtmg_tables))
        kw[name] = _to_tensors(value, device, dtype)
    return Tables(**kw)


def _check_supported(config: Config):
    """The configurations this port covers: what the JAX package covers
    (monochromatic optics in both band sets or in neither,
    ecrad_tpu/interface.py setup_radiation; every solver), and SPARTACUS
    with three regions only (the reference fixes NREG = 3)."""
    if (GasModel.MONOCHROMATIC in (config.gas_model_sw,
                                   config.gas_model_lw)
            and config.gas_model_sw != config.gas_model_lw):
        raise NotImplementedError(
            "monochromatic gas optics cannot be mixed with other models")
    if Solver.SPARTACUS in (config.sw_solver, config.lw_solver) \
            and config.nregions != 3:
        raise NotImplementedError("the port's SPARTACUS solvers take three "
                                  "regions only")


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
    spectral definition, None for monochromatic); the model's tables go
    into gas_tables, an ecCKD model's metadata into gas_meta."""
    is_sw = band == "sw"
    model = config.gas_model_sw if is_sw else config.gas_model_lw
    if model == GasModel.MONOCHROMATIC:
        # radiation_monochromatic.F90:20-40: one g-point, one band, no
        # tables and no spectral definition
        return ({f"n_g_{band}": 1, f"n_bands_{band}": 1,
                 f"do_cloud_aerosol_per_{band}_g_point": False},
                np.zeros(1, np.int32), None)
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
    if is_sw and config.use_spectral_solar_cycle:
        # radiation_config.F90:1200-1215 + radiation_ecckd.F90:295
        ecckd_mod.read_spectral_solar_cycle(
            tables, specdef,
            find_data_file(ddir, config.ssi_override_file_name
                           or "ssi_nrl2.nc"),
            use_updated_solar_spectrum=config.use_updated_solar_spectrum)
    gas_tables[band], gas_meta[band] = tables, meta
    per_g = getattr(config, f"do_cloud_aerosol_per_{band}_g_point")
    return ({f"n_g_{band}": specdef.ng,
             f"n_bands_{band}": specdef.ng if per_g else specdef.nband},
            np.arange(specdef.ng) if per_g else specdef.band_number,
            specdef)


def setup_radiation(config: Config, device, dtype, data_dir: str = None):
    """Host-side setup (radiation_interface.F90:37-156) for the RRTMG and
    ecCKD gas models (per band set) or monochromatic optics, band-wise or
    general cloud optics and general or legacy band-wise aerosols, their
    types given by index or by name, with the ported solvers.  Cloud
    tables load only when a solver needs clouds (never for monochromatic
    optics, which needs none), the McICA PDF table only when McICA is one
    of the solvers.

    data_dir overrides config.directory_name for locating optics files.
    Returns (consolidated config, Tables on ``device`` in ``dtype``).
    """
    _check_supported(config)
    if config.use_spectral_solar_cycle \
            and config.gas_model_sw != GasModel.ECCKD:
        # radiation_config.F90:1201-1203
        raise ValueError(
            "solar cycle only available with ecCKD gas optics model")
    ddir = data_dir or config.directory_name

    # --- band structure, per band set
    gas_tables, gas_meta = {}, {}
    with profiling.hook("radiation_interface:setup_gas_optics"):
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

    kw["do_clouds"] = not (config.sw_solver == Solver.CLOUDLESS
                           and config.lw_solver == Solver.CLOUDLESS)
    # radiation_config.F90:1351-1356
    kw["is_homogeneous"] = (
        (config.do_sw and config.sw_solver == Solver.HOMOGENEOUS)
        or (config.do_lw and config.lw_solver == Solver.HOMOGENEOUS))
    kw["is_consolidated"] = True

    # --- cloud optics + McICA PDF LUT
    cloud_tables = pdf_tables = None
    mono = config.gas_model_sw == GasModel.MONOCHROMATIC
    if mono:
        pass        # monochromatic cloud optics need no tables
    elif kw["do_clouds"] and config.use_general_cloud_optics:
        with profiling.hook("radiation_interface:setup_cloud_optics"):
            cloud_tables = general_cloud_mod.setup_general_cloud_optics(
                config, ddir, specdef_sw, specdef_lw)
        kw["n_cloud_types"] = len(cloud_tables["type_names"])
    elif kw["do_clouds"]:
        if GasModel.ECCKD in (config.gas_model_sw, config.gas_model_lw):
            raise NotImplementedError(
                "the band-wise cloud optics take RRTMG bands; use general "
                "cloud optics with ecCKD")
        with profiling.hook("radiation_interface:setup_cloud_optics"):
            cloud_tables = cloud_optics_mod.setup_cloud_optics(config, ddir)
    if kw["do_clouds"] and Solver.MCICA in (config.sw_solver,
                                             config.lw_solver):
        from ecrad_torch.io.netcdf import NcFile
        with profiling.hook("radiation_interface:setup_pdf_sampler"):
            with NcFile(find_data_file(ddir, pdf_file_name(config))) as f:
                pdf_tables = {"fsd": f.get("fsd"), "val": f.get("x").T}
            pdf_tables["cheb_fit"] = fit_pdf_cheb(pdf_tables)

    aerosol_tables = None
    if config.use_aerosols and config.aerosol_type_name:
        # resolve name-based selection against the optics file's metadata
        # registry (radiation_aerosol_optics_description.F90)
        kw["i_aerosol_type_map"] = resolve_aerosol_type_names(
            config.aerosol_type_name,
            aerosol_mod.aerosol_optics_path(config, ddir),
            config.aerosol_preferred_optical_model)
        kw["n_aerosol_types"] = len(kw["i_aerosol_type_map"])
        config = config.replace(
            i_aerosol_type_map=kw["i_aerosol_type_map"],
            n_aerosol_types=kw["n_aerosol_types"])
    if config.use_aerosols and config.n_aerosol_types > 0:
        # no band bounds without a spectral definition (monochromatic)
        wn = [w for d in (specdef_sw, specdef_lw)
              for w in ((None, None) if d is None
                        else (d.wavenumber1_band, d.wavenumber2_band))]
        with profiling.hook("radiation_interface:setup_aerosol_optics"):
            aerosol_tables = aerosol_mod.setup_aerosol_optics(
                config, ddir, *wn, specdef_sw=specdef_sw,
                specdef_lw=specdef_lw)

    new_config = config.replace(**kw)
    host = Tables(
        gas=None if mono else gas_tables,
        sw_albedo_weights=sw_albedo_weights,
        lw_emiss_weights=lw_emiss_weights,
        i_albedo_from_band_sw=i_albedo_from_band_sw,
        i_emiss_from_band_lw=i_emiss_from_band_lw,
        band_from_g_sw=band_from_g_sw,
        band_from_g_lw=band_from_g_lw,
        cloud=cloud_tables,
        aerosol=aerosol_tables,
        pdf_sampler=pdf_tables,
        gas_meta=gas_meta,
    )
    if torch.device(device).type == "cuda":
        kernels.library()       # built or loaded here, not in a first step
    return new_config, tables_from_numpy(host, device, dtype)._replace(
        specdef_sw=specdef_sw, specdef_lw=specdef_lw)


def _surface_weights(specdef, bounds, idx, per_g):
    """The (n_intervals, nbands) surface albedo or emissivity weights
    (radiation_config.F90:1947-2103); without a spectral definition
    (monochromatic optics) all the weight on the first interval."""
    if specdef is None:
        w = np.zeros((int(max(idx)), 1))
        w[0, 0] = 1.0
        return w
    return specdef.calc_mapping_from_bands(bounds, idx, use_bands=not per_g)


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


def spectral_matrix(config: Config, band_from_g, nbands: int, dtype):
    """The (ng, nspec) 0/1 projection of the per-g flux profiles for
    spectral flux output: the identity with do_save_gpoint_flux, the
    one-hot band map with do_save_spectral_flux, else None
    (radiation_config.F90 consolidate, i_spec_from_reordered_g)."""
    if config.do_save_gpoint_flux:
        ng = band_from_g.shape[0]
        return torch.eye(ng, dtype=dtype, device=band_from_g.device)
    if config.do_save_spectral_flux:
        bands = torch.arange(nbands, dtype=torch.int64,
                             device=band_from_g.device)
        return (band_from_g[:, None] == bands[None, :]).to(dtype)
    return None


def indexed_sum_g(x_g, band_from_g, nbands: int):
    """Sum a g-point array into bands along the last axis
    (radiation_flux.F90 indexed_sum); band_from_g 0-based.  A 0/1 matrix
    product, which sums in a fixed order on every device."""
    bands = torch.arange(nbands, dtype=torch.int64, device=x_g.device)
    onehot = (band_from_g[:, None] == bands[None, :]).to(x_g.dtype)
    return x_g @ onehot


def _ecckd_gas_optics(config: Config, tables: Tables, pressure_hl,
                      temperature_hl, gdict, cos_sza, skin_temperature,
                      solar_irradiance, spectral_solar_cycle_multiplier):
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
    if config.do_sw and config.gas_model_sw == GasModel.ECCKD:
        t, meta = tables.gas["sw"], tables.gas_meta["sw"]
        od, ray = ecckd_mod.calc_optical_depth(t, meta, phl, t_fl, gas_vmr)
        od = od + ray
        inc = ecckd_mod.calc_incoming_sw(
            t, solar_irradiance, phl.shape[0],
            solar_cycle_multiplier=(spectral_solar_cycle_multiplier
                                    if config.use_spectral_solar_cycle
                                    else 0.0))
        out.update(od_sw=od, ssa_sw=ray / od,
                   incoming_sw=torch.where((cos_sza > 0.0)[:, None], inc,
                                           torch.zeros_like(inc)))
    if config.do_lw and config.gas_model_lw == GasModel.ECCKD:
        t, meta = tables.gas["lw"], tables.gas_meta["lw"]
        od, _ = ecckd_mod.calc_optical_depth(t, meta, phl, t_fl, gas_vmr)
        out.update(od_lw=torch.clamp(od, min=config.min_gas_od_lw),
                   planck_hl=ecckd_mod.calc_planck(t, meta, thl),
                   lw_emission=ecckd_mod.calc_planck(t, meta,
                                                     skin_temperature))
    return out


def _gas_optics(config: Config, tables: Tables, pressure_hl,
                temperature_hl, gdict, cos_sza, skin_temperature,
                solar_irradiance, spectral_solar_scaling,
                spectral_solar_cycle_multiplier):
    """The gas optics of both band sets: RRTMG and/or ecCKD, possibly
    mixed per band set, or monochromatic (radiation_interface.F90
    gas_optics dispatch), as one RRTMGGasOptics."""
    go_kw = {}
    if config.gas_model_sw == GasModel.MONOCHROMATIC:
        m = mono_mod.gas_optics(config, pressure_hl, temperature_hl,
                                skin_temperature, solar_irradiance)
        go_kw = {k: m[k] for k in (
            *(("od_lw", "planck_hl", "lw_emission") if config.do_lw else ()),
            *(("od_sw", "ssa_sw", "incoming_sw") if config.do_sw else ()))}
    do_lw_rrtmg = config.do_lw and config.gas_model_lw == GasModel.RRTMG
    do_sw_rrtmg = config.do_sw and config.gas_model_sw == GasModel.RRTMG
    if do_lw_rrtmg or do_sw_rrtmg:
        r = rrtmg.gas_optics(
            tables.gas["rrtmg"], pressure_hl, temperature_hl, gdict,
            cos_sza=cos_sza, do_lw=do_lw_rrtmg, do_sw=do_sw_rrtmg,
            skin_temperature=skin_temperature,
            solar_irradiance=solar_irradiance,
            min_gas_od_lw=config.min_gas_od_lw,
            min_gas_od_sw=config.min_gas_od_sw,
            spectral_solar_scaling=(spectral_solar_scaling
                                    if config.use_spectral_solar_scaling
                                    else None))
        if do_lw_rrtmg:
            go_kw.update(od_lw=r.od_lw, planck_hl=r.planck_hl,
                         lw_emission=r.lw_emission)
        if do_sw_rrtmg:
            go_kw.update(od_sw=r.od_sw, ssa_sw=r.ssa_sw,
                         incoming_sw=r.incoming_sw)
    if GasModel.ECCKD in (config.gas_model_sw, config.gas_model_lw):
        go_kw.update(_ecckd_gas_optics(
            config, tables, pressure_hl, temperature_hl, gdict, cos_sza,
            skin_temperature, solar_irradiance,
            spectral_solar_cycle_multiplier))
    return rrtmg.RRTMGGasOptics(**go_kw)


def _aerosol_properties(config: Config, tables: Tables, pressure_hl,
                        temperature_hl, gas_mmr, aerosol):
    """The aerosols' band-wise optical properties, or None without
    aerosols: directly specified, or merged from mixing ratios and
    relative humidity (radiation_aerosol_optics.F90:487+)."""
    if not config.use_aerosols or aerosol is None:
        return None
    if "od_sw" in aerosol:
        return aerosol_mod.direct_aerosol_properties(config, aerosol)
    if tables.aerosol is None \
            or config.gas_model_sw == GasModel.MONOCHROMATIC:
        return None
    p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    h2o_mmr = gas_mmr[:, :, constants.GAS_INDEX["h2o"]]
    rh = h2o_mmr / aerosol_mod.h2o_sat_liq(p_fl, t_fl)
    return aerosol_mod.aerosol_band_properties(
        config, tables.aerosol, pressure_hl, aerosol["mixing_ratio"], rh)


def _cloud_optics(config: Config, tables: Tables, pressure_hl,
                  temperature_hl, frac, cloud):
    """In-cloud optical properties per band set
    (radiation_interface.F90:357-383): monochromatic, general or the
    band-wise liquid and ice models."""
    if config.gas_model_sw == GasModel.MONOCHROMATIC:
        return mono_mod.cloud_optics(
            config, pressure_hl, frac, cloud["q_liq"], cloud["q_ice"],
            cloud["re_liq"], cloud["re_ice"])
    if config.use_general_cloud_optics:
        return general_cloud_mod.general_cloud_optics(
            config, tables.cloud, pressure_hl, frac,
            torch.stack([cloud["q_liq"], cloud["q_ice"]], dim=-1),
            torch.stack([cloud["re_liq"], cloud["re_ice"]], dim=-1))
    return cloud_optics_mod.cloud_optics(
        config, tables.cloud, pressure_hl, temperature_hl,
        frac, cloud["q_liq"], cloud["q_ice"],
        cloud["re_liq"], cloud["re_ice"])


def _optical_properties(config: Config, tables: Tables, *,
                        pressure_hl, temperature_hl, gas_mmr,
                        cos_sza, skin_temperature, sw_albedo,
                        sw_albedo_direct, lw_emissivity,
                        solar_irradiance, cloud=None, aerosol=None,
                        spectral_solar_scaling=None,
                        spectral_solar_cycle_multiplier=0.0):
    """Surface + gas + aerosol + cloud optical properties — the front
    half of radiation() (radiation_interface.F90:200-383)."""
    _check_supported(config)
    with profiling.scope("ecrad.optics"):
        sw_albedo_direct_g, sw_albedo_diffuse_g, lw_albedo_g = get_albedos(
            config, tables, sw_albedo, sw_albedo_direct, lw_emissivity)
        gdict = {name: gas_mmr[:, :, constants.GAS_INDEX[name]]
                 for name in ("h2o", "co2", "ch4", "n2o", "cfc11", "cfc12",
                              "hcfc22", "ccl4", "o3")}
        with profiling.scope("ecrad.optics.gas"):
            go = _gas_optics(config, tables, pressure_hl, temperature_hl,
                             gdict, cos_sza, skin_temperature,
                             solar_irradiance, spectral_solar_scaling,
                             spectral_solar_cycle_multiplier)

        od_lw, od_sw, ssa_sw = go.od_lw, go.od_sw, go.ssa_sw
        ssa_lw = g_lw_arr = g_sw_arr = None
        if config.do_lw:
            ssa_lw = torch.zeros_like(od_lw)
            g_lw_arr = torch.zeros_like(od_lw)
        if config.do_sw:
            g_sw_arr = torch.zeros_like(od_sw)

        with profiling.scope("ecrad.optics.aerosol"):
            aer = _aerosol_properties(config, tables, pressure_hl,
                                      temperature_hl, gas_mmr, aerosol)
            if aer is not None:
                # the merge skips a band set that is off
                od_sw, ssa_sw, g_sw_arr, od_lw, ssa_lw, g_lw_arr = \
                    aerosol_mod.add_aerosol_optics(
                        config, aer, tables.band_from_g_sw,
                        tables.band_from_g_lw, od_sw, ssa_sw, g_sw_arr,
                        od_lw, ssa_lw, g_lw_arr)

        do_clouds = config.do_clouds and cloud is not None
        frac = cl = None
        with profiling.scope("ecrad.optics.cloud"):
            if do_clouds:
                frac = crop_cloud_fraction(config, cloud)
                cl = _cloud_optics(config, tables, pressure_hl,
                                   temperature_hl, frac, cloud)

    return dict(
        sw_albedo_direct_g=sw_albedo_direct_g,
        sw_albedo_diffuse_g=sw_albedo_diffuse_g,
        lw_albedo_g=lw_albedo_g, go=go,
        od_lw=od_lw, ssa_lw=ssa_lw, g_lw_arr=g_lw_arr,
        od_sw=od_sw, ssa_sw=ssa_sw, g_sw_arr=g_sw_arr,
        do_clouds=do_clouds, frac=frac, cl=cl)


# The span of the SPARTACUS g permutation: the g-dependent inputs taken into
# SPARTACUS order, and the solver's per-g outputs put back (two opens a band
# set)
REORDER = "ecrad.solvers.reorder"


def _spartacus_perm(config: Config, is_sw: bool) -> np.ndarray:
    """G-point permutation for SPARTACUS: RRTMG g-points reordered by
    approximately increasing optical depth (radiation_ifs_rrtm.F90:117-134);
    other gas models use natural order."""
    gm = config.gas_model_sw if is_sw else config.gas_model_lw
    if gm == GasModel.RRTMG:
        return (rrtmg_data.RRTM_GPOINT_REORDERING_SW if is_sw
                else rrtmg_data.RRTM_GPOINT_REORDERING_LW)
    return np.arange(config.n_g_sw if is_sw else config.n_g_lw)


@functools.lru_cache(maxsize=32)
def _index_on(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index on the device, copied there once per (values,
    device): a copy from the host on every call waits for the device's
    queue.  The callers only read it (the SPARTACUS g permutations and
    their inverses: four at most per device)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _perm_on(perm: np.ndarray, device) -> torch.Tensor:
    return _index_on(tuple(int(i) for i in perm), torch.device(device))


def _unpermute_g_fields(out, perm: np.ndarray):
    """Restore natural g order in a solver output's *_g fields so the
    generic band/canopy post-processing applies unchanged."""
    inv = None
    rep = {}
    for f in out._fields:
        v = getattr(out, f)
        if v is not None and f.endswith("_g"):
            if inv is None:
                inv = _perm_on(np.argsort(perm), v.device)
            rep[f] = v[..., inv]
    return out._replace(**rep)


def _spartacus_common(config, tables, is_sw, op, cloud):
    """The g permutation, a function applying it to the last axis, and the
    arguments that the two SPARTACUS solvers share (gas and cloud optics,
    permuted band map, cloud geometry) for one band."""
    perm = _spartacus_perm(config, is_sw)
    band = tables.band_from_g_sw if is_sw else tables.band_from_g_lw
    pj = _perm_on(perm, band.device)
    take = lambda a: a[..., pj]  # noqa: E731
    b = "sw" if is_sw else "lw"
    cl = op["cl"]
    return perm, take, (
        take(op[f"od_{b}"]), take(op[f"ssa_{b}"]), take(op[f"g_{b}_arr"]),
        cl[f"od_{b}"], cl[f"ssa_{b}"], cl[f"g_{b}"], band[pj], op["frac"],
        cloud["fractional_std"], cloud["overlap_param"],
        cloud["inv_cloud_effective_size"],
        cloud.get("inv_inhom_effective_size"))


def spartacus_lw_inputs(config, tables, op, cloud, pressure_hl,
                        temperature_hl):
    """(g permutation, the arguments of spartacus.solver_spartacus_lw in
    SPARTACUS g order) from _optical_properties' output."""
    perm, take, args = _spartacus_common(config, tables, False, op, cloud)
    lw_albedo_g = op["lw_albedo_g"]
    lw_emission = op["go"].lw_emission * (1.0 - lw_albedo_g)
    return perm, (config, *args, pressure_hl, temperature_hl,
                  take(op["go"].planck_hl), take(lw_emission),
                  take(lw_albedo_g))


def spartacus_sw_inputs(config, tables, op, cloud, pressure_hl,
                        temperature_hl, cos_sza):
    """(g permutation, the arguments of spartacus.solver_spartacus_sw in
    SPARTACUS g order) from _optical_properties' output."""
    perm, take, args = _spartacus_common(config, tables, True, op, cloud)
    return perm, (config, *args, pressure_hl, temperature_hl,
                  take(op["go"].incoming_sw), cos_sza,
                  take(op["sw_albedo_diffuse_g"]),
                  take(op["sw_albedo_direct_g"]))


def homogeneous_sample(config: Config, frac, od):
    """What the Homogeneous solvers give the McICA solvers in place of a
    stochastic sample: od_scaling 1, and a total cloud cover of 1 for a
    column with any cloudy layer (radiation_homogeneous_lw.F90)."""
    any_cloud = (frac >= config.cloud_fraction_threshold).any(dim=1)
    return torch.ones_like(od), any_cloud.to(od.dtype)


def radiation(config: Config, tables: Tables, *,
              pressure_hl, temperature_hl, gas_mmr,
              cos_sza, skin_temperature, sw_albedo, sw_albedo_direct,
              lw_emissivity, solar_irradiance,
              cloud=None, aerosol=None, spectral_solar_scaling=None,
              spectral_solar_cycle_multiplier=0.0) -> Flux:
    """The hot path (radiation_interface.F90:200-517) for the ported
    configurations.

    gas_mmr: (ncol, nlev, NUM_GASES) mass mixing ratios in
    constants.GAS_NAMES order.  spectral_solar_scaling: a per-band
    factor on the RRTMG solar spectrum (with use_spectral_solar_scaling;
    (n_bands_sw,), shared by all columns).  spectral_solar_cycle_multiplier
    shifts the ecCKD solar spectrum along the solar cycle (with
    use_spectral_solar_cycle).  With do_save_spectral_flux or
    do_save_gpoint_flux the *_band profile fields are set, per band or per
    g-point, from the per-g planes of the kernels (the fused McICA and
    Tripleclouds kernels, or the adding sweeps on the Cloudless, unfused
    McICA and Tripleclouds scan routes) or the SPARTACUS profiles.
    do_toa_spectral_flux sets the TOA band fields.  For a McICA solver cloud must carry the
    stochastic sample (od_scaling_*, total_cloud_cover_*; see
    pipeline.add_cloud_sample); Tripleclouds reads fractional_std and
    overlap_param, SPARTACUS also inv_cloud_effective_size (and
    inv_inhom_effective_size where given).  Without clouds (do_clouds off,
    or cloud None) both bands take the Cloudless solvers; Homogeneous runs
    McICA with od_scaling 1 and the cloud cover of any cloudy layer, and
    reports a cloud cover of -1.
    """
    op = _optical_properties(
        config, tables, pressure_hl=pressure_hl,
        temperature_hl=temperature_hl, gas_mmr=gas_mmr,
        cos_sza=cos_sza, skin_temperature=skin_temperature,
        sw_albedo=sw_albedo, sw_albedo_direct=sw_albedo_direct,
        lw_emissivity=lw_emissivity, solar_irradiance=solar_irradiance,
        cloud=cloud, aerosol=aerosol,
        spectral_solar_scaling=spectral_solar_scaling,
        spectral_solar_cycle_multiplier=spectral_solar_cycle_multiplier)
    dt = pressure_hl.dtype
    with profiling.scope("ecrad.outputs"):
        spec_lw = (spectral_matrix(config, tables.band_from_g_lw,
                                   config.n_bands_lw, dt)
                   if config.do_lw else None)
        spec_sw = (spectral_matrix(config, tables.band_from_g_sw,
                                   config.n_bands_sw, dt)
                   if config.do_sw else None)
    flux_kw = {}
    if config.do_lw:
        with profiling.scope("ecrad.solvers"):
            lw = _solve_lw(config, tables, op, cloud, spec_lw, pressure_hl,
                           temperature_hl)
        with profiling.scope("ecrad.outputs"):
            flux_kw.update(_lw_fluxes(config, tables, lw, spec_lw))
    if config.do_sw:
        with profiling.scope("ecrad.solvers"):
            sw = _solve_sw(config, tables, op, cloud, spec_sw, pressure_hl,
                           temperature_hl, cos_sza)
        with profiling.scope("ecrad.outputs"):
            flux_kw.update(_sw_fluxes(config, tables, sw, spec_sw,
                                      op["go"].incoming_sw, cos_sza))
    return Flux(**flux_kw)


def _permuted_rows(m, perm):
    """The rows of a spectral matrix in SPARTACUS g order (None stays
    None)."""
    if m is None:
        return None
    return m[_perm_on(perm, m.device)]


def _solve_lw(config: Config, tables: Tables, op, cloud, spec_lw,
              pressure_hl, temperature_hl):
    """The LW solver of the configuration on _optical_properties' output
    (Cloudless without clouds)."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    lw_albedo_g = op["lw_albedo_g"]
    lw_emission = go.lw_emission * (1.0 - lw_albedo_g)
    if config.lw_solver == Solver.CLOUDLESS or not op["do_clouds"]:
        return cloudless.solver_cloudless_lw(
            op["od_lw"], op["ssa_lw"], op["g_lw_arr"], go.planck_hl,
            lw_emission, lw_albedo_g,
            do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
            do_lw_derivatives=config.do_lw_derivatives,
            spec_matrix=spec_lw)
    if config.lw_solver == Solver.HOMOGENEOUS:
        ones, any_cloud = homogeneous_sample(config, frac, op["od_lw"])
        lw = mcica.solver_mcica_lw(
            op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
            cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
            tables.band_from_g_lw, ones, any_cloud,
            frac, go.planck_hl, lw_emission, lw_albedo_g,
            cloud_fraction_threshold=config.cloud_fraction_threshold,
            do_lw_cloud_scattering=config.do_lw_cloud_scattering,
            do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
            do_lw_derivatives=config.do_lw_derivatives,
            spec_matrix=spec_lw)
        return lw._replace(cloud_cover=torch.full_like(any_cloud, -1.0))
    if config.lw_solver == Solver.TRIPLECLOUDS:
        return tripleclouds.solver_tripleclouds_lw(
            config, op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
            cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
            tables.band_from_g_lw, frac, cloud["fractional_std"],
            cloud["overlap_param"], go.planck_hl, lw_emission,
            lw_albedo_g, spec_matrix=spec_lw)
    if config.lw_solver == Solver.SPARTACUS:
        with profiling.scope(REORDER):
            perm, args = spartacus_lw_inputs(config, tables, op, cloud,
                                             pressure_hl, temperature_hl)
            spec = _permuted_rows(spec_lw, perm)
        lw = spartacus.solver_spartacus_lw(*args, spec_matrix=spec)
        with profiling.scope(REORDER):
            return _unpermute_g_fields(lw, perm)
    return mcica.solver_mcica_lw(
        op["od_lw"], op["ssa_lw"], op["g_lw_arr"],
        cl["od_lw"], cl["ssa_lw"], cl["g_lw"],
        tables.band_from_g_lw,
        cloud["od_scaling_lw"], cloud["total_cloud_cover_lw"],
        frac, go.planck_hl, lw_emission, lw_albedo_g,
        cloud_fraction_threshold=config.cloud_fraction_threshold,
        do_lw_cloud_scattering=config.do_lw_cloud_scattering,
        do_lw_aerosol_scattering=config.do_lw_aerosol_scattering,
        do_lw_derivatives=config.do_lw_derivatives,
        spec_matrix=spec_lw)


def _lw_fluxes(config: Config, tables: Tables, lw, spec_lw) -> dict:
    """The Flux fields of the LW solver's output: profiles, cloud cover,
    derivatives, per-band profiles and TOA fluxes, canopy fluxes."""
    out = dict(lw_up=lw.flux_up, lw_dn=lw.flux_dn,
               lw_up_clear=lw.flux_up_clear, lw_dn_clear=lw.flux_dn_clear,
               cloud_cover_lw=lw.cloud_cover)
    if config.do_lw_derivatives:
        out["lw_derivatives"] = lw.lw_derivatives
    if spec_lw is not None:
        # with do_save_gpoint_flux the spectral axis is the g-points
        out.update(lw_up_band=lw.flux_up_s, lw_dn_band=lw.flux_dn_s,
                   lw_up_clear_band=lw.flux_up_clear_s,
                   lw_dn_clear_band=lw.flux_dn_clear_s)
    bfg, nb = tables.band_from_g_lw, config.n_bands_lw
    if config.do_toa_spectral_flux:
        # radiation_flux.F90:579-660 calc_toa_spectral
        out["lw_up_toa_band"] = indexed_sum_g(lw.lw_up_toa_g, bfg, nb)
        out["lw_up_toa_clear_band"] = indexed_sum_g(lw.lw_up_toa_clear_g,
                                                    bfg, nb)
    if config.do_canopy_fluxes_lw:
        lw_dn_surf_g = lw.lw_dn_surf_g
        if config.use_canopy_full_spectrum_lw:
            out["lw_dn_surf_canopy"] = lw_dn_surf_g
        elif config.do_nearest_spectral_lw_emiss:
            idx = tables.i_emiss_from_band_lw[bfg]
            out["lw_dn_surf_canopy"] = indexed_sum_g(
                lw_dn_surf_g, idx, config.n_canopy_bands_lw)
        else:
            lw_dn_band = indexed_sum_g(lw_dn_surf_g, bfg, nb)
            out["lw_dn_surf_canopy"] = lw_dn_band @ tables.lw_emiss_weights.T
    return out


def _solve_sw(config: Config, tables: Tables, op, cloud, spec_sw,
              pressure_hl, temperature_hl, cos_sza):
    """The SW solver of the configuration on _optical_properties' output
    (Cloudless without clouds)."""
    go, frac, cl = op["go"], op["frac"], op["cl"]
    if config.sw_solver == Solver.CLOUDLESS or not op["do_clouds"]:
        return cloudless.solver_cloudless_sw(
            op["od_sw"], op["ssa_sw"], op["g_sw_arr"], go.incoming_sw,
            cos_sza, op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
            do_sw_delta_scaling_with_gases=(
                config.do_sw_delta_scaling_with_gases),
            spec_matrix=spec_sw)
    if config.sw_solver == Solver.HOMOGENEOUS:
        ones, any_cloud = homogeneous_sample(config, frac, op["od_sw"])
        sw = mcica.solver_mcica_sw(
            op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
            cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
            tables.band_from_g_sw, ones, any_cloud,
            frac, go.incoming_sw, cos_sza,
            op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
            cloud_fraction_threshold=config.cloud_fraction_threshold,
            do_sw_delta_scaling_with_gases=(
                config.do_sw_delta_scaling_with_gases),
            spec_matrix=spec_sw)
        return sw._replace(cloud_cover=torch.full_like(any_cloud, -1.0))
    if config.sw_solver == Solver.TRIPLECLOUDS:
        # Tripleclouds sets the cloud cover of night columns too
        return tripleclouds.solver_tripleclouds_sw(
            config, op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
            cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
            tables.band_from_g_sw, frac, cloud["fractional_std"],
            cloud["overlap_param"], go.incoming_sw, cos_sza,
            op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
            spec_matrix=spec_sw)
    if config.sw_solver == Solver.SPARTACUS:
        with profiling.scope(REORDER):
            perm, args = spartacus_sw_inputs(config, tables, op, cloud,
                                             pressure_hl, temperature_hl,
                                             cos_sza)
            spec = _permuted_rows(spec_sw, perm)
        sw = spartacus.solver_spartacus_sw(*args, spec_matrix=spec)
        with profiling.scope(REORDER):
            return _unpermute_g_fields(sw, perm)
    return mcica.solver_mcica_sw(
        op["od_sw"], op["ssa_sw"], op["g_sw_arr"],
        cl["od_sw"], cl["ssa_sw"], cl["g_sw"],
        tables.band_from_g_sw,
        cloud["od_scaling_sw"], cloud["total_cloud_cover_sw"],
        frac, go.incoming_sw, cos_sza,
        op["sw_albedo_diffuse_g"], op["sw_albedo_direct_g"],
        cloud_fraction_threshold=config.cloud_fraction_threshold,
        do_sw_delta_scaling_with_gases=(
            config.do_sw_delta_scaling_with_gases),
        spec_matrix=spec_sw)


def _sw_fluxes(config: Config, tables: Tables, sw, spec_sw, incoming_sw,
               cos_sza) -> dict:
    """The Flux fields of the SW solver's output: profiles, cloud cover,
    surface bands, per-band profiles and TOA fluxes, canopy fluxes."""
    out = dict(sw_up=sw.flux_up, sw_dn=sw.flux_dn,
               sw_dn_direct=sw.flux_dn_direct,
               sw_up_clear=sw.flux_up_clear, sw_dn_clear=sw.flux_dn_clear,
               sw_dn_direct_clear=sw.flux_dn_direct_clear,
               cloud_cover_sw=sw.cloud_cover)
    bfg, nb = tables.band_from_g_sw, config.n_bands_sw
    if config.do_surface_sw_spectral_flux:
        dir_band = indexed_sum_g(sw.sw_dn_direct_surf_g, bfg, nb)
        diff_band = indexed_sum_g(sw.sw_dn_diffuse_surf_g, bfg, nb)
        out["sw_dn_direct_surf_band"] = dir_band
        out["sw_dn_surf_band"] = dir_band + diff_band
        dir_clear_band = indexed_sum_g(sw.sw_dn_direct_surf_clear_g, bfg, nb)
        diff_clear_band = indexed_sum_g(sw.sw_dn_diffuse_surf_clear_g,
                                        bfg, nb)
        out["sw_dn_surf_clear_band"] = dir_clear_band + diff_clear_band
        out["sw_dn_direct_surf_clear_band"] = dir_clear_band
    if spec_sw is not None:
        out.update(sw_up_band=sw.flux_up_s, sw_dn_band=sw.flux_dn_s,
                   sw_dn_direct_band=sw.flux_dn_direct_s,
                   sw_up_clear_band=sw.flux_up_clear_s,
                   sw_dn_clear_band=sw.flux_dn_clear_s,
                   sw_dn_direct_clear_band=sw.flux_dn_direct_clear_s)
    if config.do_toa_spectral_flux:
        # at TOA the downward flux is the direct beam only
        sw_dn_toa_g = torch.where(
            (cos_sza > 0.0)[:, None],
            incoming_sw * torch.clamp(cos_sza, min=0.0)[:, None],
            torch.zeros_like(incoming_sw))
        out["sw_dn_toa_band"] = indexed_sum_g(sw_dn_toa_g, bfg, nb)
        out["sw_up_toa_band"] = indexed_sum_g(sw.sw_up_toa_g, bfg, nb)
        out["sw_up_toa_clear_band"] = indexed_sum_g(sw.sw_up_toa_clear_g,
                                                    bfg, nb)
    if config.do_canopy_fluxes_sw:
        if config.use_canopy_full_spectrum_sw:
            out["sw_dn_diffuse_surf_canopy"] = sw.sw_dn_diffuse_surf_g
            out["sw_dn_direct_surf_canopy"] = sw.sw_dn_direct_surf_g
        elif config.do_nearest_spectral_sw_albedo:
            idx = tables.i_albedo_from_band_sw[bfg]
            out["sw_dn_diffuse_surf_canopy"] = indexed_sum_g(
                sw.sw_dn_diffuse_surf_g, idx, config.n_canopy_bands_sw)
            out["sw_dn_direct_surf_canopy"] = indexed_sum_g(
                sw.sw_dn_direct_surf_g, idx, config.n_canopy_bands_sw)
        else:
            # weights-based canopy mapping (radiation_flux.F90:498-518)
            dir_band = indexed_sum_g(sw.sw_dn_direct_surf_g, bfg, nb)
            tot_band = dir_band + indexed_sum_g(sw.sw_dn_diffuse_surf_g,
                                                bfg, nb)
            w = tables.sw_albedo_weights                 # (nalb, nband)
            canopy_dir = dir_band @ w.T
            out["sw_dn_direct_surf_canopy"] = canopy_dir
            out["sw_dn_diffuse_surf_canopy"] = tot_band @ w.T - canopy_dir
    return out



def compute_radiative_properties(config: Config, tables: Tables, **kw):
    """Debug dump of the per-g and per-band optical properties
    (radiation_save.F90:716-1025 save_radiative_properties contract).
    Same keyword inputs as radiation(); returns a dict of tensors."""
    kw.pop("iseed", None)
    op = _optical_properties(config, tables, **kw)
    go = op["go"]
    out = {}
    if config.do_sw:
        out["od_sw"] = op["od_sw"]
        out["ssa_sw"] = op["ssa_sw"]
        out["asymmetry_sw"] = op["g_sw_arr"]
        out["incoming_sw"] = go.incoming_sw
        out["sw_albedo"] = op["sw_albedo_diffuse_g"]
        out["sw_albedo_direct"] = op["sw_albedo_direct_g"]
    if config.do_lw:
        out["od_lw"] = op["od_lw"]
        out["ssa_lw"] = op["ssa_lw"]
        out["asymmetry_lw"] = op["g_lw_arr"]
        out["planck_hl"] = go.planck_hl
        out["lw_emission"] = go.lw_emission * (1.0 - op["lw_albedo_g"])
        out["lw_emissivity"] = 1.0 - op["lw_albedo_g"]
    if op["do_clouds"]:
        cl = op["cl"]
        out["cloud_fraction"] = op["frac"]
        if config.do_sw:
            out["od_sw_cloud"] = cl["od_sw"]
            out["ssa_sw_cloud"] = cl["ssa_sw"]
            out["asymmetry_sw_cloud"] = cl["g_sw"]
        if config.do_lw:
            out["od_lw_cloud"] = cl["od_lw"]
            out["ssa_lw_cloud"] = cl["ssa_lw"]
            out["asymmetry_lw_cloud"] = cl["g_lw"]
    return out
