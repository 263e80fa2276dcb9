"""Flat-array IFS-facing radiation scheme wrapper (port of
``ecrad_tpu/ifs/scheme.py``).

Reference: ifs/radiation_scheme.F90 (RADIATION_SCHEME) +
ifs/radiation_setup.F90 (UV/PAR weights via config get_sw_weights,
radiation_config.F90:1625-1722).

``setup_radiation_scheme`` builds the consolidated config and tables plus
the UV/PAR band weights; ``radiation_scheme`` takes plain tensors (as the
IFS passes its arrays), derives effective radii, overlap and cloud
geometry with the IFS parameterizations, runs ``interface.radiation`` and
unpacks net fluxes and surface diagnostics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ecrad_torch import constants
from ecrad_torch.cloud_size import param_cloud_effective_separation_eta
from ecrad_torch.config import Config, GasModel, Solver
from ecrad_torch.containers import to_numpy
from ecrad_torch.gas import Gas
from ecrad_torch.ifs import parameterizations as P
from ecrad_torch.interface import Tables, radiation, setup_radiation
from ecrad_torch.optics.spectral import (get_sw_weights,
                                         get_uv_biological_weights)

RSIGMA = 5.67037321e-8
# the gases the IFS passes as fields (radiation_scheme.F90:527-535)
GAS_ARGS = (("h2o", "q"), ("co2", "co2"), ("ch4", "ch4"), ("n2o", "n2o"),
            ("no2", "no2"), ("cfc11", "cfc11"), ("cfc12", "cfc12"),
            ("hcfc22", "hcfc22"), ("ccl4", "ccl4"), ("o3", "o3"))


class RadiationScheme(NamedTuple):
    config: Config
    tables: Tables
    iband_uv: np.ndarray
    weight_uv: np.ndarray
    iband_par: np.ndarray
    weight_par: np.ndarray
    # UV biologically effective flux weights (per g-point; ecCKD only,
    # radiation_config.F90:1724-1764); None for band-only gas optics
    ig_uv_bio: Optional[np.ndarray] = None
    weight_uv_bio: Optional[np.ndarray] = None


def setup_radiation_scheme(config: Config, device, dtype,
                           data_dir: str = None) -> RadiationScheme:
    """SETUP_RADIATION_SCHEME (ifs/radiation_setup.F90:109-580): core
    setup on ``device`` in ``dtype`` + UV (0.2-0.4415 um) and PAR
    (0.4-0.7 um) weights.

    The UV/PAR weights work for any SW gas model through the spectral
    definition built at setup (tables.specdef_sw): band-wise for RRTMG,
    per g-point when do_cloud_aerosol_per_sw_g_point (ecCKD), matching
    get_sw_weights' use_bands choice (radiation_config.F90:1666-1668).
    Monochromatic optics have no spectral definition, so no UV or PAR
    weights: they raise, as they fail in the JAX package's IFS layer.
    """
    if config.gas_model_sw == GasModel.MONOCHROMATIC:
        raise NotImplementedError(
            "the IFS layer's UV and PAR weights need a spectral definition, "
            "which monochromatic gas optics do not have")
    cfg = config.replace(do_surface_sw_spectral_flux=True,
                         do_canopy_fluxes_sw=True,
                         do_canopy_fluxes_lw=True)
    cfg, tables = setup_radiation(cfg, device, dtype, data_dir=data_dir)
    specdef = tables.specdef_sw
    use_bands = not cfg.do_cloud_aerosol_per_sw_g_point
    iband_uv, weight_uv = get_sw_weights(specdef, 0.2e-6, 0.4415e-6,
                                         use_bands)
    iband_par, weight_par = get_sw_weights(specdef, 0.4e-6, 0.7e-6,
                                           use_bands)
    ig_uv_bio = weight_uv_bio = None
    if not use_bands:
        try:
            ig_uv_bio, weight_uv_bio = get_uv_biological_weights(specdef)
        except ValueError:
            pass
    return RadiationScheme(cfg, tables, iband_uv, weight_uv,
                           iband_par, weight_par, ig_uv_bio, weight_uv_bio)


def _weighted(fluxes, index, weight):
    """fluxes[:, index] @ weight, the index and weights host arrays."""
    idx = torch.as_tensor(np.asarray(index), device=fluxes.device)
    w = torch.as_tensor(np.asarray(weight), dtype=fluxes.dtype,
                        device=fluxes.device)
    return fluxes[:, idx] @ w


def radiation_scheme(scheme: RadiationScheme, *,
                     solar_irradiance, mu0, skin_temperature,
                     albedo_diffuse, albedo_direct, spectral_emissivity,
                     sin_lat, lon, land_frac,
                     pressure_fl, temperature_fl,
                     pressure_hl, temperature_hl,
                     q, co2, ch4, n2o, no2, cfc11, cfc12, hcfc22, ccl4,
                     o3,
                     cloud_frac, q_liquid, q_ice, q_rain, q_snow,
                     aerosol_mmr=None, ccn_land=None, ccn_sea=None,
                     re_liq=None, re_ice=None, cloud_overlap=None,
                     iseed=None, cloud_extra=None, fractional_std=None,
                     gas_units="mmr"):
    """RADIATION_SCHEME (ifs/radiation_scheme.F90): flat tensors in (all
    on the scheme's device, in its dtype; iseed integer), net fluxes +
    surface diagnostics out.  Gas fields are mass mixing ratios by
    default (the IFS convention: q is specific humidity used directly as
    the H2O MMR, and q_ice includes snow, L393-395); host models holding
    VMR fields pass ``gas_units="vmr"`` (or a per-gas dict) and the
    conversion goes through the gas.Gas container
    (radiation_gas.F90:412-464 set_units path).

    cloud_extra: optional dict merged into the cloud inputs before the
    McICA generation step; od_scaling_sw/_lw + total_cloud_cover_sw/_lw
    there bypass the device generator (the BITIDENTITY-style
    cross-driver consistency test, reference Makefile:66-69 +
    driver/ecrad_ifs_driver.F90:445-452).

    The returned dict includes "_flux" (the full Flux container) so that
    drivers can write net-flux output files."""
    from ecrad_torch.driver import add_device_sample

    cfg, tables = scheme.config, scheme.tables
    ncol, nlev = pressure_fl.shape

    # effective radii (L396-413)
    if re_liq is None:
        re_liq = P.liquid_effective_radius(
            pressure_fl, temperature_fl, cloud_frac, q_liquid, q_rain,
            land_frac, ccn_land, ccn_sea)
    if re_ice is None:
        re_ice = P.ice_effective_radius(
            pressure_fl, temperature_fl, cloud_frac, q_ice, q_snow,
            sin_lat)

    # overlap parameter from latitude-dependent decorrelation (L415-424)
    if cloud_overlap is None:
        decorr_km, _, _ = P.cloud_overlap_decorr_len(sin_lat)
        # set_overlap_param (radiation_cloud.F90): layer-separation
        # overlap with per-column decorrelation length
        r_over_g = P.RD / constants.ACCEL_GRAVITY
        p_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
        t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
        tbar = 0.5 * (t_fl[:, :-1] + t_fl[:, 1:])
        dz = r_over_g * tbar * torch.log(
            p_fl[:, 1:] / torch.clamp(p_fl[:, :-1], min=1e-10))
        cloud_overlap = torch.exp(
            -torch.clamp(dz, min=0.0) / (decorr_km[:, None] * 1000.0))

    if fractional_std is None:
        fractional_std = torch.ones_like(pressure_fl)   # RCLOUD_FRAC_STD

    cloud = {
        "fraction": cloud_frac,
        "q_liq": q_liquid,
        "q_ice": q_ice + q_snow,
        "re_liq": re_liq,
        "re_ice": re_ice,
        "overlap_param": cloud_overlap,
        "fractional_std": fractional_std,
    }
    if Solver.SPARTACUS in (cfg.sw_solver, cfg.lw_solver):
        # host numpy, as in the JAX package
        inv_cloud, inv_inhom = param_cloud_effective_separation_eta(
            to_numpy(pressure_hl), to_numpy(cloud_frac),
            2500.0, 14000.0, 3.5, 0.75)
        cloud["inv_cloud_effective_size"] = torch.as_tensor(
            inv_cloud, dtype=cloud_frac.dtype, device=cloud_frac.device)
        cloud["inv_inhom_effective_size"] = torch.as_tensor(
            inv_inhom, dtype=cloud_frac.dtype, device=cloud_frac.device)
    if cloud_extra:
        cloud.update(cloud_extra)
    if Solver.MCICA in (cfg.sw_solver, cfg.lw_solver) \
            and "od_scaling_sw" not in cloud \
            and "od_scaling_lw" not in cloud:
        # the device generator (threefry draws and scan in one kernel)
        if iseed is None:
            iseed = torch.arange(1, ncol + 1, device=cloud_frac.device)
        cloud = add_device_sample(cfg, tables, dict(cloud, iseed=iseed))

    # Fill the gas container (GAS%PUT x 9 + PUT_WELL_MIXED(O2),
    # radiation_scheme.F90:527-536); gas_units: "mmr" (IFS convention,
    # default) or "vmr", or a per-gas dict
    fields = dict(q=q, co2=co2, ch4=ch4, n2o=n2o, no2=no2, cfc11=cfc11,
                  cfc12=cfc12, hcfc22=hcfc22, ccl4=ccl4, o3=o3)
    gas = Gas.allocate(ncol, nlev, q.dtype, q.device)
    for name, arg in GAS_ARGS:
        units = gas_units.get(name, "mmr") \
            if isinstance(gas_units, dict) else gas_units
        gas = gas.put(name, units, fields[arg])
    # well-mixed O2 at 0.20944 VMR (radiation_scheme.F90:536)
    gas = gas.put_well_mixed("o2", "vmr", 0.20944)

    aerosol = None
    if cfg.use_aerosols and aerosol_mmr is not None:
        aerosol = {"mixing_ratio": aerosol_mmr}

    flux = radiation(
        cfg, tables, pressure_hl=pressure_hl, temperature_hl=temperature_hl,
        gas_mmr=gas.to_mmr(), cos_sza=mu0,
        skin_temperature=skin_temperature, sw_albedo=albedo_diffuse,
        sw_albedo_direct=albedo_direct, lw_emissivity=spectral_emissivity,
        solar_irradiance=float(solar_irradiance), cloud=cloud,
        aerosol=aerosol)

    # unpack (radiation_scheme.F90:293-345)
    out = {
        "flux_sw": flux.sw_dn - flux.sw_up,
        "flux_lw": flux.lw_dn - flux.lw_up,
        "flux_sw_clear": flux.sw_dn_clear - flux.sw_up_clear,
        "flux_lw_clear": flux.lw_dn_clear - flux.lw_up_clear,
        "flux_sw_dn_surf": flux.sw_dn[:, -1],
        "flux_lw_dn_surf": flux.lw_dn[:, -1],
        "flux_sw_dn_clear_surf": flux.sw_dn_clear[:, -1],
        "flux_lw_dn_clear_surf": flux.lw_dn_clear[:, -1],
        "flux_dir": flux.sw_dn_direct[:, -1],
        "flux_dir_clear": flux.sw_dn_direct_clear[:, -1],
        "flux_sw_dn_toa": flux.sw_dn[:, 0],
    }
    out["flux_dir_into_sun"] = torch.where(
        mu0 > np.finfo(np.float64).eps,
        out["flux_dir"] / torch.clamp(mu0, min=1e-30),
        torch.zeros_like(mu0))

    # UV / PAR from surface spectral fluxes
    sdb = flux.sw_dn_surf_band
    out["flux_uv"] = _weighted(sdb, scheme.iband_uv, scheme.weight_uv)
    out["flux_par"] = _weighted(sdb, scheme.iband_par, scheme.weight_par)
    out["flux_par_clear"] = _weighted(flux.sw_dn_surf_clear_band,
                                      scheme.iband_par, scheme.weight_par)
    if scheme.ig_uv_bio is not None:
        # biologically effective UV (divide by 40 for UV index,
        # radiation_config.F90:1722-1724)
        out["flux_uv_biological"] = _weighted(sdb, scheme.ig_uv_bio,
                                              scheme.weight_uv_bio)

    # effective broadband emissivity (L327-333)
    black_body_net = out["flux_lw_dn_surf"] \
        - RSIGMA * skin_temperature ** 4
    out["emissivity_out"] = torch.where(
        torch.abs(black_body_net) > 1.0e-5,
        torch.clamp(out["flux_lw"][:, -1] / black_body_net, 0.8, 0.99),
        spectral_emissivity[:, 0])

    if cfg.do_lw_derivatives:
        out["lw_derivative"] = flux.lw_derivatives
    if flux.sw_dn_diffuse_surf_canopy is not None:
        out["sw_diffuse_band"] = flux.sw_dn_diffuse_surf_canopy
        out["sw_direct_band"] = flux.sw_dn_direct_surf_canopy
    out["_flux"] = flux
    return out
