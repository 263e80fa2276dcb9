"""Cloud optical properties on the RRTMG band structure
(port of ``ecrad_tpu/optics/cloud.py`` for the SOCRATES liquid and Fu
ice models).

Reference: radiation/radiation_cloud_optics.F90 (setup L33, run L218),
radiation_liquid_optics_socrates.F90, radiation_ice_optics_fu.F90.
Elementwise over (ncol, nlev) with bands last.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ecrad_torch.config import Config, IceModel, LiquidModel
from ecrad_torch.constants import ACCEL_GRAVITY

LIQ_OPTICS_FILE = {LiquidModel.SOCRATES:
                   "socrates_droplet_scattering_rrtm.nc"}
ICE_OPTICS_FILE = {IceModel.FU: "fu_ice_scattering_rrtm.nc"}


def setup_cloud_optics(config: Config, data_dir: str) -> Dict:
    """Load band-wise liquid/ice coefficient tables (numpy)."""
    from ecrad_torch.data import find_data_file
    from ecrad_torch.io.netcdf import NcFile

    if config.liquid_model not in LIQ_OPTICS_FILE \
            or config.ice_model not in ICE_OPTICS_FILE:
        raise NotImplementedError(
            "the port has SOCRATES liquid and Fu ice optics only")
    liq_file = (config.liq_optics_override_file_name
                or LIQ_OPTICS_FILE[config.liquid_model])
    ice_file = (config.ice_optics_override_file_name
                or ICE_OPTICS_FILE[config.ice_model])
    out = {}
    with NcFile(find_data_file(data_dir, liq_file)) as f:
        out["liq_coeff_lw"] = f.get("coeff_lw")   # (nband_lw, ncoeff)
        out["liq_coeff_sw"] = f.get("coeff_sw")
    with NcFile(find_data_file(data_dir, ice_file)) as f:
        out["ice_coeff_lw"] = f.get("coeff_lw")
        out["ice_coeff_sw"] = f.get("coeff_sw")
        if f.exists("coeff_gen"):
            out["ice_coeff_gen"] = f.get("coeff_gen")
    return out


def liq_socrates(coeff, lwp, re):
    """SOCRATES Pade fits (radiation_liquid_optics_socrates.F90:9-31).
    coeff (nband, 16); lwp/re (ncol, nlev). Returns od, scat_od, g."""
    c = [coeff[:, i] for i in range(16)]
    re = torch.clamp(re, 1.2e-6, 50.0e-6)[..., None]
    lwp = lwp[..., None]
    od = lwp * (c[0] + re * (c[1] + re * c[2])) \
        / (1.0 + re * (c[3] + re * (c[4] + re * c[5])))
    scat_od = od * (1.0 - (c[6] + re * (c[7] + re * c[8]))
                    / (1.0 + re * (c[9] + re * c[10])))
    g = (c[11] + re * (c[12] + re * c[13])) \
        / (1.0 + re * (c[14] + re * c[15]))
    return od, scat_od, g


_MAX_G = 1.0 - 10.0 * np.finfo(np.float64).eps


def ice_fu_sw(coeff, iwp, re):
    """Fu (1996) SW (radiation_ice_optics_fu.F90:10-33)."""
    c = [coeff[:, i] for i in range(10)]
    de_um = (torch.clamp(re, max=100.0e-6) * (1.0e6 / 0.64952))[..., None]
    inv_de = 1.0 / de_um
    iwp_g = (iwp * 1000.0)[..., None]
    od = iwp_g * (c[0] + c[1] * inv_de)
    scat_od = od * (1.0 - (c[2] + de_um * (c[3] + de_um * (c[4]
                                                          + de_um * c[5]))))
    g = torch.clamp(c[6] + de_um * (c[7] + de_um * (c[8] + de_um * c[9])),
                    max=_MAX_G)
    return od, scat_od, g


def ice_fu_lw(coeff, iwp, re):
    """Fu et al. (1998) LW (radiation_ice_optics_fu.F90:35-60)."""
    c = [coeff[:, i] for i in range(11)]
    de_um = (torch.clamp(re, max=100.0e-6) * (1.0e6 / 0.64952))[..., None]
    inv_de = 1.0 / de_um
    iwp_g = (iwp * 1000.0)[..., None]
    od = iwp_g * (c[0] + inv_de * (c[1] + inv_de * c[2]))
    scat_od = od - iwp_g * inv_de * (c[3] + de_um * (c[4] + de_um * (
        c[5] + de_um * c[6])))
    g = torch.clamp(c[7] + de_um * (c[8] + de_um * (c[9] + de_um * c[10])),
                    max=_MAX_G)
    return od, scat_od, g


def delta_eddington_scat_od(od, scat_od, g):
    """radiation_delta_eddington.h delta_eddington_scat_od."""
    f = g * g
    od = od - scat_od * f
    scat_od = scat_od * (1.0 - f)
    g = g / (1.0 + g)
    return od, scat_od, g


def _keep(mask, *xs):
    return tuple(torch.where(mask, x, torch.zeros_like(x)) for x in xs)


def cloud_optics(config: Config, tables: Dict, pressure_hl, temperature_hl,
                 cloud_fraction, q_liq, q_ice, re_liq, re_ice):
    """Cloud od/ssa/g per band (radiation_cloud_optics.F90:218-525).

    Returns dict with od_lw, ssa_lw, g_lw (ncol, nlev, nband_lw) and
    od_sw, ssa_sw, g_sw (ncol, nlev, nband_sw). In-cloud quantities.
    """
    if config.liquid_model != LiquidModel.SOCRATES \
            or config.ice_model != IceModel.FU:
        raise NotImplementedError(
            "the port has SOCRATES liquid and Fu ice optics only")
    in_cloud = cloud_fraction > 0.0
    dp = pressure_hl[:, 1:] - pressure_hl[:, :-1]
    if config.is_homogeneous:
        factor = dp / ACCEL_GRAVITY
    else:
        factor = dp / (ACCEL_GRAVITY
                       * torch.clamp(cloud_fraction, min=1.0e-30))
    factor = torch.where(in_cloud, factor, torch.zeros_like(factor))
    lwp = factor * q_liq
    iwp = factor * q_ice

    liq_present = (lwp > 0.0)[..., None]
    od_lw_liq, scat_lw_liq, g_lw_liq = _keep(
        liq_present, *liq_socrates(tables["liq_coeff_lw"], lwp, re_liq))
    od_sw_liq, scat_sw_liq, g_sw_liq = _keep(
        liq_present, *liq_socrates(tables["liq_coeff_sw"], lwp, re_liq))
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_liq, scat_sw_liq, g_sw_liq = delta_eddington_scat_od(
            od_sw_liq, scat_sw_liq, g_sw_liq)

    od_lw_ice, scat_lw_ice, g_lw_ice = ice_fu_lw(tables["ice_coeff_lw"],
                                                 iwp, re_ice)
    if config.do_fu_lw_ice_optics_bug:
        scat_lw_ice = od_lw_ice - scat_lw_ice
    od_sw_ice, scat_sw_ice, g_sw_ice = ice_fu_sw(tables["ice_coeff_sw"],
                                                 iwp, re_ice)
    ice_present = (iwp > 0.0)[..., None]
    od_lw_ice, scat_lw_ice, g_lw_ice = _keep(
        ice_present, od_lw_ice, scat_lw_ice, g_lw_ice)
    od_sw_ice, scat_sw_ice, g_sw_ice = _keep(
        ice_present, od_sw_ice, scat_sw_ice, g_sw_ice)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_ice, scat_sw_ice, g_sw_ice = delta_eddington_scat_od(
            od_sw_ice, scat_sw_ice, g_sw_ice)
    od_lw_ice, scat_lw_ice, g_lw_ice = delta_eddington_scat_od(
        od_lw_ice, scat_lw_ice, g_lw_ice)

    in_cloud_b = in_cloud[..., None]
    out = {}
    if config.do_lw_cloud_scattering:
        od_lw = od_lw_liq + od_lw_ice
        scat_lw = scat_lw_liq + scat_lw_ice
        zero = torch.zeros_like(od_lw)
        g_lw = torch.where(scat_lw > 0.0,
                           (g_lw_liq * scat_lw_liq + g_lw_ice * scat_lw_ice)
                           / torch.clamp(scat_lw, min=1.0e-300), zero)
        ssa_lw = torch.where(od_lw > 0.0,
                             scat_lw / torch.clamp(od_lw, min=1.0e-300),
                             zero)
        out["od_lw"], out["ssa_lw"], out["g_lw"] = _keep(
            in_cloud_b, od_lw, ssa_lw, g_lw)
    else:
        od_lw = (od_lw_liq - scat_lw_liq) + (od_lw_ice - scat_lw_ice)
        (out["od_lw"],) = _keep(in_cloud_b, od_lw)
        out["ssa_lw"] = torch.zeros_like(od_lw)
        out["g_lw"] = torch.zeros_like(od_lw)

    od_sw = od_sw_liq + od_sw_ice
    scat_sw = scat_sw_liq + scat_sw_ice
    zero = torch.zeros_like(od_sw)
    g_sw = torch.where(scat_sw > 0.0,
                       (g_sw_liq * scat_sw_liq + g_sw_ice * scat_sw_ice)
                       / torch.clamp(scat_sw, min=1.0e-300), zero)
    ssa_sw = torch.where(od_sw > 0.0,
                         scat_sw / torch.clamp(od_sw, min=1.0e-300), zero)
    out["od_sw"], out["ssa_sw"], out["g_sw"] = _keep(
        in_cloud_b, od_sw, ssa_sw, g_sw)
    return out
