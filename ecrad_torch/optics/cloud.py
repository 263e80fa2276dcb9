"""Cloud optical properties on the RRTMG band structure (port of
``ecrad_tpu/optics/cloud.py``).

Reference: radiation/radiation_cloud_optics.F90 (setup L33, run L218),
radiation_liquid_optics_socrates.F90, radiation_liquid_optics_slingo.F90,
radiation_ice_optics_fu.F90, radiation_ice_optics_baran.F90,
radiation_ice_optics_baran2017.F90, radiation_ice_optics_yi.F90.
Elementwise over (ncol, nlev) with bands last.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ecrad_torch.config import Config, IceModel, LiquidModel
from ecrad_torch.constants import ACCEL_GRAVITY

# File names per model (radiation_config.F90 consolidate: file names derived
# from model names)
LIQ_OPTICS_FILE = {
    LiquidModel.SOCRATES: "socrates_droplet_scattering_rrtm.nc",
    LiquidModel.SLINGO: "slingo_droplet_scattering_rrtm.nc",
    LiquidModel.JAHANGIR: "jahangir_droplet_scattering_rrtm.nc",
    LiquidModel.NIELSEN: "nielsen_droplet_scattering_rrtm.nc",
}
ICE_OPTICS_FILE = {
    IceModel.FU: "fu_ice_scattering_rrtm.nc",
    IceModel.BARAN: "baran_ice_scattering_rrtm.nc",
    IceModel.BARAN2016: "baran2016_ice_scattering_rrtm.nc",
    IceModel.BARAN2017: "baran2017_ice_scattering_rrtm.nc",
    IceModel.YI: "yi_ice_scattering_rrtm.nc",
}


def setup_cloud_optics(config: Config, data_dir: str) -> Dict:
    """Load band-wise liquid/ice coefficient tables (numpy)."""
    from ecrad_torch.data import find_data_file
    from ecrad_torch.io.netcdf import NcFile

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


def liq_slingo(coeff, lwp, re):
    """Slingo (1989) SW fits (radiation_liquid_optics_slingo.F90:26-49,
    calc_liq_optics_slingo).  coeff (nband, 6)."""
    c = [coeff[:, i] for i in range(6)]
    lwp_g = (lwp * 1000.0)[..., None]
    re_um = torch.clamp(re * 1.0e6, 4.2, 16.6)[..., None]
    inv_re = 1.0 / re_um
    od = lwp_g * (c[0] + inv_re * c[1])
    scat_od = od * (1.0 - c[2] - re_um * c[3])
    g = c[4] + re_um * c[5]
    return od, scat_od, g


def liq_lindner_li(coeff, lwp, re):
    """Lindner & Li (2000) LW fits
    (radiation_liquid_optics_slingo.F90:56-93 calc_liq_optics_lindner_li).
    coeff (nband, 13)."""
    c = [coeff[:, i] for i in range(13)]
    lwp_g = (lwp * 1000.0)[..., None]
    re_um = torch.clamp(re * 1.0e6, 2.0, 40.0)[..., None]
    inv_re = 1.0 / re_um
    od = lwp_g * (c[0] + re_um * c[1]
                  + inv_re * (c[2] + inv_re * (c[3] + inv_re * c[4])))
    scat_od = od * (1.0 - (c[5] + inv_re * c[6]
                           + re_um * (c[7] + re_um * c[8])))
    g = c[9] + inv_re * c[10] + re_um * (c[11] + re_um * c[12])
    return od, scat_od, g


def ice_baran(coeff, iwp, qi):
    """Baran ice parameterization in ice mixing ratio
    (radiation_ice_optics_baran.F90:10-29).  coeff (nband, 9)."""
    c = [coeff[:, i] for i in range(9)]
    iwp_b = iwp[..., None]
    qi_b = qi[..., None]
    od = iwp_b * (c[0] + c[1] / (1.0 + qi_b * c[2]))
    scat_od = od * (c[3] + c[4] / (1.0 + qi_b * c[5]))
    g = c[6] + c[7] / (1.0 + qi_b * c[8])
    return od, scat_od, g


def ice_baran2016(coeff, iwp, qi, temperature):
    """Baran et al. (2016) in qi and T
    (radiation_ice_optics_baran.F90:31-62).  coeff (nband, 5)."""
    c = [coeff[:, i] for i in range(5)]
    t = temperature[..., None]
    qi_t = torch.clamp(qi, max=1.0e-3)[..., None] * t
    qi_over_t4 = 1.0 / (t * t * t * t)
    od = iwp[..., None] * c[0] * qi_over_t4
    scat_od = od * (c[1] + c[2] * qi_t)
    g = c[3] + c[4] * qi_t
    return od, scat_od, g


def ice_baran2017(coeff_gen, coeff, iwp, qi, temperature):
    """Baran et al. (2017) (radiation_ice_optics_baran2017.F90:7-46).
    coeff_gen (5,), coeff (nband, 9).  The 1e-30 floor of the modified
    mixing ratio stays a normal number in float32."""
    cg = coeff_gen
    c = [coeff[:, i] for i in range(9)]
    qi_mod = qi * torch.exp(cg[0] * (temperature - cg[1]))
    qd = torch.clamp(qi_mod, min=1e-30)
    qi_od = (qd ** cg[2])[..., None]
    qi_ssa = (qd ** cg[3])[..., None]
    qi_g = (qd ** cg[4])[..., None]
    iwp_b = iwp[..., None]
    od = iwp_b * (c[0] + c[1] / (1.0 + qi_od * c[2]))
    scat_od = od * (c[3] + c[4] / (1.0 + qi_ssa * c[5]))
    g = c[6] + c[7] / (1.0 + qi_g * c[8])
    return od, scat_od, g


def ice_yi(coeff, iwp, re):
    """Yi et al. (2013) LUT interpolation in effective diameter
    (radiation_ice_optics_yi.F90:10-80).  coeff (nband, 69) laid out as
    23 extinction + 23 ssa + 23 asymmetry columns."""
    n_single = 23
    de_um = torch.clamp(re * 2.0e6, 10.0, 119.99)
    iwp_g = (iwp * 1000.0)[..., None]
    # Fortran lu_idx = floor(de*0.2 - 1), used as a 1-based column index
    pos = de_um * 0.2 - 1.0
    idx = torch.floor(pos)
    w2 = (pos - idx)[..., None]
    w1 = 1.0 - w2
    idx0 = idx.long() - 1                        # 0-based
    cf = coeff.T                                 # (69, nband)

    def lut(offset):
        return w1 * cf[idx0 + offset] + w2 * cf[idx0 + offset + 1]

    od = 0.001 * iwp_g * lut(0)
    scat_od = od * lut(n_single)
    g = lut(2 * n_single)
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


def _liquid_optics(config: Config, tables: Dict, lwp, re_liq):
    """LW and SW liquid (od, scat_od, g) of the configured model
    (radiation_cloud_optics.F90:335-356)."""
    if config.liquid_model == LiquidModel.SOCRATES:
        lw, sw = liq_socrates, liq_socrates
    elif config.liquid_model == LiquidModel.SLINGO:
        # radiation_cloud_optics.F90:346-353: Lindner & Li LW + Slingo SW
        lw, sw = liq_lindner_li, liq_slingo
    else:
        # Jahangir and Nielsen have no run dispatch in the reference either
        # (radiation_cloud_optics.F90:335-356 aborts on an unknown model)
        raise NotImplementedError(
            f"liquid model {config.liquid_model} has no run dispatch")
    return (lw(tables["liq_coeff_lw"], lwp, re_liq),
            sw(tables["liq_coeff_sw"], lwp, re_liq))


def _ice_optics(config: Config, tables: Dict, iwp, q_ice, re_ice,
                temperature_hl):
    """LW and SW ice (od, scat_od, g) of the configured model
    (radiation_cloud_optics.F90:358-460); the Baran2016/2017 fits take the
    mid-layer temperature."""
    model = config.ice_model
    if model == IceModel.FU:
        od, scat_od, g = ice_fu_lw(tables["ice_coeff_lw"], iwp, re_ice)
        if config.do_fu_lw_ice_optics_bug:
            scat_od = od - scat_od
        return (od, scat_od, g), ice_fu_sw(tables["ice_coeff_sw"], iwp,
                                           re_ice)
    t_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    if model == IceModel.BARAN:
        fit = lambda c: ice_baran(c, iwp, q_ice)  # noqa: E731
    elif model == IceModel.BARAN2016:
        fit = lambda c: ice_baran2016(c, iwp, q_ice, t_fl)  # noqa: E731
    elif model == IceModel.BARAN2017:
        fit = lambda c: ice_baran2017(  # noqa: E731
            tables["ice_coeff_gen"], c, iwp, q_ice, t_fl)
    elif model == IceModel.YI:
        fit = lambda c: ice_yi(c, iwp, re_ice)  # noqa: E731
    else:
        raise NotImplementedError(f"ice model {model} not yet implemented")
    return fit(tables["ice_coeff_lw"]), fit(tables["ice_coeff_sw"])


def cloud_optics(config: Config, tables: Dict, pressure_hl, temperature_hl,
                 cloud_fraction, q_liq, q_ice, re_liq, re_ice):
    """Cloud od/ssa/g per band (radiation_cloud_optics.F90:218-525).

    Returns dict with od_lw, ssa_lw, g_lw (ncol, nlev, nband_lw) and
    od_sw, ssa_sw, g_sw (ncol, nlev, nband_sw). In-cloud quantities.
    """
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

    liq_lw, liq_sw = _liquid_optics(config, tables, lwp, re_liq)
    liq_present = (lwp > 0.0)[..., None]
    od_lw_liq, scat_lw_liq, g_lw_liq = _keep(liq_present, *liq_lw)
    od_sw_liq, scat_sw_liq, g_sw_liq = _keep(liq_present, *liq_sw)
    if not config.do_sw_delta_scaling_with_gases:
        od_sw_liq, scat_sw_liq, g_sw_liq = delta_eddington_scat_od(
            od_sw_liq, scat_sw_liq, g_sw_liq)

    ice_lw, ice_sw = _ice_optics(config, tables, iwp, q_ice, re_ice,
                                 temperature_hl)
    ice_present = (iwp > 0.0)[..., None]
    od_lw_ice, scat_lw_ice, g_lw_ice = _keep(ice_present, *ice_lw)
    od_sw_ice, scat_sw_ice, g_sw_ice = _keep(ice_present, *ice_sw)
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
