"""Generalized cloud optics (port of ``ecrad_tpu/optics/general_cloud.py``):
arbitrary hydrometeor types with high-resolution scattering files averaged
to the model's spectral grid at setup.

Reference: radiation/radiation_general_cloud_optics.F90 +
radiation_general_cloud_optics_data.F90.  Setup (host, numpy) performs
delta-Eddington in high-resolution space, Planck/solar-weighted averaging
over g-points (or bands), optional optically-thick SSA averaging, then
reverts the delta scaling; run time is a linear interpolation in effective
radius, gathering the two rows of each table that bracket it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.constants import ACCEL_GRAVITY
from benchmark.reference.optics.spectral import (
    SOLAR_REFERENCE_TEMPERATURE, TERRESTRIAL_REFERENCE_TEMPERATURE)

DEFAULT_CLOUD_TYPES = ("mie_droplet", "baum-general-habit-mixture_ice")


def _setup_one(file_name, specdef, use_bands, use_thick_averaging,
               weighting_temperature):
    """radiation_general_cloud_optics_data.F90:50-180 setup."""
    from benchmark.reference.io.netcdf import NcFile

    with NcFile(file_name) as f:
        wavenumber = f.get("wavenumber")
        effective_radius = f.get("effective_radius")
        # file C-order (re, wav) -> Fortran (wav, re)
        mass_ext = f.get("mass_extinction_coefficient").T
        ssa = f.get("single_scattering_albedo").T
        asym = f.get("asymmetry_factor").T

    nre = effective_radius.size
    mapping = specdef.calc_mapping(
        wavenumber, weighting_temperature=weighting_temperature,
        use_bands=use_bands)

    # delta-Eddington in high-resolution space (elemental form)
    f_del = asym * asym
    mass_ext_d = mass_ext * (1.0 - ssa * f_del)
    ssa_d = ssa * (1.0 - f_del) / (1.0 - ssa * f_del)
    g_d = asym / (1.0 + asym)

    me = mapping @ mass_ext_d
    sa = (mapping @ (mass_ext_d * ssa_d)) / me
    ga = (mapping @ (mass_ext_d * ssa_d * g_d)) / (me * sa)

    if use_thick_averaging:
        # Edwards & Slingo (1996) optically-thick limit
        ref_inf = np.sqrt((1.0 - ssa_d) / (1.0 - ssa_d * g_d))
        ref_inf = (1.0 - ref_inf) / (1.0 + ref_inf)
        sa = mapping @ ref_inf
        sa = 4.0 * sa / ((1.0 + sa) ** 2 - ga * (1.0 - sa) ** 2)

    # revert delta-Eddington (radiation_delta_eddington.h:123-141):
    # g -> g/(1-g), then invert the ssa and od scalings in that order
    ga = ga / (1.0 - ga)
    f_rev = ga * ga
    sa = sa / (1.0 - f_rev + f_rev * sa)
    me = me / (1.0 - sa * f_rev)

    return {
        "mass_ext": me, "ssa": sa, "asymmetry": ga,     # (nspec, nre)
        "effective_radius_0": float(effective_radius[0]),
        "d_effective_radius": float(effective_radius[1]
                                    - effective_radius[0]),
        "n_effective_radius": nre,
    }


def setup_general_cloud_optics(config: Config, data_dir: str,
                               specdef_sw, specdef_lw) -> Dict:
    """radiation_general_cloud_optics.F90:32-100: per cloud type, its
    tables per g-point (or per band without
    do_cloud_aerosol_per_*_g_point) for each band set computed."""
    from benchmark.reference.data import find_data_file

    type_names: List[str] = [n for n in config.cloud_type_name if n]
    if not type_names:
        type_names = list(DEFAULT_CLOUD_TYPES)
    thick = list(config.use_thick_cloud_spectral_averaging)
    while len(thick) < len(type_names):
        thick.append(True)

    out = {"type_names": type_names, "sw": [], "lw": []}
    for jtype, name in enumerate(type_names):
        if name.endswith(".nc") or name.startswith("/"):
            fn = find_data_file(data_dir, name)
        else:
            fn = find_data_file(data_dir, name + "_scattering.nc")
        if config.do_sw:
            out["sw"].append(_setup_one(
                fn, specdef_sw,
                use_bands=not config.do_cloud_aerosol_per_sw_g_point,
                use_thick_averaging=thick[jtype],
                weighting_temperature=SOLAR_REFERENCE_TEMPERATURE))
        if config.do_lw:
            out["lw"].append(_setup_one(
                fn, specdef_lw,
                use_bands=not config.do_cloud_aerosol_per_lw_g_point,
                use_thick_averaging=thick[jtype],
                weighting_temperature=TERRESTRIAL_REFERENCE_TEMPERATURE))
    return out


def _add_optical_properties(lut, water_path, effective_radius,
                            in_cloud, with_scattering=True):
    """radiation_general_cloud_optics_data.F90 add_optical_properties:
    od, scattering od and its product with g (or only the absorption od),
    each (ncol, nlev, nspec), linear in effective radius between the two
    table rows that bracket it (clamped to the table's range)."""
    nre = lut["n_effective_radius"]
    re_index = torch.clamp(
        1.0 + (effective_radius - lut["effective_radius_0"])
        / lut["d_effective_radius"], 1.0, nre - 0.0001)
    ire = re_index.to(torch.int64)             # 1-based lower index
    w2 = (re_index - ire)[..., None]
    w1 = 1.0 - w2
    lo, hi = ire - 1, torch.clamp(ire, max=nre - 1)

    def lerp(table):                           # (nspec, nre)
        rows = table.T
        return w1 * rows[lo] + w2 * rows[hi]

    me, sa = lerp(lut["mass_ext"]), lerp(lut["ssa"])
    od = torch.where(in_cloud[..., None], water_path[..., None] * me,
                     torch.zeros_like(me))
    if with_scattering:
        scat = od * sa
        return od, scat, scat * lerp(lut["asymmetry"])
    return od * (1.0 - sa), None, None


def general_cloud_optics(config: Config, tables: Dict, pressure_hl,
                         cloud_fraction, mixing_ratio, effective_radius):
    """radiation_general_cloud_optics.F90:101-250 general_cloud_optics.

    mixing_ratio/effective_radius: (ncol, nlev, ntype).
    Returns dict od_lw/ssa_lw/g_lw, od_sw/ssa_sw/g_sw with the spectral
    axis nspec (g-points or bands) last.  In-cloud quantities.
    """
    in_cloud = cloud_fraction > 0.0
    dp = pressure_hl[:, 1:] - pressure_hl[:, :-1]
    if config.is_homogeneous:
        factor = dp / ACCEL_GRAVITY
    else:
        factor = dp / (ACCEL_GRAVITY
                       * torch.clamp(cloud_fraction,
                                     min=config.cloud_fraction_threshold))

    od_sw = scat_sw = scatg_sw = 0.0
    od_lw = scat_lw = scatg_lw = 0.0
    for jt in range(len(tables["type_names"])):
        wp = factor * mixing_ratio[:, :, jt]
        re = effective_radius[:, :, jt]
        if config.do_sw:
            od, sc, sg = _add_optical_properties(
                tables["sw"][jt], wp, re, in_cloud)
            od_sw, scat_sw, scatg_sw = od_sw + od, scat_sw + sc, \
                scatg_sw + sg
        if config.do_lw:
            if config.do_lw_cloud_scattering:
                od, sc, sg = _add_optical_properties(
                    tables["lw"][jt], wp, re, in_cloud)
                od_lw, scat_lw, scatg_lw = od_lw + od, scat_lw + sc, \
                    scatg_lw + sg
            else:
                od, _, _ = _add_optical_properties(
                    tables["lw"][jt], wp, re, in_cloud,
                    with_scattering=False)
                od_lw = od_lw + od

    def g_of(scat, scatg):
        """scatg / scat where scat > 0, else 0."""
        return torch.where(scat > 0.0,
                           scatg / torch.clamp(scat, min=1e-300),
                           torch.zeros_like(scat))

    out = {}
    icb = in_cloud[..., None]
    zero = lambda x: torch.zeros_like(x)  # noqa: E731
    if config.do_lw:
        if config.do_lw_cloud_scattering:
            # delta-Eddington extensive then convert to intensive
            # (radiation_general_cloud_optics.F90:150-167)
            g_hr = g_of(scat_lw, scatg_lw)
            f = g_hr * g_hr
            od_lw_d = od_lw - scat_lw * f
            scat_lw_d = scat_lw * (1.0 - f)
            scatg_lw_d = scat_lw_d * g_hr / (1.0 + g_hr)
            g_lw = scatg_lw_d / torch.clamp(scat_lw_d, min=1.0e-15)
            ssa_lw = scat_lw_d / torch.clamp(od_lw_d, min=1.0e-15)
            out["od_lw"] = torch.where(icb, od_lw_d, zero(od_lw_d))
            out["ssa_lw"] = torch.where(icb, ssa_lw, zero(ssa_lw))
            out["g_lw"] = torch.where(icb, g_lw, zero(g_lw))
        else:
            out["od_lw"] = torch.where(icb, od_lw, zero(od_lw))
            out["ssa_lw"] = zero(od_lw)
            out["g_lw"] = zero(od_lw)
    if config.do_sw:
        if not config.do_sw_delta_scaling_with_gases:
            g_hr = g_of(scat_sw, scatg_sw)
            f = g_hr * g_hr
            od_sw = od_sw - scat_sw * f
            scat_sw = scat_sw * (1.0 - f)
            scatg_sw = scat_sw * g_hr / (1.0 + g_hr)
        # convert extensive -> intensive (tail of general_cloud_optics)
        g_sw = g_of(scat_sw, scatg_sw)
        ssa_sw = torch.where(od_sw > 0.0,
                             scat_sw / torch.clamp(od_sw, min=1e-300),
                             zero(od_sw))
        out["od_sw"] = torch.where(icb, od_sw, zero(od_sw))
        out["ssa_sw"] = torch.where(icb, ssa_sw, zero(ssa_sw))
        out["g_sw"] = torch.where(icb, g_sw, zero(g_sw))
    return out
