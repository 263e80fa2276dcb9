"""Aerosol optical properties (port of ``ecrad_tpu/optics/aerosol.py``).

Reference: radiation/radiation_aerosol_optics.F90 — general aerosol optics
setup (high-spectral-resolution file averaged to bands, or to the g-points
of an ecCKD spectral definition, at setup, L96-215), the legacy band-wise
file (radiation_aerosol_optics_data.F90:204-231, spread onto g-points by
L345-476), the run-time RH-dependent merge into the gas optics arrays
(add_aerosol_optics L487-780) and directly specified optics
(add_aerosol_optics_direct L832-1021); spectral averaging weights from
radiation_spectral_definition.F90:222-321 (calc_mapping).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.constants import ACCEL_GRAVITY
from benchmark.reference.optics import spectral


def calc_mapping_bands(wavenumber1_band, wavenumber2_band, ref_temp,
                       wavenumber):
    """Planck-weighted mapping (nband, nwn) from high-res wavenumber grid
    to bands (radiation_spectral_definition.F90:248-321, use_bands=True)."""
    wavenumber = np.asarray(wavenumber, np.float64)
    nwn = wavenumber.size
    nband = len(wavenumber1_band)
    planck = spectral.planck_function_wavenumber(wavenumber, ref_temp)
    mapping = np.zeros((nband, nwn))
    for jb in range(nband):
        w1b, w2b = wavenumber1_band[jb], wavenumber2_band[jb]
        weight = np.zeros(nwn)
        for jw in range(nwn):
            if w1b <= wavenumber[jw] <= w2b:
                wn1 = w1b if jw == 0 else max(
                    w1b, 0.5 * (wavenumber[jw - 1] + wavenumber[jw]))
                wn2 = w2b if jw == nwn - 1 else min(
                    w2b, 0.5 * (wavenumber[jw] + wavenumber[jw + 1]))
                weight[jw] = (wn2 - wn1) * planck[jw]
        if weight.sum() <= 0.0:
            # band contains no sample points: interpolate/nearest
            if wavenumber[0] >= w2b:
                weight[0] = 1.0
            elif wavenumber[-1] <= w1b:
                weight[-1] = 1.0
            else:
                iwav = 1
                while wavenumber[iwav] < w2b:
                    iwav += 1
                mid = 0.5 * (w1b + w2b)
                weight[iwav - 1] = planck[iwav - 1] * (wavenumber[iwav]
                                                      - mid)
                weight[iwav] = planck[iwav] * (mid - wavenumber[iwav - 1])
        mapping[jb] = weight / weight.sum()
    return mapping


# The IFS aerosol optics files read unless the configuration names another
GENERAL_AEROSOL_FILE = "aerosol_ifs_49R1_20230119.nc"
LEGACY_AEROSOL_FILE = "aerosol_ifs_rrtm_46R1_with_NI_AM.nc"


def aerosol_optics_path(config: Config, data_dir: str) -> str:
    """The aerosol optics file: the override, else the general file, else
    the legacy band-wise one (radiation_aerosol_optics.F90:59-62)."""
    from benchmark.reference.data import find_data_file

    if config.aerosol_optics_override_file_name:
        name = config.aerosol_optics_override_file_name
    elif config.use_general_aerosol_optics:
        name = GENERAL_AEROSOL_FILE
    else:
        name = LEGACY_AEROSOL_FILE
    return find_data_file(data_dir, name)


def setup_aerosol_optics(config: Config, data_dir: str,
                         wn1_sw, wn2_sw, wn1_lw, wn2_lw,
                         specdef_sw=None, specdef_lw=None) -> Dict:
    """Load the aerosol optics file, host-side numpy.  A general
    (high-resolution) file is spectrally averaged
    (radiation_aerosol_optics.F90:96-215) per band (wn1/wn2 bounds), or per
    g-point through the spectral definition with
    do_cloud_aerosol_per_*_g_point (ecCKD; pass specdef_sw/lw).  The
    reference reads general (spectrally resolved) files only."""
    from benchmark.reference.io.netcdf import NcFile

    path = aerosol_optics_path(config, data_dir)
    out = {}
    with NcFile(path) as f:
        if not f.exists("wavenumber"):
            raise NotImplementedError(f"{path}: the reference reads general "
                                      f"aerosol optics files only")
        wavenumber = f.get("wavenumber")
        mass_ext_phobic = f.get("mass_ext_hydrophobic")     # (ntype, nwn)
        ssa_phobic = f.get("ssa_hydrophobic")
        g_phobic = f.get("asymmetry_hydrophobic")
        use_philic = f.exists("mass_ext_hydrophilic")
        if use_philic:
            mass_ext_philic = f.get("mass_ext_hydrophilic")  # (nt,nrh,nwn)
            ssa_philic = f.get("ssa_hydrophilic")
            g_philic = f.get("asymmetry_hydrophilic")
            rh_lower = f.get("relative_humidity1")

    if config.do_cloud_aerosol_per_sw_g_point and specdef_sw is not None:
        map_sw = specdef_sw.calc_mapping(wavenumber, use_bands=False)
    else:
        map_sw = calc_mapping_bands(wn1_sw, wn2_sw,
                                    spectral.SOLAR_REFERENCE_TEMPERATURE,
                                    wavenumber)
    if config.do_cloud_aerosol_per_lw_g_point and specdef_lw is not None:
        map_lw = specdef_lw.calc_mapping(wavenumber, use_bands=False)
    else:
        map_lw = calc_mapping_bands(
            wn1_lw, wn2_lw, spectral.TERRESTRIAL_REFERENCE_TEMPERATURE,
            wavenumber)

    def average(mapping, mass_ext, ssa, g):
        """matmul(mapping(nband,nwn), X(nwn, ...)) over the last axis of
        the C-ordered (..., nwn) arrays.  Output (nband, ...)."""
        me = np.einsum("bw,...w->b...", mapping, mass_ext)
        ms = np.einsum("bw,...w->b...", mapping, mass_ext * ssa)
        mg = np.einsum("bw,...w->b...", mapping, mass_ext * ssa * g)
        ssa_b = ms / me
        g_b = mg / (me * ssa_b)
        return me, ssa_b, g_b

    out["mass_ext_sw_phobic"], out["ssa_sw_phobic"], out["g_sw_phobic"] = \
        average(map_sw, mass_ext_phobic, ssa_phobic, g_phobic)
    out["mass_ext_lw_phobic"], out["ssa_lw_phobic"], out["g_lw_phobic"] = \
        average(map_lw, mass_ext_phobic, ssa_phobic, g_phobic)
    out["use_hydrophilic"] = use_philic
    if use_philic:
        (out["mass_ext_sw_philic"], out["ssa_sw_philic"],
         out["g_sw_philic"]) = average(map_sw, mass_ext_philic,
                                       ssa_philic, g_philic)
        (out["mass_ext_lw_philic"], out["ssa_lw_philic"],
         out["g_lw_philic"]) = average(map_lw, mass_ext_philic,
                                       ssa_philic, g_philic)
        out["rh_lower"] = rh_lower
    # tables per band (or g-point): phobic (nband, ntype), philic (nband,
    # ntype, nrh)
    return out


def h2o_sat_liq(pressure_fl, temperature_fl):
    """Saturation MMR wrt liquid (radiation_thermodynamics.F90:145-153)."""
    e_sat = 6.11e2 * torch.exp(17.269 * (temperature_fl - 273.16)
                               / (temperature_fl - 35.86))
    return torch.clamp(0.622 * e_sat / pressure_fl, max=1.0)


def calc_rh_index(rh, rh_lower):
    """radiation_aerosol_optics_data.F90:640-664 -> 0-based bin index."""
    idx = (rh[..., None] > rh_lower[1:]).sum(-1)
    return torch.clamp(idx, 0, rh_lower.shape[0] - 1)


def aerosol_band_properties(config: Config, tables: Dict, pressure_hl,
                            aerosol_mmr, rh):
    """Per-band aerosol od / scat_od / scat_od*g
    (radiation_aerosol_optics.F90:560-660).

    aerosol_mmr: (ncol, nlev, ntype); rh: (ncol, nlev).
    Returns dict od_sw/scat_sw/scatg_sw (ncol,nlev,nband_sw) + lw same.

    As in the JAX package the type loop and the RH lookup fold into one
    contraction: out[n, p] = sum_slot mr_slot[n] * T_slot(rh_bin[n])[p],
    p running over (od|scat|scatg) x (sw bands|lw bands)."""
    factor = (pressure_hl[:, 1:] - pressure_hl[:, :-1]) / ACCEL_GRAVITY
    nb_sw = tables["mass_ext_sw_phobic"].shape[0]
    nb_lw = tables["mass_ext_lw_phobic"].shape[0]

    def prop_row(me, ss, gg):
        return torch.cat([me, me * ss, me * ss * gg])

    def row(kind, itype, *rh_bin):
        t = lambda name: tables[name][(slice(None), itype) + rh_bin]
        return torch.cat([
            prop_row(t(f"mass_ext_sw_{kind}"), t(f"ssa_sw_{kind}"),
                     t(f"g_sw_{kind}")),
            prop_row(t(f"mass_ext_lw_{kind}"), t(f"ssa_lw_{kind}"),
                     t(f"g_lw_{kind}"))])

    rows, wcols = [], []
    if tables["use_hydrophilic"]:
        irh = calc_rh_index(rh, tables["rh_lower"])
        nrh = tables["rh_lower"].shape[0]
    for jtype, mapping in enumerate(config.i_aerosol_type_map):
        if jtype >= aerosol_mmr.shape[-1] or mapping == 0:
            continue
        mr = factor * aerosol_mmr[:, :, jtype]      # (ncol, nlev)
        if mapping > 0:
            rows.append(row("phobic", mapping - 1))
            wcols.append(mr)
        else:
            for r in range(nrh):
                rows.append(row("philic", -mapping - 1, r))
                wcols.append(torch.where(irh == r, mr,
                                         torch.zeros_like(mr)))

    if not rows:
        zsw = factor.new_zeros(tuple(factor.shape) + (nb_sw,))
        zlw = factor.new_zeros(tuple(factor.shape) + (nb_lw,))
        return dict(od_sw=zsw, scat_sw=zsw, scatg_sw=zsw,
                    od_lw=zlw, scat_lw=zlw, scatg_lw=zlw)

    table = torch.stack(rows).to(factor.dtype)      # (K, 3(nbsw+nblw))
    out = torch.stack(wcols, dim=-1) @ table        # (ncol, nlev, nprop)
    s = np.cumsum([0, nb_sw, nb_sw, nb_sw, nb_lw, nb_lw, nb_lw])
    return dict(od_sw=out[..., s[0]:s[1]], scat_sw=out[..., s[1]:s[2]],
                scatg_sw=out[..., s[2]:s[3]],
                od_lw=out[..., s[3]:s[4]], scat_lw=out[..., s[4]:s[5]],
                scatg_lw=out[..., s[5]:s[6]])


def delta_eddington_extensive(od, scat, scatg):
    """radiation_delta_eddington.h:46-69."""
    g = torch.where(scat > 0.0, scatg / torch.clamp(scat, min=1e-300),
                    torch.zeros_like(scat))
    f = g * g
    od = od - scat * f
    scat = scat * (1.0 - f)
    scatg = scat * g / (1.0 + g)
    return od, scat, scatg


def add_aerosol_optics(config: Config, aer: Dict, band_from_g_sw,
                       band_from_g_lw, od_sw, ssa_sw, g_sw, od_lw,
                       ssa_lw=None, g_lw=None):
    """Merge band-wise (or per-g-point) aerosol properties into per-g gas
    arrays (radiation_aerosol_optics.F90:662-780); SW has a branch of its
    own per g-point, LW merges alike in both.  A band set that is off
    (do_sw / do_lw false) is not merged: its arrays pass through as they
    came (None from interface._optical_properties).

    Returns updated (od_sw, ssa_sw, g_sw, od_lw, ssa_lw, g_lw)."""
    if config.do_sw:
        od_sw, ssa_sw, g_sw = _merge_sw(config, aer, band_from_g_sw, od_sw,
                                        ssa_sw, g_sw)
    if config.do_lw:
        od_lw, ssa_lw, g_lw = _merge_lw(config, aer, band_from_g_lw, od_lw,
                                        ssa_lw, g_lw)
    return od_sw, ssa_sw, g_sw, od_lw, ssa_lw, g_lw


def _merge_sw(config: Config, aer: Dict, band_from_g, od_sw, ssa_sw, g_sw):
    od_a, scat_a, scatg_a = aer["od_sw"], aer["scat_sw"], aer["scatg_sw"]
    if not config.do_sw_delta_scaling_with_gases:
        od_a, scat_a, scatg_a = delta_eddington_extensive(
            od_a, scat_a, scatg_a)
    od_a_g = od_a[..., band_from_g]
    scat_a_g = scat_a[..., band_from_g]
    scatg_a_g = scatg_a[..., band_from_g]
    local_scat = ssa_sw * od_sw + scat_a_g
    if config.do_cloud_aerosol_per_sw_g_point:
        # per-g-point merge (radiation_aerosol_optics.F90:668-676)
        od_sw = od_sw + od_a_g
        g_sw = scatg_a_g / torch.clamp(local_scat, min=1.0e-24)
        ssa_sw = torch.clamp(local_scat / torch.clamp(od_sw, min=1.0e-24),
                             max=1.0)
        return od_sw, ssa_sw, g_sw
    local_od = od_sw + od_a_g
    apply = (local_od > 0.0) & (od_a_g > 0.0)
    new_g = torch.where(local_scat > 0.0,
                        scatg_a_g / torch.clamp(local_scat, min=1e-300),
                        g_sw)
    g_sw = torch.where(apply, new_g, g_sw)
    ssa_sw = torch.where(apply, local_scat
                         / torch.clamp(local_od, min=1e-300), ssa_sw)
    od_sw = torch.where(apply, local_od, od_sw)
    return od_sw, ssa_sw, g_sw


def _merge_lw(config: Config, aer: Dict, band_from_g, od_lw, ssa_lw, g_lw):
    if not config.do_lw_aerosol_scattering:
        # absorption-only LW aerosol (radiation_aerosol_optics.F90:751-768)
        od_abs = aer["od_lw"] - aer["scat_lw"]
        return od_lw + od_abs[..., band_from_g], ssa_lw, g_lw
    od_a, scat_a, scatg_a = delta_eddington_extensive(
        aer["od_lw"], aer["scat_lw"], aer["scatg_lw"])
    od_a_g = od_a[..., band_from_g]
    scat_a_g = scat_a[..., band_from_g]
    scatg_a_g = scatg_a[..., band_from_g]
    local_od = od_lw + od_a_g
    apply = (local_od > 0.0) & (od_a_g > 0.0)
    new_g = torch.where(scat_a_g > 0.0,
                        scatg_a_g / torch.clamp(scat_a_g, min=1e-300),
                        g_lw)
    g_lw = torch.where(apply, new_g, g_lw)
    ssa_lw = torch.where(apply, scat_a_g
                         / torch.clamp(local_od, min=1e-300), ssa_lw)
    od_lw = torch.where(apply, local_od, od_lw)
    return od_lw, ssa_lw, g_lw
