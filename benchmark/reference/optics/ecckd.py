"""ecCKD gas optics model (port of ``ecrad_tpu/optics/ecckd.py``).

Reference: radiation/radiation_ecckd.F90 (+ radiation_ecckd_gas.F90,
radiation_ecckd_interface.F90).  The k-distribution is loaded at setup
from a NetCDF "ckd-definition" file: per-gas molar absorption LUTs on a
regular log-pressure x temperature(-offset) grid with four concentration-
dependence types, a Planck LUT (LW) or normalized solar irradiance +
Rayleigh coefficients (SW), and an embedded spectral definition.

At run time each LUT is interpolated by gathering its corner rows: the
4 (temperature, pressure) corners of a layer, and for a gas whose
absorption depends on its concentration through a LUT (h2o) the 2
concentration corners of each, with the g axis last.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.optics.spectral_def import SpectralDefinition

# radiation_ecckd_gas.F90:8-13
CONC_NONE = 0
CONC_LINEAR = 1
CONC_LUT = 2
CONC_RELATIVE_LINEAR = 3

AIR_MOLAR_MASS = 28.970        # radiation_gas_constants.F90
GRAVITY = 9.80665


def load_ckd_model(path: str):
    """Host-side read (radiation_ecckd.F90:127-293).

    Returns (tables dict of numpy arrays, SpectralDefinition, meta dict of
    Python numbers, strings and a list of per-gas dicts)."""
    from benchmark.reference.io.netcdf import NcFile

    t: Dict = {}
    meta: Dict = {}
    with NcFile(path) as f:
        pressure_lut = f.get("pressure")
        meta["log_pressure1"] = float(np.log(pressure_lut[0]))
        meta["npress"] = pressure_lut.size
        meta["d_log_pressure"] = float(np.log(pressure_lut[1])
                                       - np.log(pressure_lut[0]))
        temperature_full = f.get("temperature")     # (ntemp, npress) C
        t["temperature1"] = temperature_full[0, :]  # (npress,)
        meta["d_temperature"] = float(temperature_full[1, 0]
                                      - temperature_full[0, 0])
        meta["ntemp"] = temperature_full.shape[0]

        if f.exists("solar_irradiance"):
            meta["is_sw"] = True
            si = f.get("solar_irradiance")
            t["norm_solar_irradiance"] = si / si.sum()
            t["rayleigh_molar_scat"] = f.get(
                "rayleigh_molar_scattering_coeff")
        else:
            meta["is_sw"] = False
            tp = f.get("temperature_planck")
            meta["nplanck"] = tp.size
            meta["temperature1_planck"] = float(tp[0])
            meta["d_temperature_planck"] = float(tp[1] - tp[0])
            t["planck_function"] = f.get("planck_function")  # (nT, ng)

        specdef = SpectralDefinition.from_file(f)
        meta["ng"] = specdef.ng

        gas_names = f.get_global_attr("constituent_id").split()
        meta["gases"] = []
        for gname in gas_names:
            g: Dict = {"name": gname}
            code = int(np.asarray(
                f.get(f"{gname}_conc_dependence_code")).ravel()[0])
            g["conc_dependence"] = code
            if code == CONC_LUT:
                # (nconc, ntemp, npress, ng) in C-order
                t[f"{gname}_molar_abs_conc"] = f.get(
                    f"{gname}_molar_absorption_coeff")
                mf = f.get(f"{gname}_mole_fraction")
                g["log_mole_frac1"] = float(np.log(mf[0]))
                g["n_mole_frac"] = mf.size
                g["d_log_mole_frac"] = float(
                    (np.log(mf[-1]) - np.log(mf[0])) / (mf.size - 1))
            else:
                # (ntemp, npress, ng) in C-order
                t[f"{gname}_molar_abs"] = f.get(
                    f"{gname}_molar_absorption_coeff")
            if code == CONC_RELATIVE_LINEAR:
                g["reference_mole_frac"] = float(np.asarray(f.get(
                    f"{gname}_reference_mole_fraction")).ravel()[0])
            meta["gases"].append(g)
    return t, specdef, meta


def pt_corners(tables: Dict, meta: Dict, pressure_hl, temperature_fl):
    """The bilinear (temperature, pressure) corners of each layer
    (radiation_ecckd.F90:494-531): four (row, weight) pairs, the rows
    0-based into a LUT flattened to (ntemp * npress, ...), each
    (ncol, nlev).  The 1-based lower corners ip1, it1 are clamped inside
    the grid, so the weights extrapolate nowhere; the temperature grid is
    offset per pressure, interpolated along pressure first."""
    npress, ntemp = meta["npress"], meta["ntemp"]
    log_p = torch.log(0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:]))
    pindex1 = (log_p - meta["log_pressure1"]) / meta["d_log_pressure"]
    pindex1 = 1.0 + torch.clamp(pindex1, 0.0, npress - 1.0001)
    ip1 = pindex1.to(torch.int64)              # 1-based lower index
    pw2 = pindex1 - ip1
    pw1 = 1.0 - pw2

    temp1_lut = tables["temperature1"]
    temperature1 = pw1 * temp1_lut[ip1 - 1] + pw2 * temp1_lut[ip1]
    tindex1 = (temperature_fl - temperature1) / meta["d_temperature"]
    tindex1 = 1.0 + torch.clamp(tindex1, 0.0, ntemp - 1.0001)
    it1 = tindex1.to(torch.int64)
    tw2 = tindex1 - it1
    tw1 = 1.0 - tw2

    lo = (it1 - 1) * npress + (ip1 - 1)        # (it1-1, ip1-1), 0-based
    return ((lo, tw1 * pw1), (lo + 1, tw1 * pw2),
            (lo + npress, tw2 * pw1), (lo + npress + 1, tw2 * pw2))


def _interp(table, corners, offset=0):
    """sum over corners of weight * table[offset + row]: (ncol, nlev, ng)
    from a (rows, ng) table."""
    out = 0.0
    for row, w in corners:
        out = out + w[..., None] * table[row + offset]
    return out


def calc_optical_depth(tables: Dict, meta: Dict, pressure_hl,
                       temperature_fl, gas_vmr):
    """radiation_ecckd.F90:457-658 calc_optical_depth_ckd_model.

    gas_vmr: dict name -> (ncol, nlev) volume mixing ratio ("composite"
    needs no entry).  Returns (od (ncol, nlev, ng), rayleigh od or None
    for the LW model)."""
    npress, ntemp = meta["npress"], meta["ntemp"]
    global_multiplier = 1.0 / (GRAVITY * 0.001 * AIR_MOLAR_MASS)
    simple_multiplier = global_multiplier * (pressure_hl[:, 1:]
                                             - pressure_hl[:, :-1])
    corners = pt_corners(tables, meta, pressure_hl, temperature_fl)
    npt = ntemp * npress

    # the gases with a LUT of concentration last, as the reference sums
    gases = sorted(meta["gases"],
                   key=lambda g: g["conc_dependence"] == CONC_LUT)
    od = 0.0
    for g in gases:
        gname, code = g["name"], g["conc_dependence"]
        if code == CONC_LUT:
            nconc = g["n_mole_frac"]
            floor = float(np.exp(g["log_mole_frac1"]))
            log_conc = torch.log(torch.clamp(gas_vmr[gname], min=floor))
            cindex1 = (log_conc - g["log_mole_frac1"]) \
                / g["d_log_mole_frac"]
            cindex1 = 1.0 + torch.clamp(cindex1, 0.0, nconc - 1.0001)
            ic1 = cindex1.to(torch.int64)      # 1-based lower index
            cw2 = cindex1 - ic1
            cw1 = 1.0 - cw2
            table = tables[f"{gname}_molar_abs_conc"]
            table = table.reshape(nconc * npt, table.shape[-1])
            k = (cw1[..., None] * _interp(table, corners, (ic1 - 1) * npt)
                 + cw2[..., None] * _interp(table, corners, ic1 * npt))
            mult = simple_multiplier * gas_vmr[gname]
        else:
            table = tables[f"{gname}_molar_abs"]
            k = _interp(table.reshape(npt, table.shape[-1]), corners)
            if code == CONC_LINEAR:
                mult = simple_multiplier * gas_vmr[gname]
            elif code == CONC_RELATIVE_LINEAR:
                mult = simple_multiplier * (gas_vmr[gname]
                                            - g["reference_mole_frac"])
            elif code == CONC_NONE:
                mult = simple_multiplier
            else:
                raise ValueError(f"unknown conc dependence {code}")
        od = od + mult[..., None] * k

    od = torch.clamp(od, min=0.0)
    if meta["is_sw"]:
        ray = simple_multiplier[..., None] * tables["rayleigh_molar_scat"]
        return od, ray
    return od, None


def calc_planck(tables: Dict, meta: Dict, temperature):
    """radiation_ecckd.F90:900-932 calc_planck_function.
    temperature (...,) -> (..., ng): linear in the (nplanck, ng) table,
    extrapolating above it from its last two rows and, below it, the first
    row scaled linearly in temperature."""
    pf = tables["planck_function"]                   # (nT, ng)
    t1 = meta["temperature1_planck"]
    tindex0 = (temperature - t1) / meta["d_temperature_planck"]
    tindex1 = 1.0 + tindex0
    it1 = torch.clamp(tindex1.to(torch.int64), max=meta["nplanck"] - 1)
    tw2 = tindex1 - it1
    tw1 = 1.0 - tw2
    # below the table (tindex0 < 0) the rows are clamped into it and the
    # result not used
    interp = (tw1[..., None] * pf[torch.clamp(it1 - 1, min=0)]
              + tw2[..., None] * pf[torch.clamp(it1, min=0)])
    low = pf[0] * (temperature / t1)[..., None]
    return torch.where((tindex0 >= 0.0)[..., None], interp, low)


def calc_incoming_sw(tables: Dict, total_solar_irradiance, ncol: int,
                     solar_cycle_multiplier: float = 0.0):
    """radiation_ecckd.F90:935-966: spectral solar irradiance per g
    point (ncol, ng), optionally shifted along the solar cycle (multiplier
    in standard deviations of the cycle; +1 ~ solar maximum)."""
    nsi = tables["norm_solar_irradiance"]
    if solar_cycle_multiplier != 0.0:
        if "norm_amplitude_solar_irradiance" not in tables:
            raise ValueError(
                "no information present on solar cycle "
                "(set use_spectral_solar_cycle; radiation_ecckd.F90:957)")
        nsi = nsi + solar_cycle_multiplier \
            * tables["norm_amplitude_solar_irradiance"]
    return (total_solar_irradiance * nsi).expand(ncol, nsi.shape[0])
