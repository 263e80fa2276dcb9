"""RRTMG gas optics backend (port of ``ecrad_tpu/optics/rrtmg.py``): the
equivalent of radiation/radiation_ifs_rrtm.F90:216-614 (gas_optics) plus
planck_function_atmos/surf (L618-904), in torch with top-down level
ordering throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ecrad_torch.optics import rrtmg_data, rrtmg_lw, rrtmg_sw
from ecrad_torch.optics.rrtmg_interp import take_bands, weighted_take
from ecrad_torch.optics.rrtmg_prepare import prepare_columns

FLUXFAC = np.pi * 1.0e4


class RRTMGGasOptics(NamedTuple):
    """Output of the RRTMG backend (all top-down, g last)."""
    od_lw: Optional[torch.Tensor] = None        # (ncol, nlev, 140)
    planck_hl: Optional[torch.Tensor] = None    # (ncol, nlev+1, 140)
    lw_emission: Optional[torch.Tensor] = None  # (ncol, 140) surface Planck
    od_sw: Optional[torch.Tensor] = None        # (ncol, nlev, 112)
    ssa_sw: Optional[torch.Tensor] = None       # (ncol, nlev, 112)
    incoming_sw: Optional[torch.Tensor] = None  # (ncol, 112)


def setup_tables():
    """Host-side: load + reshape all tables (a flat dict of numpy arrays
    and scalars, the same keys as the JAX package's)."""
    raw = rrtmg_data.load_tables()
    tables = {}
    tables.update({f"lw:{k}": v
                   for k, v in rrtmg_lw.build_lw_tables(raw).items()})
    tables.update({f"sw:{k}": v
                   for k, v in rrtmg_sw.build_sw_tables(raw).items()})
    for k in ("pref", "preflog", "tref", "chi_mls"):
        tables[k] = raw[k]
    tables["totplnk"] = raw["lw_totplnk"]
    tables["delwave"] = raw["lw_delwave"]
    tables["lw_band_from_g"] = raw["lw_band_from_g"]
    tables["sw_band_from_g"] = raw["sw_band_from_g"]
    return tables


def _planck_interp_index(t):
    """TOTPLNK LUT index+fraction (radiation_ifs_rrtm.F90:672-690).

    Returns (0-based index, fraction)."""
    ind_mid = torch.floor(t - 159.0).to(torch.int64)
    frac_mid = t - torch.floor(t)
    ind = torch.where(t >= 339.0, torch.full_like(ind_mid, 180),
                      torch.where(t < 160.0, torch.ones_like(ind_mid),
                                  ind_mid))
    frac = torch.where(t >= 339.0, t - 339.0,
                       torch.where(t < 160.0, torch.zeros_like(t),
                                   frac_mid))
    return ind - 1, frac


def _planck_store(totplnk, delwave, temperature):
    """Planck flux per LW band at given temperatures: (...,) ->
    (..., nbands).  totplnk (181, 16)."""
    ind, frac = _planck_interp_index(temperature)
    p = weighted_take(totplnk, [(ind, 1.0 - frac),
                                (torch.clamp(ind + 1, 0, 180), frac)])
    return FLUXFAC * delwave * p


def gas_optics(tables: dict, pressure_hl, temperature_hl,
               gas_mmr: dict, cos_sza=None,
               do_lw=True, do_sw=True, skin_temperature=None,
               solar_irradiance=1366.0,
               min_gas_od_lw=1.0e-15, min_gas_od_sw=0.0) -> RRTMGGasOptics:
    """Full RRTMG gas optics.

    tables: the setup_tables dict as tensors.  gas_mmr: dict of
    (ncol, nlev) MASS mixing ratios with keys h2o, co2, ch4, n2o, cfc11,
    cfc12, hcfc22, ccl4, o3 (absent -> 0).
    """
    pressure_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    temperature_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    zero = torch.zeros_like(pressure_fl)

    def g(name):
        return gas_mmr.get(name, zero)

    cols = prepare_columns(
        pressure_hl, pressure_fl, temperature_fl,
        g("h2o"), g("co2"), g("ch4"), g("n2o"), g("cfc11"), g("cfc12"),
        g("hcfc22"), g("ccl4"), g("o3"),
        tables["preflog"], tables["tref"], tables["chi_mls"])

    out = {}
    if do_lw:
        lw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("lw:")}
        lw_tables["chi_mls"] = tables["chi_mls"]
        tau_lw, pfrac = rrtmg_lw.gas_optical_depth_lw(lw_tables, cols)
        out["od_lw"] = torch.clamp(tau_lw, min=min_gas_od_lw)

        # Planck at half levels: each half-level pairs with the PFRAC of
        # the layer above it; TOA half-level uses the top layer
        # (radiation_ifs_rrtm.F90:712-745)
        band_from_g = tables["lw_band_from_g"]
        planck_bands_hl = _planck_store(tables["totplnk"],
                                        tables["delwave"], temperature_hl)
        planck_g_hl = take_bands(planck_bands_hl, band_from_g)
        pfrac_hl = torch.cat([pfrac[:, :1], pfrac], dim=1)
        out["planck_hl"] = planck_g_hl * pfrac_hl

        if skin_temperature is not None:
            planck_bands_surf = _planck_store(tables["totplnk"],
                                              tables["delwave"],
                                              skin_temperature)
            planck_g_surf = take_bands(planck_bands_surf, band_from_g)
            # PFRAC of the lowest model layer (radiation_ifs_rrtm.F90:453)
            out["lw_emission"] = planck_g_surf * pfrac[:, -1]

    if do_sw:
        sw_tables = {k[3:]: v for k, v in tables.items()
                     if k.startswith("sw:")}
        taug, taur, sflux = rrtmg_sw.gas_optical_depth_sw(sw_tables, cols)
        od_sw = taur + taug
        out["od_sw"] = torch.clamp(od_sw, min=min_gas_od_sw)
        out["ssa_sw"] = taur / od_sw

        if cos_sza is not None:
            day = cos_sza > 0.0
            incsol = torch.where(day[:, None], sflux,
                                 torch.zeros_like(sflux))
            total = incsol.sum(-1)
            scale = torch.where(day, solar_irradiance
                                / torch.clamp(total, min=1.0e-30),
                                torch.ones_like(total))
            out["incoming_sw"] = incsol * scale[:, None]

    return RRTMGGasOptics(**out)
