"""RRTMG gas optics backend (port of ``ecrad_tpu/optics/rrtmg.py``): the
equivalent of radiation/radiation_ifs_rrtm.F90:216-614 (gas_optics) plus
planck_function_atmos/surf (L618-904), in torch with top-down level
ordering throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ecrad_torch.optics import cuda_rrtmg, rrtmg_data, rrtmg_lw, rrtmg_sw
from ecrad_torch.optics.rrtmg_prepare import prepare_columns


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
    and scalars, the same keys as the JAX package's), and the kernels'
    packed buffers (``cuda_rrtmg.pack_tables``)."""
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
    tables.update(cuda_rrtmg.pack_tables(tables))
    return tables


def gas_columns(tables: dict, pressure_hl, temperature_hl,
                gas_mmr: dict):
    """The per-layer interpolation data of both band sets
    (rrtmg_prepare.GasColumns) from half-level pressure and temperature
    (ncol, nlev+1) and the gases' (ncol, nlev) mass mixing ratios (absent
    -> 0)."""
    pressure_fl = 0.5 * (pressure_hl[:, :-1] + pressure_hl[:, 1:])
    temperature_fl = 0.5 * (temperature_hl[:, :-1] + temperature_hl[:, 1:])
    zero = torch.zeros_like(pressure_fl)

    def g(name):
        return gas_mmr.get(name, zero)

    return prepare_columns(
        pressure_hl, pressure_fl, temperature_fl,
        g("h2o"), g("co2"), g("ch4"), g("n2o"), g("cfc11"), g("cfc12"),
        g("hcfc22"), g("ccl4"), g("o3"),
        tables["preflog"], tables["tref"], tables["chi_mls"])


def gas_optics(tables: dict, pressure_hl, temperature_hl,
               gas_mmr: dict, cos_sza=None,
               do_lw=True, do_sw=True, skin_temperature=None,
               solar_irradiance=1366.0,
               min_gas_od_lw=1.0e-15, min_gas_od_sw=0.0,
               spectral_solar_scaling=None) -> RRTMGGasOptics:
    """Full RRTMG gas optics.

    tables: the setup_tables dict as tensors.  gas_mmr: dict of
    (ncol, nlev) MASS mixing ratios with keys h2o, co2, ch4, n2o, cfc11,
    cfc12, hcfc22, ccl4, o3 (absent -> 0).  spectral_solar_scaling: an
    optional (14,) per-band factor on the solar spectrum, applied before
    the renormalisation to solar_irradiance.  The taumol interpolation
    runs in cuda_rrtmg's kernels on a card, in its plain versions on the
    CPU.
    """
    cols = gas_columns(tables, pressure_hl, temperature_hl, gas_mmr)

    out = {}
    if do_lw:
        out["od_lw"], out["planck_hl"], out["lw_emission"] = \
            cuda_rrtmg.lw_taumol(
                tables, cols, temperature_hl.contiguous(),
                None if skin_temperature is None
                else skin_temperature.contiguous(), min_gas_od_lw)

    if do_sw:
        out["od_sw"], out["ssa_sw"], sflux = cuda_rrtmg.sw_taumol(
            tables, cols, min_gas_od_sw)

        if cos_sza is not None:
            day = cos_sza > 0.0
            incsol = torch.where(day[:, None], sflux,
                                 torch.zeros_like(sflux))
            if spectral_solar_scaling is not None:
                # per-band scaling mapped to g-points
                # (radiation_ifs_rrtm.F90:543-551)
                scaling = torch.as_tensor(spectral_solar_scaling,
                                          dtype=incsol.dtype,
                                          device=incsol.device)
                incsol = incsol * scaling[tables["sw_band_from_g"]]
            total = incsol.sum(-1)
            scale = torch.where(day, solar_irradiance
                                / torch.clamp(total, min=1.0e-30),
                                torch.ones_like(total))
            out["incoming_sw"] = incsol * scale[:, None]

    return RRTMGGasOptics(**out)
