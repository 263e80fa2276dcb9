"""Monochromatic (single g-point) gas and cloud optics; port of
``ecrad_tpu/optics/monochromatic.py``.

Reference: radiation/radiation_monochromatic.F90.  Gas optical depth is a
prescribed column total distributed in proportion to pressure thickness;
the Planck source is either broadband (sigma*T^4) or a single-wavelength
Planck function; cloud optics are geometric-optics liquid/ice extinction
with configurable single-scattering albedo and asymmetry.  One band of one
g-point in each band set, so every solver runs its kernels at ng = 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ecrad_torch.config import Config
from ecrad_torch.constants import ACCEL_GRAVITY
from ecrad_torch.solvers.two_stream import delta_eddington

# radiation_constants.F90:25-29
STEFAN_BOLTZMANN = 5.67037321e-8
DENSITY_LIQUID_WATER = 1000.0
DENSITY_SOLID_ICE = 916.7
# radiation_constants.F90:20-23 (exact reference values)
SPEED_OF_LIGHT = 299792458.0
PLANCK_CONSTANT = 6.6260695729e-34
BOLTZMANN_CONSTANT = 1.380648813e-23


def planck_function(wavelength, temperature):
    """Spectral Planck radiance (radiation_monochromatic.F90:189-204)."""
    return 2.0 * PLANCK_CONSTANT * SPEED_OF_LIGHT ** 2 / (
        wavelength ** 5
        * (torch.exp(PLANCK_CONSTANT * SPEED_OF_LIGHT
                     / (wavelength * BOLTZMANN_CONSTANT
                        * torch.clamp(temperature, min=1.0))) - 1.0))


def gas_optics(config: Config, pressure_hl, temperature_hl,
               skin_temperature, solar_irradiance):
    """radiation_monochromatic.F90:41-105.  Returns a dict with od_lw,
    od_sw, ssa_sw (ncol, nlev, 1), planck_hl (ncol, nlev+1, 1),
    lw_emission (ncol, 1) without the emissivity factor (the caller
    applies 1 - lw_albedo), incoming_sw (ncol, 1)."""
    phl = pressure_hl
    ncol = phl.shape[0]
    extinction_fraction = (phl[:, 1:] - phl[:, :-1]) / phl[:, -1:]
    od_lw = (config.mono_lw_total_od * extinction_fraction)[..., None]
    od_sw = (config.mono_sw_total_od * extinction_fraction)[..., None]
    ssa_sw = torch.full_like(od_sw, 0.999999)
    if config.mono_lw_wavelength <= 0.0:
        planck_hl = (STEFAN_BOLTZMANN * temperature_hl ** 4)[..., None]
        lw_emission = (STEFAN_BOLTZMANN * skin_temperature ** 4)[:, None]
    else:
        planck_hl = (math.pi * planck_function(
            config.mono_lw_wavelength, temperature_hl))[..., None]
        lw_emission = (math.pi * planck_function(
            config.mono_lw_wavelength, skin_temperature))[:, None]
    incoming_sw = torch.full((ncol, 1), float(solar_irradiance),
                             dtype=od_sw.dtype, device=od_sw.device)
    return dict(od_lw=od_lw, od_sw=od_sw, ssa_sw=ssa_sw,
                planck_hl=planck_hl, lw_emission=lw_emission,
                incoming_sw=incoming_sw)


def cloud_optics(config: Config, pressure_hl, cloud_fraction,
                 q_liq, q_ice, re_liq, re_ice):
    """radiation_monochromatic.F90:106-162: geometric-optics extinction
    3/(2 rho r_e) per water path, fixed ssa/asymmetry, delta-Eddington.
    Returns the dict of optics.cloud.cloud_optics with nband = 1."""
    eps = float(np.finfo(np.float64).eps)
    factor = (pressure_hl[:, 1:] - pressure_hl[:, :-1]) \
        / (ACCEL_GRAVITY * torch.clamp(cloud_fraction, min=eps))
    lwp = factor * q_liq
    iwp = factor * q_ice

    od_sw = ((3.0 / (2.0 * DENSITY_LIQUID_WATER)) * lwp / re_liq
             + (3.0 / (2.0 * DENSITY_SOLID_ICE)) * iwp / re_ice)[..., None]
    od_lw = (lwp * 137.22
             + (3.0 / (2.0 * DENSITY_SOLID_ICE)) * iwp / re_ice)[..., None]

    ssa_sw = torch.full_like(od_sw, config.mono_sw_single_scattering_albedo)
    g_sw = torch.full_like(od_sw, config.mono_sw_asymmetry_factor)
    od_sw, ssa_sw, g_sw = delta_eddington(od_sw, ssa_sw, g_sw)

    out = {"od_sw": od_sw, "ssa_sw": ssa_sw, "g_sw": g_sw}
    if config.do_lw_cloud_scattering:
        ssa_lw = torch.full_like(od_lw,
                                 config.mono_lw_single_scattering_albedo)
        g_lw = torch.full_like(od_lw, config.mono_lw_asymmetry_factor)
        od_lw, ssa_lw, g_lw = delta_eddington(od_lw, ssa_lw, g_lw)
        out.update(od_lw=od_lw, ssa_lw=ssa_lw, g_lw=g_lw)
    else:
        out.update(od_lw=od_lw, ssa_lw=torch.zeros_like(od_lw),
                   g_lw=torch.zeros_like(od_lw))
    return out
