"""Input/output physical-bounds validation (port of ``ecrad_tpu/check.py``).

Reference: radiation/radiation_check.F90 (out_of_bounds_1d/2d/3d) and the
per-container ``out_of_physical_bounds`` methods
(radiation_thermodynamics.F90, radiation_single_level.F90,
radiation_cloud.F90, radiation_gas.F90, radiation_aerosol.F90,
radiation_flux.F90 heating-rate check); driven by the CLI's
``do_correct_unphysical_inputs`` (driver/ecrad_driver.F90:314-323).

Host-side numpy, as in the JAX package: the inputs are checked once per
read, and the fluxes once per run (a Flux on the card is copied to the
host first).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ecrad_torch.containers import to_numpy

# (min, max, fixable) per field, matching the reference bounds
INPUT_BOUNDS = {
    "pressure_hl": (0.0, 110000.0, False),   # fixing could zero dp
    "temperature_hl": (100.0, 400.0, True),
    "cos_sza": (-1.0, 1.0, True),
    "skin_temperature": (173.0, 373.0, True),
    "sw_albedo": (0.0, 1.0, True),
    "sw_albedo_direct": (0.0, 1.0, True),
    "lw_emissivity": (0.0, 1.0, True),
    "gas_mmr": (0.0, 1.0, True),
    "cloud_mixing_ratio": (0.0, 1.0, True),
    "cloud_effective_radius": (0.0, 0.1, True),
    "cloud_fraction": (0.0, 1.0, True),
    "fractional_std": (0.0, 10.0, True),
    "inv_cloud_effective_size": (0.0, 1.0, True),
    "inv_inhom_effective_size": (0.0, 1.0, True),
    "overlap_param": (-0.5, 1.0, True),
    "aerosol_mmr": (0.0, 0.01, True),
}


def out_of_bounds(arr, name, vmin, vmax, do_fix=False, out=sys.stderr):
    """radiation_check.F90 out_of_bounds_*: returns (is_bad, arr),
    clamping into [vmin, vmax] when do_fix."""
    arr = np.asarray(arr)
    finite = np.isfinite(arr)
    bad = (~finite) | (arr < vmin) | (arr > vmax)
    is_bad = bool(bad.any())
    if is_bad:
        amin = np.nanmin(np.where(finite, arr, np.inf))
        amax = np.nanmax(np.where(finite, arr, -np.inf))
        print(f"Warning: {name} range {amin:g} to {amax:g} is out of "
              f"physical bounds {vmin:g} to {vmax:g}"
              + (", clamping" if do_fix else ""), file=out)
        if do_fix:
            arr = np.clip(np.nan_to_num(arr, nan=vmin), vmin, vmax)
    return is_bad, arr


def check_inputs(inp, do_fix=False, out=sys.stderr):
    """Validate (and with do_fix repair) a RadiationInput: returns
    (any_bad, RadiationInput), the input itself left as it is."""
    any_bad = False
    rep = {}

    def chk(field, value):
        nonlocal any_bad
        if value is None:
            return value
        vmin, vmax, fixable = INPUT_BOUNDS[field]
        bad, fixed = out_of_bounds(value, field, vmin, vmax,
                                   do_fix and fixable, out)
        any_bad |= bad
        return fixed

    thermo = inp.thermodynamics
    rep["thermodynamics"] = dataclasses.replace(
        thermo, pressure_hl=chk("pressure_hl", thermo.pressure_hl),
        temperature_hl=chk("temperature_hl", thermo.temperature_hl))
    for field in ("cos_sza", "skin_temperature", "sw_albedo",
                  "sw_albedo_direct", "lw_emissivity", "gas_mmr",
                  "cloud_mixing_ratio", "cloud_effective_radius",
                  "cloud_fraction", "fractional_std", "overlap_param",
                  "inv_cloud_effective_size", "inv_inhom_effective_size",
                  "aerosol_mmr"):
        if hasattr(inp, field):
            rep[field] = chk(field, getattr(inp, field))
    return any_bad, dataclasses.replace(inp, **rep)


def check_fluxes(flux, pressure_hl, out=sys.stderr):
    """Post-run flux sanity (radiation_flux.F90
    heating_rate_out_of_physical_bounds): heating rates in [-500, 500]
    K/day SW within 0..200 net-absorption equivalent, fluxes finite.
    Warns only; returns whether anything was out of bounds."""
    any_bad = False
    g_over_cp = 9.80665 / 1004.0
    for name in ("sw_up", "sw_dn", "lw_up", "lw_dn"):
        v = getattr(flux, name, None)
        if v is None:
            continue
        if not np.isfinite(to_numpy(v)).all():
            print(f"Warning: {name} contains non-finite values",
                  file=out)
            any_bad = True
    phl = to_numpy(pressure_hl)
    # signed dp so both level orders (TOA-first and surface-first) give
    # the correct heating-rate sign; guard |dp| >= 1 Pa
    dp = phl[:, 1:] - phl[:, :-1]
    dp = np.sign(dp) * np.maximum(np.abs(dp), 1.0)
    for name, lo, hi in (("sw", 0.0, 200.0), ("lw", -500.0, 500.0)):
        up = getattr(flux, f"{name}_up", None)
        dn = getattr(flux, f"{name}_dn", None)
        if up is None or dn is None:
            continue
        net = to_numpy(dn) - to_numpy(up)
        hr = -86400.0 * g_over_cp * np.diff(net, axis=1) / dp
        if (hr < lo - 1e-6).any() or (hr > hi + 1e-6).any():
            print(f"Warning: {name} heating rate range "
                  f"{hr.min():.2f} to {hr.max():.2f} K/day out of "
                  f"bounds [{lo}, {hi}]", file=out)
            any_bad = True
    return any_bad
