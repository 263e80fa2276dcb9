"""Cloud effective-size parameterizations for the SPARTACUS solvers.

Reference: radiation/radiation_cloud.F90:496-690
(create_inv_cloud_effective_size_eta, param_cloud_effective_separation_eta)
and driver/ecrad_driver_read_input.F90:290-465 (precedence of the four
ways to specify cloud scale).

These run at input-preparation time on the host (numpy semantics work too
since everything is elementwise).
"""

from __future__ import annotations

import numpy as np


def _eta(pressure_hl):
    """Layer midpoint pressure over surface pressure (ncol, nlev)."""
    phl = np.asarray(pressure_hl)
    # surface half-level: whichever end has the larger pressure
    if phl[0, 0] > phl[0, 1]:
        psurf = phl[:, :1]
    else:
        psurf = phl[:, -1:]
    return (phl[:, :-1] + phl[:, 1:]) * (0.5 / psurf)


def inv_cloud_effective_size_eta(pressure_hl, inv_low, inv_mid, inv_high,
                                 eta_low_mid=0.8, eta_mid_high=0.45):
    """radiation_cloud.F90:524-594: piecewise-constant inverse effective
    size by eta band.  Returns (ncol, nlev)."""
    eta = _eta(pressure_hl)
    return np.where(eta > eta_low_mid, inv_low,
                    np.where(eta > eta_mid_high, inv_mid, inv_high))


def param_cloud_effective_separation_eta(pressure_hl, cloud_fraction,
                                         separation_surf, separation_toa,
                                         power=1.0,
                                         inhom_separation_factor=1.0):
    """radiation_cloud.F90:602-690: effective_separation =
    a + b*exp(-eta^power); returns (inv_cloud_effective_size,
    inv_inhom_effective_size), each (ncol, nlev)."""
    eta = _eta(pressure_hl)
    cf = np.asarray(cloud_fraction)
    coeff_e = 1.0 - np.exp(-1.0)
    coeff_b = (separation_toa - separation_surf) / coeff_e
    coeff_a = separation_toa - coeff_b
    eff_sep = coeff_a + coeff_b * np.exp(-eta ** power)
    inv_cloud = 1.0 / (eff_sep * np.sqrt(
        np.maximum(1.0e-5, cf * (1.0 - cf))))
    inv_inhom = 1.0 / (eff_sep * inhom_separation_factor * np.sqrt(
        np.maximum(1.0e-5, 0.5 * cf * (1.0 - 0.5 * cf))))
    return inv_cloud, inv_inhom


def inv_size_from_separation(cloud_fraction, inv_separation,
                             inv_inhom_separation=None,
                             cloud_fraction_threshold=1.0e-6,
                             inhom_separation_factor=1.0):
    """ecrad_driver_read_input.F90:380-433: convert per-cell inverse
    effective separation fields to inverse effective sizes."""
    cf = np.asarray(cloud_fraction)
    sep = np.asarray(inv_separation)
    thr = cloud_fraction_threshold
    inv_cloud = np.where(
        (cf > thr) & (cf < 1.0 - thr),
        sep / np.sqrt(np.maximum(cf * (1.0 - cf), 1e-30)), 0.0)
    if inv_inhom_separation is not None:
        isep = np.asarray(inv_inhom_separation)
        inv_inhom = np.where(
            cf > thr,
            isep / np.sqrt(np.maximum(0.5 * cf * (1.0 - 0.5 * cf),
                                      1e-30)), 0.0)
    else:
        inv_inhom = np.where(
            cf > thr,
            (1.0 / inhom_separation_factor) * sep
            / np.sqrt(np.maximum(0.5 * cf * (1.0 - 0.5 * cf), 1e-30)),
            0.0)
    return inv_cloud, inv_inhom
