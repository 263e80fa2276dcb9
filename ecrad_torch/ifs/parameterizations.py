"""IFS physical parameterizations feeding the radiation scheme (port of
``ecrad_tpu/ifs/parameterizations.py``).

Reference: ifs/liquid_effective_radius.F90 (Martin et al. 1994),
ifs/ice_effective_radius.F90 (Sun & Rikus 1999 rev. Sun 2001),
ifs/cloud_overlap_decorr_len.F90 (Shonk et al. 2010),
ifs/satur.F90 + fcttre.func.h, ifs/cos_sza.F90.

All functions are elementwise torch over (ncol, nlev) or (ncol,)
tensors, in the dtype and on the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

# ifsaux/yomcst_ecrad.F90
RD = 287.058
RNAVO = 6.0221367e23
RKBOL = 1.380658e-23
R_GAS = RNAVO * RKBOL
RMV = 18.0153
RV = 1000.0 * R_GAS / RMV
RETV = RV / RD - 1.0
RTT = 273.16
RPI = np.pi
RDAY = 86400.0
# ifs/yoethf.F90
R2ES = 611.21 * RD / RV
R3LES = 17.502
R3IES = 22.587
R4LES = 32.19
R4IES = -0.7
RTWAT = RTT
RTICE = RTT - 23.0
RTWAT_RTICE_R = 1.0 / (RTWAT - RTICE)
# ifs/yoerad.F90 defaults
RCCNLND = 900.0
RCCNSEA = 50.0
RRE2DE = 0.64952
RMINICE = 60.0


def _full(like, value):
    return torch.full_like(like, value)


def _as(like, value):
    """A Python number or a tensor as a tensor in like's dtype and on its
    device (broadcasting as it is)."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def liquid_effective_radius(pressure, temperature, cloud_frac, q_liq,
                            q_rain, land_frac, ccn_land=None, ccn_sea=None,
                            nradlp=2):
    """Liquid cloud droplet effective radius in METRES
    (ifs/liquid_effective_radius.F90; the Fortran returns microns).

    pressure/temperature/cloud_frac/q_liq/q_rain (ncol, nlev);
    land_frac (ncol,); nradlp: 0=pressure ramp, 1=land/sea fixed,
    2=Martin et al. (1994) in CCN."""
    min_re, max_re = 4.0, 30.0
    if nradlp == 0:
        re_um = 10.0 + (100000.0 - pressure) * 3.5
        return re_um * 1.0e-6
    land = (land_frac >= 0.5)[:, None].expand_as(pressure)
    if nradlp == 1:
        return torch.where(land, _full(pressure, 10.0e-6),
                           _full(pressure, 13.0e-6))
    # Martin et al. (1994)
    ccn_l = ccn_land[:, None] if ccn_land is not None else RCCNLND
    ccn_s = ccn_sea[:, None] if ccn_sea is not None else RCCNSEA
    disp = torch.where(land, _full(pressure, 0.69), _full(pressure, 0.77))
    ntot = torch.where(
        land, _as(pressure, -2.10e-4 * ccn_l * ccn_l + 0.568 * ccn_l - 27.9),
        _as(pressure, -1.15e-3 * ccn_s * ccn_s + 0.963 * ccn_s + 5.30))
    ratio = (0.222 / disp) ** 0.333

    air_density = 1000.0 * pressure / (RD * temperature)   # g m-3
    cf = torch.clamp(cloud_frac, min=1.0e-30)
    lwc = air_density * q_liq / cf
    rwc = air_density * q_rain / cf
    rain_ratio = rwc / torch.clamp(lwc, min=1.0e-12)
    wood = torch.where(lwc > 1.0e-12,
                       (1.0 + rain_ratio) ** 0.666
                       / (1.0 + 0.2 * ratio * rain_ratio),
                       torch.ones_like(lwc))
    re_cubed = 3.0 * (lwc + rwc) / (4.0 * RPI * ntot * disp)
    re_um = torch.where(
        re_cubed > 1.0e-12,
        torch.clamp(wood * 100.0
                    * torch.exp(0.333 * torch.log(
                        torch.clamp(re_cubed, min=1e-30))),
                    min_re, max_re),
        _full(re_cubed, min_re))
    active = (cloud_frac >= 0.001) & ((q_liq + q_rain) > 0.0)
    return torch.where(active, re_um, _full(re_um, min_re)) * 1.0e-6


def ice_effective_radius(pressure, temperature, cloud_frac, q_ice, q_snow,
                         sin_lat, nradip=3, nminice=1):
    """Ice effective radius in METRES (ifs/ice_effective_radius.F90).

    nradip: 0=fixed 40um, 1/2=Ou & Liou in T, 3=Sun & Rikus (1999)."""
    if nradip == 0:
        return _full(pressure, 40.0e-6)
    if nradip in (1, 2):
        t_c = torch.clamp(temperature - RTT, max=-0.1)
        re_um = 326.3 + t_c * (12.42 + t_c * (0.197 + t_c * 0.0012))
        if nradip == 1:
            re_um = torch.clamp(re_um, 40.0, 130.0)
        else:
            re_um = torch.clamp(re_um, 30.0, 60.0)
        return re_um * 1.0e-6
    # Sun & Rikus (1999), revised Sun (2001)
    default_re_um = 80.0 * RRE2DE
    if nminice == 0:
        min_diameter_um = _full(sin_lat, RMINICE)[:, None]
    else:
        cos_lat = torch.cos(torch.arcsin(sin_lat))
        min_diameter_um = (20.0 + (RMINICE - 20.0) * cos_lat)[:, None]
    air_density = 1000.0 * pressure / (RD * temperature)
    cf = torch.clamp(cloud_frac, min=1.0e-30)
    iwc = air_density * (q_ice + q_snow) / cf
    iwc_s = torch.clamp(iwc, min=1e-30)
    t_c = temperature - RTT
    a = 45.8966 * iwc_s ** 0.2214
    b = 0.7957 * iwc_s ** 0.2535
    diameter_um = (1.2351 + 0.0105 * t_c) \
        * (a + b * (temperature - 83.15))
    diameter_um = torch.minimum(
        torch.maximum(diameter_um, min_diameter_um),
        _full(diameter_um, 155.0))
    re_um = diameter_um * RRE2DE
    active = (cloud_frac > 0.001) & ((q_ice + q_snow) > 0.0)
    return torch.where(active, re_um, _full(re_um, default_re_um)) * 1.0e-6


def cloud_overlap_decorr_len(sin_lat, ndecolat=2):
    """Latitude-dependent cloud overlap decorrelation length
    (ifs/cloud_overlap_decorr_len.F90).  Returns (edges_km, water_km,
    ratio); ndecolat 0=constant (2 km), 1=Shonk linear, 2=cos^2."""
    if ndecolat == 0:
        edges = _full(sin_lat, 2.0)
        return edges, edges * 0.5, 0.5
    if ndecolat == 1:
        abs_lat_deg = torch.abs(torch.arcsin(sin_lat)) * (180.0 / RPI)
        edges = 2.899 - 0.02759 * abs_lat_deg
    else:
        cos_lat = torch.cos(torch.arcsin(sin_lat))
        edges = 0.75 + 2.149 * cos_lat * cos_lat
    return edges, edges * 0.5, 0.5


def satur(pressure_fl, temperature_fl):
    """Saturation specific humidity (ifs/satur.F90, LDPHYLIN branch:
    mixed-phase alpha weighting of liquid and ice saturation)."""
    t = temperature_fl
    alpha = torch.clamp(
        ((torch.clamp(t, RTICE, RTWAT) - RTICE) * RTWAT_RTICE_R) ** 2,
        max=1.0)
    ew_l = R2ES * torch.exp(R3LES * (t - RTT) / (t - R4LES))
    ew_i = R2ES * torch.exp(R3IES * (t - RTT) / (t - R4IES))
    ew = alpha * ew_l + (1.0 - alpha) * ew_i
    qs = torch.clamp(ew / pressure_fl, max=0.5)
    return qs / (1.0 - RETV * qs)


def cos_solar_zenith_angle(sin_lat, lon, sin_declination, cos_declination,
                           solar_hour_angle, average_over=None):
    """Cosine of solar zenith angle (ifs/cos_sza.F90).

    sin_lat/lon (ncol,) with lon in radians; solar_hour_angle is the
    reference's RWSOVR (radians, solar time).  With average_over=None the
    instantaneous formula (L63-69); otherwise the timestep-averaged form
    (L71-116) where average_over is the averaging window in radians of
    hour angle (= dt_seconds * pi / 43200)."""
    cos_lat = torch.sqrt(1.0 - sin_lat ** 2)
    sindec_sinlat = sin_declination * sin_lat
    zero = torch.zeros_like(sin_lat)
    if average_over is None:
        return torch.maximum(
            zero,
            sindec_sinlat
            - cos_declination * np.cos(solar_hour_angle) * cos_lat
            * torch.cos(lon)
            + cos_declination * np.sin(solar_hour_angle) * cos_lat
            * torch.sin(lon))
    # averaged over [t-dt/2, t+dt/2]
    half = 0.5 * average_over
    tan_dec = sin_declination / max(cos_declination, 1.0e-12)
    cos_ha_sunset = -tan_dec * sin_lat / torch.clamp(cos_lat, min=1.0e-12)
    # hour angle of the column: solar time + longitude - pi (mod 2pi)
    ha_mid = torch.where(solar_hour_angle + lon < 2.0 * RPI,
                         solar_hour_angle + lon - RPI,
                         solar_hour_angle + lon - 3.0 * RPI)
    ha_start = ha_mid - half
    ha_end = ha_mid + half
    ha_sunset = torch.arccos(torch.clamp(cos_ha_sunset, -1.0, 1.0))
    # clip the window to daylight
    a = torch.maximum(ha_start, -ha_sunset)
    b = torch.minimum(ha_end, ha_sunset)
    frac = torch.clamp(b - a, min=0.0)
    integral = sindec_sinlat * frac \
        + cos_declination * cos_lat * (torch.sin(b) - torch.sin(a))
    mu0 = torch.where(frac > 0.0, integral / average_over, zero)
    mu0 = torch.where(cos_ha_sunset > 1.0, zero, mu0)
    return torch.clamp(mu0, min=0.0)
