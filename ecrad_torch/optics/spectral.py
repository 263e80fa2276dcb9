"""Spectral definition utilities (host-side NumPy, setup time only).

Reference: radiation/radiation_spectral_definition.F90 — band bounds,
Planck-weighted mapping between user albedo/emissivity intervals and the
radiation scheme's spectral bands (calc_mapping_from_bands L515-822), and
the reference Planck function (calc_planck_function_wavenumber L1094-1116).
"""

from __future__ import annotations

import numpy as np

SOLAR_REFERENCE_TEMPERATURE = 5777.0        # K (L27)
TERRESTRIAL_REFERENCE_TEMPERATURE = 273.15  # K (L28)

# Values as in the reference (radiation/radiation_constants.F90:31-33)
SPEED_OF_LIGHT = 299792458.0
PLANCK_CONSTANT = 6.6260695729e-34
BOLTZMANN_CONSTANT = 1.380648813e-23


def planck_function_wavenumber(wavenumber_cm, temperature):
    """Planck spectral irradiance W m-2 (cm-1)-1
    (radiation_spectral_definition.F90:1094-1116)."""
    wavenumber_cm = np.asarray(wavenumber_cm, np.float64)
    freq = 100.0 * SPEED_OF_LIGHT * wavenumber_cm
    planck_fn_freq = (2.0 * PLANCK_CONSTANT * freq ** 3
                      / (SPEED_OF_LIGHT ** 2
                         * np.expm1(PLANCK_CONSTANT * freq
                                    / (BOLTZMANN_CONSTANT * temperature))))
    return planck_fn_freq * 100.0 * SPEED_OF_LIGHT


def calc_mapping_from_bands(wavenumber1_band, wavenumber2_band,
                            reference_temperature,
                            wavelength_bound, i_intervals,
                            use_fluxes=False, equal_weighting=False):
    """Weights for mapping per-interval surface properties to bands.

    Per-band (use_bands=True) variant of
    radiation_spectral_definition.F90:515-822: for each (interval, band)
    overlap, integrate the reference-temperature Planck function with a
    5-point trapezium rule; normalize each band column to sum 1 (or, with
    use_fluxes, normalize by the whole-band Planck integral).

    Args:
      wavenumber1_band/2_band: (nband,) band bounds in cm-1.
      wavelength_bound: (ninterval-1,) increasing wavelength bounds (m).
      i_intervals: (ninterval,) 1-based albedo-band index per interval.
      equal_weighting: weight each wavenumber equally instead of by the
        reference Planck function (do_weighted_surface_mapping=false,
        radiation_config.F90:507-512; note the reference's v1.7.1
        consolidate has identical code in both branches, i.e. the flag
        is a no-op there — here we implement the documented intent).
    Returns mapping (ninput, nband).
    """
    wavenumber1_band = np.asarray(wavenumber1_band, np.float64)
    wavenumber2_band = np.asarray(wavenumber2_band, np.float64)
    wavelength_bound = np.asarray(wavelength_bound, np.float64)
    i_intervals = np.asarray(i_intervals, int)
    nband = wavenumber1_band.size
    ninterval = i_intervals.size
    ninput = i_intervals.max()
    weight_sample = np.array([0.5, 1.0, 1.0, 1.0, 0.5])
    nsample = 5

    mapping = np.zeros((ninput, nband))
    mapping_denom = np.zeros((ninput, nband))

    for jband in range(nband):
        for jint in range(ninterval):
            if jint == 0:
                wn2 = wavenumber2_band[jband]
            else:
                wn2 = min(wavenumber2_band[jband],
                          0.01 / wavelength_bound[jint - 1])
            if jint == ninterval - 1:
                wn1 = wavenumber1_band[jband]
            else:
                wn1 = max(wavenumber1_band[jband],
                          0.01 / wavelength_bound[jint])
            if wn2 > wn1:
                wns = wn1 + np.arange(nsample) * (wn2 - wn1) / (nsample - 1)
                if equal_weighting:
                    planck = np.ones(nsample)
                else:
                    planck = planck_function_wavenumber(
                        wns, reference_temperature)
                mapping[i_intervals[jint] - 1, jband] += \
                    np.sum(planck * weight_sample) * (wn2 - wn1)
                if use_fluxes:
                    wnsb = (wavenumber1_band[jband]
                            + np.arange(nsample)
                            * (wavenumber2_band[jband]
                               - wavenumber1_band[jband]) / (nsample - 1))
                    if equal_weighting:
                        planck_b = np.ones(nsample)
                    else:
                        planck_b = planck_function_wavenumber(
                            wnsb, reference_temperature)
                    mapping_denom[i_intervals[jint] - 1, jband] += \
                        np.sum(planck_b * weight_sample) \
                        * (wavenumber2_band[jband]
                           - wavenumber1_band[jband])

    if use_fluxes:
        mapping = mapping / np.maximum(1.0e-12, mapping_denom)
    else:
        mapping = mapping / mapping.sum(axis=0, keepdims=True)
    return mapping


def get_sw_mapping(specdef, wavelength_bound, use_bands=True):
    """Mapping matrix from SW bands/g-points to user wavelength
    intervals (radiation_config.F90:1766-1828 get_sw_mapping).

    wavelength_bound: (ninterval+1,) metres.  Returns
    (ninterval, nband|ng)."""
    import numpy as np
    ninterval = len(wavelength_bound) - 1
    diag_ind = list(range(1, ninterval + 3))
    mapping = specdef.calc_mapping_from_bands(
        list(wavelength_bound), diag_ind, use_bands=use_bands,
        use_fluxes=False)
    return np.asarray(mapping)[1:ninterval + 1]


def get_uv_biological_weights(specdef):
    """Per-g-point weights for the UV biologically effective flux
    (radiation_config.F90:1724-1764 get_uv_biological_weights): the
    McKinlay & Diffey (1987) erythemal action spectrum, log-interpolated
    onto the spectral definition's fine wavenumber grid, with any
    wavelength below 298 nm given weight 1.  Divide the resulting flux
    by 40 to obtain the UV index.

    Requires a g-point-resolved spectral definition (ecCKD); RRTMG's
    band-only definition aborts as in the reference.

    Returns (ig, weight) for the non-zero g-points."""
    import numpy as np
    if specdef.gpoint_fraction.shape[0] != specdef.nwav \
            or specdef.nwav == specdef.nband:
        # bands_only definitions have no fine grid — reference aborts
        # (radiation_spectral_definition.F90:963-967)
        raise ValueError("UV biological weights require a g-point "
                         "spectral definition (ecCKD gas optics)")
    weight_g = specdef.weighted_mapping(
        [1.0e-9, 298.0e-9, 328.0e-9, 400.0e-9],
        [1.0, 1.0, 0.0015136, 0.0001216], do_logarithmic=True)
    weight_g = np.asarray(weight_g)
    ig = np.nonzero(weight_g > 0.0)[0]
    return ig, weight_g[ig]


def get_sw_weights(specdef, wavelength1, wavelength2, use_bands=True):
    """Band indices + weights for a surface SW diagnostic in a
    wavelength range (radiation_config.F90:1625-1722 get_sw_weights):
    row 2 of calc_mapping_from_bands([wl1, wl2], [1, 2, 3],
    use_fluxes=true)."""
    import numpy as np
    mapping = specdef.calc_mapping_from_bands(
        [wavelength1, wavelength2], [1, 2, 3], use_bands=use_bands,
        use_fluxes=True)
    w = np.asarray(mapping[1])
    iband = np.nonzero(w > 0.0)[0]
    return iband, w[iband]
