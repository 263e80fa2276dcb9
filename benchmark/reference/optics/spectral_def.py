"""Full spectral definition with per-g-point wavenumber fractions.

Reference: radiation/radiation_spectral_definition.F90 — used by the ecCKD
gas optics model, general cloud optics and general aerosol optics to map
high-resolution spectral data onto the model's g-points (calc_mapping
L222-380) and to weight surface albedo/emissivity intervals per g-point
(calc_mapping_from_bands L515-822, per-g branch).  Host-side NumPy (setup
only).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.optics.spectral import (
    SOLAR_REFERENCE_TEMPERATURE, TERRESTRIAL_REFERENCE_TEMPERATURE,
    planck_function_wavenumber,
)


class SpectralDefinition:
    def __init__(self, wavenumber1, wavenumber2, gpoint_fraction,
                 wavenumber1_band, wavenumber2_band, band_number,
                 solar_irradiance=None, solar_spectral_irradiance=None):
        self.wavenumber1 = np.asarray(wavenumber1, np.float64)
        self.wavenumber2 = np.asarray(wavenumber2, np.float64)
        # stored (nwav, ng) as in the Fortran (file is (g, wav) C-order)
        self.gpoint_fraction = np.asarray(gpoint_fraction, np.float64)
        self.wavenumber1_band = np.asarray(wavenumber1_band, np.float64)
        self.wavenumber2_band = np.asarray(wavenumber2_band, np.float64)
        self.band_number = np.asarray(band_number, int)   # 0-based per g
        self.solar_irradiance = solar_irradiance
        self.solar_spectral_irradiance = solar_spectral_irradiance
        self.nwav = self.wavenumber1.size
        self.ng = self.gpoint_fraction.shape[1]
        self.nband = self.wavenumber1_band.size
        self.reference_temperature = (
            SOLAR_REFERENCE_TEMPERATURE if solar_irradiance is not None
            else TERRESTRIAL_REFERENCE_TEMPERATURE)

    @classmethod
    def bands_only(cls, wavenumber1_band, wavenumber2_band, is_solar):
        """Band-bounds-only definition, as the RRTMG gas optics allocates
        (radiation_spectral_definition.F90 allocate_bands_only, called at
        radiation_ifs_rrtm.F90:111-115,155-159).  One pseudo-g-point per
        band so band-wise mappings work unchanged."""
        nband = len(wavenumber1_band)
        sd = cls(wavenumber1_band, wavenumber2_band, np.eye(nband),
                 wavenumber1_band, wavenumber2_band, np.arange(nband),
                 solar_irradiance=(1.0 if is_solar else None))
        sd.solar_irradiance = None
        sd.reference_temperature = (
            SOLAR_REFERENCE_TEMPERATURE if is_solar
            else TERRESTRIAL_REFERENCE_TEMPERATURE)
        return sd

    @classmethod
    def from_file(cls, f):
        """Read from an open NcFile (radiation_spectral_definition.F90
        read L91-140)."""
        kw = {}
        if f.exists("solar_irradiance"):
            kw["solar_irradiance"] = f.get("solar_irradiance")
        if f.exists("solar_spectral_irradiance"):
            kw["solar_spectral_irradiance"] = f.get(
                "solar_spectral_irradiance")
        return cls(
            f.get("wavenumber1"), f.get("wavenumber2"),
            f.get("gpoint_fraction").T,        # → (nwav, ng)
            f.get("wavenumber1_band"), f.get("wavenumber2_band"),
            f.get("band_number").astype(int), **kw)

    def find(self, wavenumber):
        """Index (0-based) of the fine interval containing wavenumber, or
        -1 (radiation_spectral_definition.F90:198-213)."""
        if wavenumber < self.wavenumber1[0] \
                or wavenumber > self.wavenumber2[-1]:
            return -1
        i = 0
        while wavenumber > self.wavenumber2[i] and i < self.nwav - 1:
            i += 1
        return i

    # ------------------------------------------------------------------
    def calc_mapping(self, wavenumber, weighting_temperature=None,
                     use_bands=False):
        """Mapping from a coarse wavenumber grid (cloud/aerosol data) to
        bands or g-points (radiation_spectral_definition.F90:222-380).

        Returns mapping (nband|ng, nwav_in), rows summing to 1."""
        wavenumber = np.asarray(wavenumber, np.float64)
        nwav_in = wavenumber.size

        if use_bands:
            if weighting_temperature is not None \
                    and weighting_temperature > 0.0:
                planck = planck_function_wavenumber(
                    wavenumber, weighting_temperature)
            else:
                planck = planck_function_wavenumber(
                    wavenumber, self.reference_temperature)
            mapping = np.zeros((self.nband, nwav_in))
            for jband in range(self.nband):
                w1b = self.wavenumber1_band[jband]
                w2b = self.wavenumber2_band[jband]
                weight = np.zeros(nwav_in)
                for jw in range(nwav_in):
                    if w1b <= wavenumber[jw] <= w2b:
                        wn1 = w1b if jw == 0 else max(
                            w1b, 0.5 * (wavenumber[jw - 1]
                                        + wavenumber[jw]))
                        wn2 = w2b if jw == nwav_in - 1 else min(
                            w2b, 0.5 * (wavenumber[jw]
                                        + wavenumber[jw + 1]))
                        weight[jw] = (wn2 - wn1) * planck[jw]
                if weight.sum() <= 0.0:
                    if wavenumber[0] >= w2b:
                        weight[0] = 1.0
                    elif wavenumber[-1] <= w1b:
                        weight[-1] = 1.0
                    else:
                        iwav = 1
                        while wavenumber[iwav] < w2b:
                            iwav += 1
                        mid = 0.5 * (w1b + w2b)
                        weight[iwav - 1] = planck[iwav - 1] \
                            * (wavenumber[iwav] - mid)
                        weight[iwav] = planck[iwav] \
                            * (mid - wavenumber[iwav - 1])
                mapping[jband] = weight / weight.sum()
            return mapping

        # --- per-g-point branch (L601-380 of reference):
        # distribute each coarse point's "hat" over the fine intervals
        if self.solar_spectral_irradiance is not None:
            planck = np.asarray(self.solar_spectral_irradiance, np.float64)
        else:
            wav_mid = 0.5 * (self.wavenumber1 + self.wavenumber2)
            planck = planck_function_wavenumber(
                wav_mid, self.reference_temperature)

        w1, w2 = self.wavenumber1, self.wavenumber2
        dw = w2 - w1
        mapping = np.zeros((self.ng, nwav_in))
        for jw in range(nwav_in):
            weight = np.zeros(self.nwav)
            wn1 = wavenumber[jw]
            isd1 = self.find(wn1)
            if isd1 < 0:
                continue
            if jw > 0:
                wn0 = wavenumber[jw - 1]
                isd0 = self.find(wn0)
                if isd0 == isd1:
                    weight[isd0] = 0.5 * (wn1 - wn0) / dw[isd0]
                else:
                    if isd0 >= 0:
                        weight[isd0] = 0.5 * (w2[isd0] - wn0) ** 2 \
                            / (dw[isd0] * (wn1 - wn0))
                    weight[isd1] = 0.5 * (1.0 + (w1[isd1] - wn1)
                                          / (wn1 - wn0)) \
                        * (wn1 - w1[isd1]) / dw[isd1]
                    for isd in range(isd0 + 1, isd1):
                        weight[isd] = 0.5 * (w1[isd] + w2[isd]
                                             - 2.0 * wn0) / (wn1 - wn0)
            else:
                weight[:isd1] = 1.0
                weight[isd1] = (wn1 - w1[isd1]) / dw[isd1]
            if jw < nwav_in - 1:
                wn2 = wavenumber[jw + 1]
                isd2 = self.find(wn2)
                if isd1 == isd2:
                    weight[isd1] += 0.5 * (wn2 - wn1) / dw[isd1]
                else:
                    if 0 <= isd2 < self.nwav:
                        weight[isd2] += 0.5 * (wn2 - w1[isd2]) ** 2 \
                            / (dw[isd2] * (wn2 - wn1))
                    weight[isd1] += 0.5 * (1.0 + (wn2 - w2[isd1])
                                           / (wn2 - wn1)) \
                        * (w2[isd1] - wn1) / dw[isd1]
                    for isd in range(isd1 + 1, isd2):
                        weight[isd] += 0.5 * (2.0 * wn2 - w1[isd]
                                              - w2[isd]) / (wn2 - wn1)
            else:
                weight[isd1 + 1:] = 1.0
                weight[isd1] = (w2[isd1] - wn1) / dw[isd1]
            weight = weight * planck
            mapping[:, jw] = weight @ self.gpoint_fraction
        norm = mapping.sum(axis=1, keepdims=True)
        return mapping / np.maximum(norm, 1e-300)

    # ------------------------------------------------------------------
    def weighted_mapping(self, wavelength, weights_in,
                         do_logarithmic=False):
        """Per-g-point weights for an arbitrary piecewise-linear spectral
        weighting function (radiation_spectral_definition.F90:886-972
        weighted_mapping): interpolate weights_in (defined at the given
        wavelengths, metres, increasing) onto the fine wavenumber grid
        (optionally in log space) and project through gpoint_fraction.

        Returns an array of shape (ng,)."""
        wavelength = np.asarray(wavelength, np.float64)
        weights_in = np.asarray(weights_in, np.float64)
        nwl = wavelength.size
        weights_wn = np.zeros(self.nwav)
        # wavelength of each fine wavenumber interval's midpoint
        wl_wn = 0.01 / (0.5 * (self.wavenumber1 + self.wavenumber2))
        iwn = self.nwav - 1
        while wavelength[0] > wl_wn[iwn] and iwn > 0:
            iwn -= 1
        for jwl in range(nwl - 1):
            if do_logarithmic:
                weight1 = np.log(weights_in[jwl])
                weight2 = np.log(weights_in[jwl + 1])
            else:
                # reference uses weights_in(jwl) for both endpoints in
                # the linear branch (i.e. piecewise-constant)
                weight1 = weight2 = weights_in[jwl]
            while wavelength[jwl + 1] > wl_wn[iwn]:
                w = ((weight1 * (wavelength[jwl + 1] - wl_wn[iwn])
                      + weight2 * (wl_wn[iwn] - wavelength[jwl]))
                     / (wavelength[jwl + 1] - wavelength[jwl]))
                weights_wn[iwn] = np.exp(w) if do_logarithmic else w
                if iwn > 0:
                    iwn -= 1
                else:
                    break
        return weights_wn @ self.gpoint_fraction

    # ------------------------------------------------------------------
    def calc_mapping_from_wavenumber_bands(self, wavenumber1, wavenumber2,
                                           use_bands=False,
                                           use_fluxes=False):
        """Mapping from a set of source *bands* (given by wavenumber
        bounds, any order) onto this spectral definition
        (radiation_spectral_definition.F90:818-877): sort the source
        bands by wavelength, express them as wavelength intervals and
        delegate to calc_mapping_from_bands.

        Returns mapping (n_source_band, nband|ng); transpose to map
        source-band data onto this grid as in
        radiation_aerosol_optics.F90:406-414."""
        wavenumber2 = np.asarray(wavenumber2, np.float64)
        wavelength1 = 0.01 / wavenumber2     # lower wavelength bound (m)
        ninterval = wavelength1.size
        order = np.argsort(wavelength1, kind="stable")
        i_intervals = order + 1              # 1-based source-band index
        wavelength_bound = wavelength1[order][1:]
        return self.calc_mapping_from_bands(
            wavelength_bound, i_intervals, use_bands=use_bands,
            use_fluxes=use_fluxes)

    # ------------------------------------------------------------------
    def calc_mapping_from_bands(self, wavelength_bound, i_intervals,
                                use_bands=False, use_fluxes=False,
                                equal_weighting=False):
        """Albedo/emissivity interval weights
        (radiation_spectral_definition.F90:515-822).

        equal_weighting: weight wavenumbers equally instead of by the
        Planck/solar spectrum (do_weighted_surface_mapping=false,
        radiation_config.F90:507-512).

        Returns mapping (ninput, nband|ng)."""
        i_intervals = np.asarray(i_intervals, int)
        ninterval = i_intervals.size
        ninput = i_intervals.max()
        wavelength_bound = np.asarray(wavelength_bound, np.float64)

        if use_bands:
            from benchmark.reference.optics.spectral import calc_mapping_from_bands
            return calc_mapping_from_bands(
                self.wavenumber1_band, self.wavenumber2_band,
                self.reference_temperature, wavelength_bound, i_intervals,
                use_fluxes=use_fluxes, equal_weighting=equal_weighting)

        # per-g branch: overlap of input intervals with each fine interval
        if equal_weighting:
            planck = np.ones(self.nwav)
        elif self.solar_spectral_irradiance is not None:
            planck = np.asarray(self.solar_spectral_irradiance, np.float64)
        else:
            wav_mid = 0.5 * (self.wavenumber1 + self.wavenumber2)
            planck = planck_function_wavenumber(
                wav_mid, self.reference_temperature)

        mapping = np.zeros((ninput, self.ng))
        for jint in range(ninterval):
            for jwav in range(self.nwav):
                if jint == 0:
                    wn2 = self.wavenumber2[jwav]
                else:
                    wn2 = min(self.wavenumber2[jwav],
                              0.01 / wavelength_bound[jint - 1])
                if jint == ninterval - 1:
                    wn1 = self.wavenumber1[jwav]
                else:
                    wn1 = max(self.wavenumber1[jwav],
                              0.01 / wavelength_bound[jint])
                if wn2 > wn1:
                    frac = (planck[jwav] * (wn2 - wn1)
                            / (self.wavenumber2[jwav]
                               - self.wavenumber1[jwav]))
                    mapping[i_intervals[jint] - 1] += \
                        self.gpoint_fraction[jwav] * frac
        if use_fluxes:
            denom = planck @ self.gpoint_fraction
            mapping = mapping / np.maximum(denom[None, :], 1e-300)
        else:
            mapping = mapping / mapping.sum(axis=0, keepdims=True)
        return mapping
