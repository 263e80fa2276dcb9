"""Planck function integrated over emissivity wavelength intervals (port
of ``ecrad_tpu/ifs/spectral_planck.py``).

Reference: ifs/yoe_spectral_planck.F90 — a (ninterval, ntemp) look-up
table built at setup by Simpson integration of the Planck function over
each wavelength range (150..350 K in 1 K steps), evaluated at runtime by
linear interpolation and renormalized so the intervals sum to
sigma*T^4.  The table is host numpy, built once; ``calc`` runs on the
temperature tensor's device, in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# ifsaux/yomcst_ecrad.F90
RPI = np.pi
RHPLA = 6.6260755e-34
RCLUM = 299792458.0
RKBOL = 1.380658e-23
RSIGMA = 5.67037321e-8


class SpectralPlanck:
    """yoe_spectral_planck.F90 TSPECTRALPLANCK."""

    def __init__(self, wavelength_bounds, interval_map, nintervals=None):
        """wavelength_bounds (nranges-1,) in metres; interval_map
        (nranges,) of 1-based interval indices (as the Fortran)."""
        interval_map = np.asarray(interval_map, int)
        self.nintervals = int(nintervals or interval_map.max())
        self.temp1 = 150.0
        self.dtemp = 1.0
        self.ntemps = 1 + round((350.0 - self.temp1) / self.dtemp)
        if self.nintervals == 1:
            self.lut = None
            return
        bounds = np.asarray(wavelength_bounds, float)
        nranges = interval_map.size
        coeff1 = 2.0 * RPI * RHPLA * RCLUM * RCLUM
        coeff2 = RHPLA * RCLUM / RKBOL
        lut = np.zeros((self.nintervals, self.ntemps))
        temps = self.temp1 + self.dtemp * np.arange(self.ntemps)
        for jr in range(nranges):
            if jr == 0:
                w1 = min(1.0e-6, 0.8 * bounds[0])
                w2 = bounds[0]
            elif jr == nranges - 1:
                w1 = bounds[-1]
                w2 = max(200.0e-6, bounds[-1] + 20.0e-6)
            else:
                w1 = bounds[jr - 1]
                w2 = bounds[jr]
            n = 100
            dw = (w2 - w1) / n
            jw = np.arange(n + 1)
            wav = w1 + dw * jw
            # Simpson weights 1,4,2,4,...,4,1
            wt = np.where((jw > 0) & (jw < n), 2.0 + 2.0 * (jw % 2), 1.0)
            planck = 1.0 / (wav[None, :] ** 5
                            * (np.exp(coeff2 / (wav[None, :]
                                                * temps[:, None])) - 1.0))
            lut[interval_map[jr] - 1] += coeff1 * (planck * wt).sum(1) \
                * dw / 3.0
        self.lut = lut

    def calc(self, temperature):
        """Per-interval Planck emission (ncol, nintervals), normalized to
        sigma*T^4 (yoe_spectral_planck.F90 CALC)."""
        t = temperature
        if self.lut is None:
            return (RSIGMA * t ** 4)[:, None]
        lut = torch.as_tensor(self.lut.T, dtype=t.dtype,
                              device=t.device)      # (ntemps, nintervals)
        pos = 1.0 + (t - self.temp1) / self.dtemp
        itemp = torch.clamp(torch.round(pos).to(torch.int64), 1,
                            self.ntemps - 1)
        weight = pos - itemp
        weight = torch.where(t <= self.temp1, torch.zeros_like(weight),
                             weight)
        p = lut[itemp - 1] + weight[:, None] * (lut[itemp] - lut[itemp - 1])
        return p * (RSIGMA * t ** 4 / torch.sum(p, -1))[:, None]
