"""Hogan & Bozzo (2015) longwave derivatives
(reference: radiation_lw_derivatives.F90).

d(flux_up at each half level)/d(flux_up at surface), used by host models
for approximate radiation updates between full radiation calls.
"""

from __future__ import annotations

import torch


def lw_derivatives_ica(transmittance, flux_up_surf):
    """ICA form (radiation_lw_derivatives.F90:43-83).

    Args:
      transmittance: (ncol, nlev, ng)
      flux_up_surf: (ncol, ng) upwelling surface flux per g-point
    Returns lw_derivatives (ncol, nlev+1), surface value 1.
    """
    nlev = transmittance.shape[1]
    deriv_g = flux_up_surf / flux_up_surf.sum(-1, keepdim=True)
    levels = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        deriv_g = deriv_g * transmittance[:, l]
        levels[l] = deriv_g.sum(-1)
    ones = torch.ones_like(flux_up_surf[:, :1])
    return torch.cat([torch.stack(levels, dim=1), ones], dim=1)
