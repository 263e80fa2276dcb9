"""Input/output containers (radiation_thermodynamics.F90,
radiation_flux.F90).

Layout as in the JAX package: column axis first, ``(ncol, nlev, ...)``,
spectral axes last, half-levels TOA first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Thermodynamics:
    """radiation_thermodynamics.F90:29-48 (host-side numpy arrays)."""
    pressure_hl: np.ndarray        # (ncol, nlev+1) Pa, TOA first
    temperature_hl: np.ndarray     # (ncol, nlev+1) K


@dataclasses.dataclass
class Flux:
    """Output fluxes (radiation_flux.F90:38-110). All in W m-2.

    Level axis is half-levels, TOA first, ``(ncol, nlev+1)``.  Only the
    fields the ported configurations fill are declared."""
    lw_up: Optional[torch.Tensor] = None
    lw_dn: Optional[torch.Tensor] = None
    sw_up: Optional[torch.Tensor] = None
    sw_dn: Optional[torch.Tensor] = None
    sw_dn_direct: Optional[torch.Tensor] = None
    lw_up_clear: Optional[torch.Tensor] = None
    lw_dn_clear: Optional[torch.Tensor] = None
    sw_up_clear: Optional[torch.Tensor] = None
    sw_dn_clear: Optional[torch.Tensor] = None
    sw_dn_direct_clear: Optional[torch.Tensor] = None
    # Surface spectral diagnostics, (ncol, nband)
    sw_dn_surf_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_band: Optional[torch.Tensor] = None
    sw_dn_surf_clear_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_clear_band: Optional[torch.Tensor] = None
    # Canopy fluxes, (ncol, n_canopy_bands)
    lw_dn_surf_canopy: Optional[torch.Tensor] = None
    sw_dn_diffuse_surf_canopy: Optional[torch.Tensor] = None
    sw_dn_direct_surf_canopy: Optional[torch.Tensor] = None
    # Diagnostics
    cloud_cover_lw: Optional[torch.Tensor] = None   # (ncol,)
    cloud_cover_sw: Optional[torch.Tensor] = None
    lw_derivatives: Optional[torch.Tensor] = None   # (ncol, nlev+1)

    def fields(self) -> dict:
        """The fields that are set, by name."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}
