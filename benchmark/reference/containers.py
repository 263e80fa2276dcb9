"""Input/output containers (radiation_thermodynamics.F90,
radiation_flux.F90).

Layout as in the JAX package: column axis first, ``(ncol, nlev, ...)``,
spectral axes last, half-levels TOA first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Flux:
    """Output fluxes (radiation_flux.F90:38-110). All in W m-2.

    Level axis is half-levels, TOA first, ``(ncol, nlev+1)``; spectral
    axes last.  Only the fields the ported configurations fill are
    declared; which of them are set depends on the configuration (see
    ``fields``)."""
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
    # Spectral flux profiles, (ncol, nlev+1, nspec): per band with
    # do_save_spectral_flux, per g-point with do_save_gpoint_flux
    lw_up_band: Optional[torch.Tensor] = None
    lw_dn_band: Optional[torch.Tensor] = None
    sw_up_band: Optional[torch.Tensor] = None
    sw_dn_band: Optional[torch.Tensor] = None
    sw_dn_direct_band: Optional[torch.Tensor] = None
    lw_up_clear_band: Optional[torch.Tensor] = None
    lw_dn_clear_band: Optional[torch.Tensor] = None
    sw_up_clear_band: Optional[torch.Tensor] = None
    sw_dn_clear_band: Optional[torch.Tensor] = None
    sw_dn_direct_clear_band: Optional[torch.Tensor] = None
    # Surface spectral diagnostics, (ncol, nband)
    sw_dn_surf_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_band: Optional[torch.Tensor] = None
    sw_dn_surf_clear_band: Optional[torch.Tensor] = None
    sw_dn_direct_surf_clear_band: Optional[torch.Tensor] = None
    # TOA spectral diagnostics (do_toa_spectral_flux), (ncol, nband)
    sw_dn_toa_band: Optional[torch.Tensor] = None
    sw_up_toa_band: Optional[torch.Tensor] = None
    sw_up_toa_clear_band: Optional[torch.Tensor] = None
    lw_up_toa_band: Optional[torch.Tensor] = None
    lw_up_toa_clear_band: Optional[torch.Tensor] = None
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
