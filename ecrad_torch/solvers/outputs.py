"""Unified solver output contract (as ``ecrad_tpu/solvers/outputs.py``).

Profiles are broadband ``(ncol, nlev+1)``; spectrally resolved data
exists only as surface/TOA g slices ``(ncol, ng)``.  The spectral
``*_s`` profiles of the JAX package are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LwFluxes(NamedTuple):
    flux_up: torch.Tensor                # (ncol, nlev+1) broadband
    flux_dn: torch.Tensor
    flux_up_clear: torch.Tensor
    flux_dn_clear: torch.Tensor
    lw_dn_surf_g: torch.Tensor           # (ncol, ng)
    lw_up_toa_g: torch.Tensor
    lw_dn_surf_clear_g: torch.Tensor
    lw_up_toa_clear_g: torch.Tensor
    cloud_cover: torch.Tensor            # (ncol,)
    lw_derivatives: Optional[torch.Tensor] = None


class SwFluxes(NamedTuple):
    flux_up: torch.Tensor                # (ncol, nlev+1) broadband
    flux_dn: torch.Tensor                # diffuse + direct
    flux_dn_direct: torch.Tensor
    flux_up_clear: torch.Tensor
    flux_dn_clear: torch.Tensor
    flux_dn_direct_clear: torch.Tensor
    sw_dn_diffuse_surf_g: torch.Tensor   # (ncol, ng)
    sw_dn_direct_surf_g: torch.Tensor
    sw_up_toa_g: torch.Tensor
    sw_dn_diffuse_surf_clear_g: torch.Tensor
    sw_dn_direct_surf_clear_g: torch.Tensor
    sw_up_toa_clear_g: torch.Tensor
    cloud_cover: torch.Tensor
