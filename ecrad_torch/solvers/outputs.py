"""Unified solver output contract (as ``ecrad_tpu/solvers/outputs.py``).

Profiles are broadband ``(ncol, nlev+1)``; spectrally resolved data
exists only as surface/TOA g slices ``(ncol, ng)``.  The spectral
``*_s`` profiles of the JAX package are not ported, so the two adapters
below take no spectral projection.
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


def lw_from_g_profiles(*, flux_up_g, flux_dn_g, flux_up_clear_g,
                       flux_dn_clear_g, cloud_cover,
                       lw_derivatives=None) -> LwFluxes:
    """LwFluxes from g-resolved half-level profiles (ncol, nlev+1, ng), for
    solvers that build them (SPARTACUS)."""
    return LwFluxes(
        flux_up=flux_up_g.sum(-1), flux_dn=flux_dn_g.sum(-1),
        flux_up_clear=flux_up_clear_g.sum(-1),
        flux_dn_clear=flux_dn_clear_g.sum(-1),
        lw_dn_surf_g=flux_dn_g[:, -1, :], lw_up_toa_g=flux_up_g[:, 0, :],
        lw_dn_surf_clear_g=flux_dn_clear_g[:, -1, :],
        lw_up_toa_clear_g=flux_up_clear_g[:, 0, :],
        cloud_cover=cloud_cover, lw_derivatives=lw_derivatives)


def sw_from_g_profiles(*, flux_up_g, flux_dn_diffuse_g, flux_dn_direct_g,
                       flux_up_clear_g, flux_dn_diffuse_clear_g,
                       flux_dn_direct_clear_g, cloud_cover) -> SwFluxes:
    """SwFluxes from g-resolved half-level profiles (ncol, nlev+1, ng)."""
    flux_dn_g = flux_dn_diffuse_g + flux_dn_direct_g
    flux_dn_clear_g = flux_dn_diffuse_clear_g + flux_dn_direct_clear_g
    return SwFluxes(
        flux_up=flux_up_g.sum(-1), flux_dn=flux_dn_g.sum(-1),
        flux_dn_direct=flux_dn_direct_g.sum(-1),
        flux_up_clear=flux_up_clear_g.sum(-1),
        flux_dn_clear=flux_dn_clear_g.sum(-1),
        flux_dn_direct_clear=flux_dn_direct_clear_g.sum(-1),
        sw_dn_diffuse_surf_g=flux_dn_diffuse_g[:, -1, :],
        sw_dn_direct_surf_g=flux_dn_direct_g[:, -1, :],
        sw_up_toa_g=flux_up_g[:, 0, :],
        sw_dn_diffuse_surf_clear_g=flux_dn_diffuse_clear_g[:, -1, :],
        sw_dn_direct_surf_clear_g=flux_dn_direct_clear_g[:, -1, :],
        sw_up_toa_clear_g=flux_up_clear_g[:, 0, :],
        cloud_cover=cloud_cover)
