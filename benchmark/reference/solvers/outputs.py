"""Unified solver output contract (as ``ecrad_tpu/solvers/outputs.py``).

Profiles are broadband ``(ncol, nlev+1)``; spectrally resolved data
exists as surface/TOA g slices ``(ncol, ng)`` and, when spectral flux
output is asked for, as ``*_s`` profiles ``(ncol, nlev+1, nspec)``: the
per-g half-level fluxes projected through an ``(ng, nspec)`` matrix of
zeros and ones (the one-hot band map, or the identity for g-point
output).  The fused kernels write the per-g planes only when asked
(``planes=True`` of their wrappers), and the projection is a matrix
product outside them (``project``).
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
    # spectral profiles (ncol, nlev+1, nspec), set iff a spec_matrix is given
    flux_up_s: Optional[torch.Tensor] = None
    flux_dn_s: Optional[torch.Tensor] = None
    flux_up_clear_s: Optional[torch.Tensor] = None
    flux_dn_clear_s: Optional[torch.Tensor] = None


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
    flux_up_s: Optional[torch.Tensor] = None
    flux_dn_s: Optional[torch.Tensor] = None
    flux_dn_direct_s: Optional[torch.Tensor] = None
    flux_up_clear_s: Optional[torch.Tensor] = None
    flux_dn_clear_s: Optional[torch.Tensor] = None
    flux_dn_direct_clear_s: Optional[torch.Tensor] = None


def is_identity(spec_matrix) -> bool:
    """Whether an (ng, nspec) projection is the identity (g-point output),
    which project() skips."""
    n = spec_matrix.shape[0]
    return spec_matrix.shape[1] == n and torch.equal(
        spec_matrix, torch.eye(n, dtype=spec_matrix.dtype,
                               device=spec_matrix.device))


def project(x_g, spec_matrix):
    """Per-g fluxes (..., ng) projected onto (..., nspec) through a 0/1
    matrix, in their own dtype and never in TF32 (a matrix product, which
    sums in a fixed order on every device); the identity is skipped.  None
    without a matrix."""
    if spec_matrix is None:
        return None
    if is_identity(spec_matrix):
        return x_g
    m = spec_matrix.to(x_g.dtype)
    lead = x_g.shape[:-1]
    flat = x_g.reshape(-1, x_g.shape[-1])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = flat @ m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.reshape(*lead, m.shape[1])
