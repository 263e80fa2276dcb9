"""Adding-method flux sweeps with on-the-fly broadband reduction
(reference: radiation_adding_ica_sw.F90:24-153,
radiation_adding_ica_lw.F90:32-334).

The sequential forms of ``ecrad_tpu/solvers/adding.py`` (its ``lax.scan``
path) as torch loops over levels.  Level axis: index 0 = top of
atmosphere; layer arrays ``(ncol, nlev, ng)``, surface planes
``(ncol, ng)``.  Profiles are broadband ``(ncol, nlev+1)``; g-resolved
data exists only at the surface and TOA.  Spectral projections
(``spec_matrix``) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SwAdding(NamedTuple):
    """Reduced SW adding output: broadband profiles + boundary g slices."""
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn_diffuse: torch.Tensor
    dn_direct: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_diffuse_surf_g: torch.Tensor
    dn_direct_surf_g: torch.Tensor


class LwAdding(NamedTuple):
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_surf_g: torch.Tensor
    up_surf_g: torch.Tensor          # for LW derivatives


def _stack_top(top, levels):
    """top (ncol,) + levels (ncol, nlev) -> (ncol, nlev+1)."""
    return torch.cat([top[:, None], levels], dim=1)


def _stack_bot(levels, bottom):
    return torch.cat([levels, bottom[:, None]], dim=1)


def adding_sw_reduced(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                      cos_sza, reflectance, transmittance, ref_dir,
                      trans_dir_diff, trans_dir_dir) -> SwAdding:
    """SW adding; cos_sza (ncol, 1) broadcasting against (ncol, ng)."""
    nlev = reflectance.shape[1]
    # 1) direct beam down
    fdir = incoming_toa
    fdir_top, fdir_bb = [], []
    for l in range(nlev):
        fdir_top.append(fdir)
        fdir = fdir * trans_dir_dir[:, l]
        fdir_bb.append(fdir.sum(-1))
    fdir_surf = fdir

    # 2) up: albedo of the atmosphere below + upwelling source
    albedo = torch.broadcast_to(albedo_surf_diffuse, incoming_toa.shape)
    source = albedo_surf_direct * fdir_surf * cos_sza
    alb_below, src_below, inv_denom = ([None] * nlev for _ in range(3))
    for l in range(nlev - 1, -1, -1):
        refl, trans = reflectance[:, l], transmittance[:, l]
        inv = 1.0 / (1.0 - albedo * refl)
        alb_below[l], src_below[l], inv_denom[l] = albedo, source, inv
        albedo, source = (
            refl + trans * trans * albedo * inv,
            ref_dir[:, l] * fdir_top[l] + trans * (
                source + albedo * trans_dir_diff[:, l] * fdir_top[l]) * inv)
    source_top = source

    # 3) diffuse down, reduced per level
    fdn = torch.zeros_like(incoming_toa)
    dn_bb, up_bb = [], []
    for l in range(nlev):
        fdn = (transmittance[:, l] * fdn + reflectance[:, l] * src_below[l]
               + trans_dir_diff[:, l] * fdir_top[l]) * inv_denom[l]
        dn_bb.append(fdn.sum(-1))
        up_bb.append((alb_below[l] * fdn + src_below[l]).sum(-1))

    mu0_bb = cos_sza[:, 0]
    up_toa_bb = source_top.sum(-1)
    return SwAdding(
        up=_stack_top(up_toa_bb, torch.stack(up_bb, dim=1)),
        dn_diffuse=_stack_top(torch.zeros_like(up_toa_bb),
                              torch.stack(dn_bb, dim=1)),
        dn_direct=_stack_top(incoming_toa.sum(-1),
                             torch.stack(fdir_bb, dim=1)) * mu0_bb[:, None],
        up_toa_g=source_top,
        dn_diffuse_surf_g=fdn,
        dn_direct_surf_g=fdir_surf * cos_sza)


def adding_lw_reduced(reflectance, transmittance, source_up, source_dn,
                      emission_surf, albedo_surf) -> LwAdding:
    """LW adding with scattering (radiation_adding_ica_lw.F90:32-134)."""
    nlev = reflectance.shape[1]
    albedo_surf = torch.broadcast_to(albedo_surf, emission_surf.shape)
    albedo, source = albedo_surf, emission_surf
    alb_below, src_below, inv_denom = ([None] * nlev for _ in range(3))
    for l in range(nlev - 1, -1, -1):
        refl, trans = reflectance[:, l], transmittance[:, l]
        inv = 1.0 / (1.0 - albedo * refl)
        alb_below[l], src_below[l], inv_denom[l] = albedo, source, inv
        albedo, source = (
            refl + trans * trans * albedo * inv,
            source_up[:, l] + trans * (source + albedo * source_dn[:, l])
            * inv)
    source_top = source

    fdn = torch.zeros_like(emission_surf)
    dn_bb, up_bb = [], []
    for l in range(nlev):
        fdn = (transmittance[:, l] * fdn + reflectance[:, l] * src_below[l]
               + source_dn[:, l]) * inv_denom[l]
        dn_bb.append(fdn.sum(-1))
        up_bb.append((alb_below[l] * fdn + src_below[l]).sum(-1))
    fup_surf_g = albedo_surf * fdn + emission_surf

    up_toa_bb = source_top.sum(-1)
    return LwAdding(
        up=_stack_top(up_toa_bb, torch.stack(up_bb, dim=1)),
        dn=_stack_top(torch.zeros_like(up_toa_bb),
                      torch.stack(dn_bb, dim=1)),
        up_toa_g=source_top, dn_surf_g=fdn, up_surf_g=fup_surf_g)


def lw_no_scattering_reduced(transmittance, source_up, source_dn,
                             emission_surf, albedo_surf) -> LwAdding:
    """No-scattering LW recurrences (radiation_adding_ica_lw.F90:272-334)."""
    nlev = transmittance.shape[1]
    albedo_surf = torch.broadcast_to(albedo_surf, emission_surf.shape)
    fdn = torch.zeros_like(emission_surf)
    dn_bb = []
    for l in range(nlev):
        fdn = transmittance[:, l] * fdn + source_dn[:, l]
        dn_bb.append(fdn.sum(-1))
    fup_surf = emission_surf + albedo_surf * fdn

    fup = fup_surf
    up_bb = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        fup = transmittance[:, l] * fup + source_up[:, l]
        up_bb[l] = fup.sum(-1)

    surf_up_bb = fup_surf.sum(-1)
    return LwAdding(
        up=_stack_bot(torch.stack(up_bb, dim=1), surf_up_bb),
        dn=_stack_top(torch.zeros_like(surf_up_bb),
                      torch.stack(dn_bb, dim=1)),
        up_toa_g=fup, dn_surf_g=fdn, up_surf_g=fup_surf)
