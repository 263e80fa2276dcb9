"""Adding-method flux sweeps with on-the-fly broadband reduction
(reference: radiation_adding_ica_sw.F90:24-153,
radiation_adding_ica_lw.F90:32-334).

The functions of ``ecrad_tpu/solvers/adding.py`` in the form of its Pallas
path: each assembles its result from one of the sweep functions of
``solvers/cuda_adding.py`` (a CUDA kernel on the card, a torch loop over
levels on the CPU).  Level axis: index 0 = top of atmosphere; layer arrays
``(ncol, nlev, ng)``, surface planes ``(ncol, ng)`` (an albedo may be
``(ncol, 1)``).  Profiles are broadband ``(ncol, nlev+1)``; g-resolved data
exists at the surface and TOA, and, with an ``(ng, nspec)`` 0/1
``spec_matrix`` (spectral flux output), as the ``*_s`` profiles
``(ncol, nlev+1, nspec)``: the sweeps' per-g planes (their kernels' build
with planes on the card) projected outside them by ``outputs.project``,
the fields of ``ecrad_tpu/solvers/adding.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ecrad_torch.solvers import cuda_adding
from ecrad_torch.solvers.outputs import project


class SwAdding(NamedTuple):
    """Reduced SW adding output: broadband profiles + boundary g slices."""
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn_diffuse: torch.Tensor
    dn_direct: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_diffuse_surf_g: torch.Tensor
    dn_direct_surf_g: torch.Tensor
    up_s: Optional[torch.Tensor] = None      # (ncol, nlev+1, nspec)
    dn_diffuse_s: Optional[torch.Tensor] = None
    dn_direct_s: Optional[torch.Tensor] = None


class LwAdding(NamedTuple):
    up: torch.Tensor                 # (ncol, nlev+1) broadband
    dn: torch.Tensor
    up_toa_g: torch.Tensor           # (ncol, ng)
    dn_surf_g: torch.Tensor
    up_surf_g: torch.Tensor          # for LW derivatives
    up_s: Optional[torch.Tensor] = None      # (ncol, nlev+1, nspec)
    dn_s: Optional[torch.Tensor] = None


def _stack_top(top, levels):
    """top (ncol,) + levels (ncol, nlev) -> (ncol, nlev+1)."""
    return torch.cat([top[:, None], levels], dim=1)


def _stack_bot(levels, bottom):
    return torch.cat([levels, bottom[:, None]], dim=1)


def _plane(x, shape):
    """x broadcast to shape, contiguous, as the kernels read it."""
    return torch.broadcast_to(x, shape).contiguous()


def adding_sw_reduced(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                      cos_sza, reflectance, transmittance, ref_dir,
                      trans_dir_diff, trans_dir_dir,
                      spec_matrix=None) -> SwAdding:
    """SW adding; cos_sza (ncol, 1) broadcasting against (ncol, ng).  With
    spec_matrix the projected up, diffuse down and direct down profiles
    (the direct times mu0 after the projection, as the broadband one)."""
    shape = incoming_toa.shape
    c = lambda x: x.contiguous()
    spectral = spec_matrix is not None
    r = cuda_adding.sw_sweeps(
        c(reflectance), c(transmittance), c(ref_dir), c(trans_dir_diff),
        c(trans_dir_dir), c(incoming_toa), _plane(albedo_surf_diffuse, shape),
        _plane(albedo_surf_direct * cos_sza, shape), planes=spectral)
    mu0_bb = cos_sza[:, 0]
    src_top = r["src_top"]
    up_toa_bb = src_top.sum(-1)
    proj = lambda k: project(r.get(k), spec_matrix)  # noqa: E731
    return SwAdding(
        up=_stack_top(up_toa_bb, r["up_bb"]),
        dn_diffuse=_stack_top(torch.zeros_like(up_toa_bb), r["dn_bb"]),
        dn_direct=_stack_top(incoming_toa.sum(-1),
                             r["dir_bb"]) * mu0_bb[:, None],
        up_toa_g=src_top,
        dn_diffuse_surf_g=r["fdn_surf"],
        dn_direct_surf_g=r["fdir_surf"] * cos_sza,
        up_s=proj("up_g"), dn_diffuse_s=proj("dn_g"),
        dn_direct_s=(proj("dir_g") * mu0_bb[:, None, None] if spectral
                     else None))


def adding_lw_reduced(reflectance, transmittance, source_up, source_dn,
                      emission_surf, albedo_surf,
                      spec_matrix=None) -> LwAdding:
    """LW adding with scattering (radiation_adding_ica_lw.F90:32-134);
    with spec_matrix the projected up and down profiles."""
    albedo_surf = _plane(albedo_surf, emission_surf.shape)
    c = lambda x: x.contiguous()
    r = cuda_adding.scat_sweeps(
        c(reflectance), c(transmittance), c(source_up), c(source_dn),
        albedo_surf, c(emission_surf), planes=spec_matrix is not None)
    src_top, fdn_surf = r["src_top"], r["fdn_surf"]
    up_toa_bb = src_top.sum(-1)
    return LwAdding(
        up=_stack_top(up_toa_bb, r["up_bb"]),
        dn=_stack_top(torch.zeros_like(up_toa_bb), r["dn_bb"]),
        up_toa_g=src_top, dn_surf_g=fdn_surf,
        up_surf_g=albedo_surf * fdn_surf + emission_surf,
        up_s=project(r.get("up_g"), spec_matrix),
        dn_s=project(r.get("dn_g"), spec_matrix))


def lw_no_scattering_reduced(transmittance, source_up, source_dn,
                             emission_surf, albedo_surf,
                             spec_matrix=None) -> LwAdding:
    """No-scattering LW recurrences (radiation_adding_ica_lw.F90:272-334);
    with spec_matrix the projected up and down profiles."""
    c = lambda x: x.contiguous()
    r = cuda_adding.lw_noscat_sweeps(
        c(transmittance), c(source_up), c(source_dn), c(emission_surf),
        _plane(albedo_surf, emission_surf.shape),
        planes=spec_matrix is not None)
    fup_surf = r["fup_surf"]
    surf_up_bb = fup_surf.sum(-1)
    return LwAdding(
        up=_stack_bot(r["up_bb"], surf_up_bb),
        dn=_stack_top(torch.zeros_like(surf_up_bb), r["dn_bb"]),
        up_toa_g=r["fup_toa"], dn_surf_g=r["fdn_surf"], up_surf_g=fup_surf,
        up_s=project(r.get("up_g"), spec_matrix),
        dn_s=project(r.get("dn_g"), spec_matrix))
