"""Adding-method flux sweeps with on-the-fly broadband reduction
(reference: radiation_adding_ica_sw.F90:24-153,
radiation_adding_ica_lw.F90:32-334).

The functions of ``ecrad_tpu/solvers/adding.py`` in the form of its Pallas
path: each assembles its result from one of the sweep functions of
``solvers/cuda_adding.py`` (a CUDA kernel on the card, a torch loop over
levels on the CPU).  Level axis: index 0 = top of atmosphere; layer arrays
``(ncol, nlev, ng)``, surface planes ``(ncol, ng)`` (an albedo may be
``(ncol, 1)``).  Profiles are broadband ``(ncol, nlev+1)``; g-resolved data
exists only at the surface and TOA.  The three adding kernels write no
per-g planes yet, so these functions take no spectral projection
(``spec_matrix``): the routes through them raise for spectral flux output
(``no_spectral_projection``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ecrad_torch.solvers import cuda_adding


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


def no_spectral_projection(spec_matrix, route: str) -> None:
    """Raise for spectral flux output on a route that runs the adding
    sweeps: their kernels write no per-g planes (there is no plain torch
    route on the card to fall back to)."""
    if spec_matrix is not None:
        raise NotImplementedError(
            f"spectral flux output is not ported for the {route} route: it "
            "runs the adding-sweep kernels (csrc/adding_sweeps.cu: "
            "lw_noscat_sweeps, scat_sweeps, sw_sweeps), which write no per-g "
            "planes yet")


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
                      trans_dir_diff, trans_dir_dir) -> SwAdding:
    """SW adding; cos_sza (ncol, 1) broadcasting against (ncol, ng)."""
    shape = incoming_toa.shape
    c = lambda x: x.contiguous()
    r = cuda_adding.sw_sweeps(
        c(reflectance), c(transmittance), c(ref_dir), c(trans_dir_diff),
        c(trans_dir_dir), c(incoming_toa), _plane(albedo_surf_diffuse, shape),
        _plane(albedo_surf_direct * cos_sza, shape))
    mu0_bb = cos_sza[:, 0]
    src_top = r["src_top"]
    up_toa_bb = src_top.sum(-1)
    return SwAdding(
        up=_stack_top(up_toa_bb, r["up_bb"]),
        dn_diffuse=_stack_top(torch.zeros_like(up_toa_bb), r["dn_bb"]),
        dn_direct=_stack_top(incoming_toa.sum(-1),
                             r["dir_bb"]) * mu0_bb[:, None],
        up_toa_g=src_top,
        dn_diffuse_surf_g=r["fdn_surf"],
        dn_direct_surf_g=r["fdir_surf"] * cos_sza)


def adding_lw_reduced(reflectance, transmittance, source_up, source_dn,
                      emission_surf, albedo_surf) -> LwAdding:
    """LW adding with scattering (radiation_adding_ica_lw.F90:32-134)."""
    albedo_surf = _plane(albedo_surf, emission_surf.shape)
    c = lambda x: x.contiguous()
    r = cuda_adding.scat_sweeps(
        c(reflectance), c(transmittance), c(source_up), c(source_dn),
        albedo_surf, c(emission_surf))
    src_top, fdn_surf = r["src_top"], r["fdn_surf"]
    up_toa_bb = src_top.sum(-1)
    return LwAdding(
        up=_stack_top(up_toa_bb, r["up_bb"]),
        dn=_stack_top(torch.zeros_like(up_toa_bb), r["dn_bb"]),
        up_toa_g=src_top, dn_surf_g=fdn_surf,
        up_surf_g=albedo_surf * fdn_surf + emission_surf)


def lw_no_scattering_reduced(transmittance, source_up, source_dn,
                             emission_surf, albedo_surf) -> LwAdding:
    """No-scattering LW recurrences (radiation_adding_ica_lw.F90:272-334)."""
    c = lambda x: x.contiguous()
    r = cuda_adding.lw_noscat_sweeps(
        c(transmittance), c(source_up), c(source_dn), c(emission_surf),
        _plane(albedo_surf, emission_surf.shape))
    fup_surf = r["fup_surf"]
    surf_up_bb = fup_surf.sum(-1)
    return LwAdding(
        up=_stack_bot(r["up_bb"], surf_up_bb),
        dn=_stack_top(torch.zeros_like(surf_up_bb), r["dn_bb"]),
        up_toa_g=r["fup_toa"], dn_surf_g=r["fdn_surf"], up_surf_g=fup_surf)
