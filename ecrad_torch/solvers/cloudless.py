"""Clear-sky-only solvers (reference: radiation_cloudless_lw.F90:24-181,
radiation_cloudless_sw.F90:27-247); port of
``ecrad_tpu/solvers/cloudless.py``.

Batched over columns; the vertical sweeps are those of ``solvers/adding``
(the adding kernels of ``csrc/adding_sweeps.cu`` on the card).  The clear
and total-sky outputs are the same fluxes.  Night columns are zeroed at
the end (the reference skips them in its column loop).
"""

from __future__ import annotations

import torch

from ecrad_torch.solvers import adding, two_stream
from ecrad_torch.solvers.lw_derivatives import lw_derivatives_ica
from ecrad_torch.solvers.outputs import LwFluxes, SwFluxes


def solver_cloudless_lw(od, ssa, g, planck_hl, emission, albedo,
                        do_lw_aerosol_scattering=False,
                        do_lw_derivatives=False,
                        spec_matrix=None) -> LwFluxes:
    """Args: od/ssa/g (ncol, nlev, ng); planck_hl (ncol, nlev+1, ng);
    emission/albedo (ncol, ng).  ssa and g are read only with aerosol
    scattering.  spec_matrix: optional (ng, nspec) 0/1 projection for the
    spectral profiles."""
    planck_top, planck_bot = planck_hl[:, :-1], planck_hl[:, 1:]
    if do_lw_aerosol_scattering:
        refl, trans, src_up, src_dn = two_stream.lw_ref_trans(
            od, ssa, g, planck_top, planck_bot)
        r = adding.adding_lw_reduced(refl, trans, src_up, src_dn, emission,
                                     albedo, spec_matrix)
    else:
        trans, src_up, src_dn = two_stream.lw_no_scattering_trans(
            od, planck_top, planck_bot)
        r = adding.lw_no_scattering_reduced(trans, src_up, src_dn,
                                            emission, albedo, spec_matrix)
    out = LwFluxes(
        flux_up=r.up, flux_dn=r.dn, flux_up_clear=r.up, flux_dn_clear=r.dn,
        lw_dn_surf_g=r.dn_surf_g, lw_up_toa_g=r.up_toa_g,
        lw_dn_surf_clear_g=r.dn_surf_g, lw_up_toa_clear_g=r.up_toa_g,
        cloud_cover=torch.zeros(od.shape[0], dtype=od.dtype,
                                device=od.device),
        flux_up_s=r.up_s, flux_dn_s=r.dn_s,
        flux_up_clear_s=r.up_s, flux_dn_clear_s=r.dn_s)
    if do_lw_derivatives:
        out = out._replace(lw_derivatives=lw_derivatives_ica(
            trans, r.up_surf_g))
    return out


def solver_cloudless_sw(od, ssa, g, incoming_sw, cos_sza, albedo_diffuse,
                        albedo_direct,
                        do_sw_delta_scaling_with_gases=False,
                        spec_matrix=None) -> SwFluxes:
    """Args: od/ssa/g (ncol, nlev, ng); incoming_sw (ncol, ng); cos_sza
    (ncol,); albedos (ncol, ng); spec_matrix as in solver_cloudless_lw."""
    if do_sw_delta_scaling_with_gases:
        od, ssa, g = two_stream.delta_eddington(od, ssa, g)
    mu0 = torch.clamp(cos_sza, min=1.0e-10)[:, None]        # (ncol, 1)
    refl, trans, ref_dir, trans_dir_diff, trans_dir_dir = \
        two_stream.sw_ref_trans(mu0[:, :, None], od, ssa, g)
    r = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct, mu0, refl, trans,
        ref_dir, trans_dir_diff, trans_dir_dir, spec_matrix)

    day = cos_sza > 0.0

    def zn(x):
        """Zero night columns (radiation_cloudless_sw.F90:120-160); None
        stays None."""
        if x is None:
            return None
        d = day.reshape(day.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, torch.zeros_like(x))

    dn = r.dn_diffuse + r.dn_direct
    dn_s = None if r.up_s is None else r.dn_diffuse_s + r.dn_direct_s
    return SwFluxes(
        flux_up=zn(r.up), flux_dn=zn(dn), flux_dn_direct=zn(r.dn_direct),
        flux_up_clear=zn(r.up), flux_dn_clear=zn(dn),
        flux_dn_direct_clear=zn(r.dn_direct),
        sw_dn_diffuse_surf_g=zn(r.dn_diffuse_surf_g),
        sw_dn_direct_surf_g=zn(r.dn_direct_surf_g),
        sw_up_toa_g=zn(r.up_toa_g),
        sw_dn_diffuse_surf_clear_g=zn(r.dn_diffuse_surf_g),
        sw_dn_direct_surf_clear_g=zn(r.dn_direct_surf_g),
        sw_up_toa_clear_g=zn(r.up_toa_g),
        cloud_cover=torch.zeros_like(cos_sza),
        flux_up_s=zn(r.up_s), flux_dn_s=zn(dn_s),
        flux_dn_direct_s=zn(r.dn_direct_s),
        flux_up_clear_s=zn(r.up_s), flux_dn_clear_s=zn(dn_s),
        flux_dn_direct_clear_s=zn(r.dn_direct_s))
