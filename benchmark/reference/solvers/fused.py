"""Fused McICA solvers: CUDA kernel wrappers and their plain torch
versions.

Replaces ``ecrad_tpu/solvers/pallas_mcica.py:lw_fused`` and ``sw_fused``;
the kernels are ``ecrad_torch/csrc/lw_fused.cu`` and ``sw_fused.cu``.
Each returns the same output dict as its TPU counterpart, in the port's
layout: per-level broadband sums ``(ncol, nlev)``, per-g boundary planes
``(ncol, ng)``.  Inputs: gas optics and od scaling ``(ncol, nlev, ng)``,
in-cloud band properties ``(ncol, nlev, nband)``, the cloudy-layer mask
``(ncol, nlev)`` bool, Planck ``(ncol, nlev+1, ng)``, surface planes
``(ncol, ng)`` and ``band_of_g`` ``(ng,)`` (any band order: the kernels
look the band up, they need no band-contiguous g axis).

With ``planes=True`` each also returns its per-g fluxes at every
half-level, ``(ncol, nlev+1, ng)`` TOA first, for spectral flux output:
``up_g_<s>`` and ``dn_g_<s>`` of each scene ``<s>`` (``c`` clear, ``t``
total sky), and in SW the diffuse ``dn_g_<s>`` beside the direct
``dir_g_<s>`` (normal to the beam, as ``dir_bb_<s>``).  The kernels write
them from the build with planes; the broadband outputs do not change.
"""

from __future__ import annotations

import torch

from benchmark.reference.solvers import sweeps, two_stream


def merge_cloud_lw(od_clear, od_cloud_g, mask, ssa_cloud_g=None,
                   g_cloud_g=None, ssa_clear=None, g_clear=None,
                   do_cloud_scattering=True, do_aerosol_scattering=False):
    """Merge gas(+aerosol) and cloud optical properties per g-point in
    cloudy layers (radiation_mcica_lw.F90:133-171); mask broadcasts
    against od.  Returns (od, ssa, g); ssa and g are None without cloud
    scattering."""
    zero = torch.zeros_like(od_clear)
    od_total = od_clear + torch.where(mask, od_cloud_g, zero)
    if not do_cloud_scattering:
        return od_total, None, None
    scat = torch.where(mask, ssa_cloud_g * od_cloud_g, zero)
    gscat = torch.where(mask, g_cloud_g * ssa_cloud_g * od_cloud_g, zero)
    if do_aerosol_scattering:
        scat = ssa_clear * od_clear + scat
        gscat = g_clear * ssa_clear * od_clear + gscat
    ssa_total = torch.where(od_total > 0.0,
                            scat / torch.clamp(od_total, min=1e-300), zero)
    g_total = torch.where(scat > 0.0,
                          gscat / torch.clamp(scat, min=1e-300), zero)
    return od_total, ssa_total, g_total


def merge_cloud_sw(od, ssa, g, odc_g, ssac_g, gc_g, mask):
    """Total-sky SW merge (radiation_mcica_sw.F90)."""
    zero = torch.zeros_like(od)
    od_tot = od + torch.where(mask, odc_g, zero)
    scat = ssa * od + torch.where(mask, ssac_g * odc_g, zero)
    gscat = g * ssa * od + torch.where(mask, gc_g * ssac_g * odc_g, zero)
    ssa_tot = torch.where(od_tot > 0.0,
                          scat / torch.clamp(od_tot, min=1e-300), zero)
    g_tot = torch.where(scat > 0.0,
                        gscat / torch.clamp(scat, min=1e-300), zero)
    return od_tot, ssa_tot, g_tot


def _lw_layers(od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl,
               band_of_g):
    """Clear no-scattering and total-sky layer coefficients, all levels."""
    ptop, pbot = planck_hl[:, :-1], planck_hl[:, 1:]
    trans_c, s_up_c, s_dn_c = two_stream.lw_no_scattering_trans(
        od, ptop, pbot)
    m = mask[..., None]
    od_t, ssa_t, g_t = merge_cloud_lw(
        od, od_scaling * odc_b[..., band_of_g], m, ssac_b[..., band_of_g],
        gc_b[..., band_of_g])
    refl_m, trans_m, s_up_m, s_dn_m = two_stream.lw_ref_trans(
        od_t, ssa_t, g_t, ptop, pbot)
    refl = torch.where(m, refl_m, torch.zeros_like(refl_m))
    trans = torch.where(m, trans_m, trans_c)
    s_up = torch.where(m, s_up_m, s_up_c)
    s_dn = torch.where(m, s_dn_m, s_dn_c)
    return (trans_c, s_up_c, s_dn_c), (refl, trans, s_up, s_dn)


def lw_fused_plain(od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl,
                   emission, albedo, band_of_g, do_derivatives,
                   planes=False):
    """The fused LW sweeps as torch loops over levels (the reference for
    the kernel): the clear no-scattering sweeps and the total-sky adding
    sweeps of sweeps, then the derivatives."""
    nlev = od.shape[1]
    (trans_c, s_up_c, s_dn_c), (refl, trans, s_up, s_dn) = _lw_layers(
        od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl, band_of_g)
    clear = sweeps.lw_noscat_sweeps_plain(trans_c, s_up_c, s_dn_c,
                                               emission, albedo, planes)
    tot = sweeps.scat_sweeps_plain(refl, trans, s_up, s_dn, albedo,
                                        emission, planes)
    fup_surf_c = clear["fup_surf"]
    fup_surf_t = albedo * tot["fdn_surf"] + emission
    out = dict(dn_bb_c=clear["dn_bb"], fdn_surf_c=clear["fdn_surf"],
               up_bb_c=clear["up_bb"], fup_toa_c=clear["fup_toa"],
               fup_surf_c=fup_surf_c, src_top_t=tot["src_top"],
               dn_bb_t=tot["dn_bb"], up_bb_t=tot["up_bb"],
               fdn_surf_t=tot["fdn_surf"], fup_surf_t=fup_surf_t)
    if planes:
        out.update(up_g_c=clear["up_g"], dn_g_c=clear["dn_g"],
                   up_g_t=tot["up_g"], dn_g_t=tot["dn_g"])
    if do_derivatives:
        # Hogan-Bozzo derivatives (radiation_lw_derivatives.F90:43-83)
        dc = fup_surf_c / torch.clamp(fup_surf_c.sum(-1, keepdim=True),
                                      min=1e-30)
        dt = fup_surf_t / torch.clamp(fup_surf_t.sum(-1, keepdim=True),
                                      min=1e-30)
        deriv_c, deriv_t = [None] * nlev, [None] * nlev
        for l in range(nlev - 1, -1, -1):
            dc = dc * trans_c[:, l]
            dt = dt * trans[:, l]
            deriv_c[l], deriv_t[l] = dc.sum(-1), dt.sum(-1)
        out.update(deriv_c=torch.stack(deriv_c, dim=1),
                   deriv_t=torch.stack(deriv_t, dim=1))
    return out


def _sw_layers(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask, mu0,
               band_of_g, delta_gases):
    """Clear and total-sky Meador-Weaver coefficients, all levels."""
    m = mask[..., None]
    od_t, ssa_t, g_t = merge_cloud_sw(
        od, ssa, g, od_scaling * odc_b[..., band_of_g],
        ssac_b[..., band_of_g], gc_b[..., band_of_g], m)
    if delta_gases:
        od, ssa, g = two_stream.delta_eddington(od, ssa, g)
        od_t, ssa_t, g_t = two_stream.delta_eddington(od_t, ssa_t, g_t)
    mu = mu0[:, None, None]
    cl = two_stream.sw_ref_trans(mu, od, ssa, g)
    mg = two_stream.sw_ref_trans(mu, od_t, ssa_t, g_t)
    return cl, tuple(torch.where(m, a, b) for a, b in zip(mg, cl))


def sw_fused_plain(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask, mu0,
                   incoming, alb_dif, alb_dir_mu0, band_of_g, delta_gases,
                   planes=False):
    """The fused SW sweeps as torch loops over levels (the reference for
    the kernel): sweeps's three SW sweeps on the clear and the
    total-sky coefficients.  mu0 (ncol,) already clamped to 1e-10."""
    cl, tot = _sw_layers(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask,
                         mu0, band_of_g, delta_gases)
    out = {}
    for tag, coeffs in (("c", cl), ("t", tot)):
        r = sweeps.sw_sweeps_plain(*coeffs, incoming, alb_dif,
                                        alb_dir_mu0, planes)
        out.update({f"{k}_{tag}": v for k, v in r.items()})
    return out
