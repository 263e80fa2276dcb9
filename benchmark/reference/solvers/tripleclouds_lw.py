"""The reference's Tripleclouds LW solver (radiation_tripleclouds_lw.F90:
38-607) and its region-coupled derivatives
(radiation_lw_derivatives.F90 calc_lw_derivatives_region), without LW
aerosol scattering: the clear sky and region 0 absorb and emit only; the
two cloudy regions scatter where ``do_lw_cloud_scattering`` holds.

Torch loops over levels, as ecRad's solver: each region's transmittance,
reflectance and sources of every layer, the sources weighted by the
region's fraction; the up sweep of the regions' albedos, mixed through
each interface with v, and of their sources, mixed with u; the down sweep
of the regions' fluxes, mixed with v; a clear layer keeps region 0 alone,
and an interface between two clear layers mixes nothing.  The clear-sky
fluxes alongside.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config
from benchmark.reference.solvers import two_stream
from benchmark.reference.solvers.outputs import LwFluxes
from benchmark.reference.solvers.regions import merge_regions
from benchmark.reference.solvers.tripleclouds import (albedo_above,
                                                      clear_only,
                                                      flux_below,
                                                      mixed_at, regions,
                                                      source_above,
                                                      with_regions)


def layer_coefficients(config: Config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                       g_cloud_b, band_from_g, od_scaling, reg_fracs,
                       planck_hl):
    """Each region's (reflectance, transmittance, source up, source down),
    (ncol, nlev, 3, ng), the sources weighted by the region's fraction:
    region 0 the clear sky's no-scattering ones, the cloudy regions' from
    the clear sky's od merged with the cloud's scaled by each region's od
    scaling; and the clear sky's (transmittance, source up, source down)
    (ncol, nlev, ng)."""
    pt, pb = planck_hl[:, :-1], planck_hl[:, 1:]
    clear = two_stream.lw_no_scattering_trans(od, pt, pb)
    od_r, ssa_r, g_r = merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                     g_cloud_b, band_from_g, od_scaling)
    pt, pb = pt[..., None, :], pb[..., None, :]
    if config.do_lw_cloud_scattering:
        cloudy = two_stream.lw_ref_trans(od_r, ssa_r, g_r, pt, pb)
    else:
        t, su, sd = two_stream.lw_no_scattering_trans(od_r, pt, pb)
        cloudy = (torch.zeros_like(t), t, su, sd)
    t0, su0, sd0 = clear
    f = reg_fracs[..., None]
    return (with_regions(torch.zeros_like(t0), cloudy[0]),
            with_regions(t0, cloudy[1]),
            with_regions(su0, cloudy[2]) * f,
            with_regions(sd0, cloudy[3]) * f), clear


def solver_tripleclouds_lw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           planck_hl, emission, albedo) -> LwFluxes:
    """The LW fluxes of the three regions and of the clear sky, and the
    derivatives where ``do_lw_derivatives`` holds: od, ssa, g (ncol,
    nlev, ng) of the gases and aerosols (ssa and g zero: no aerosol
    scattering), the cloud's per band (ncol, nlev, nband) and
    band_from_g, the cloud fraction (cropped), fractional std and overlap
    parameter, the Planck function at half levels (ncol, nlev+1, ng), the
    surface's emission and albedo (ncol, ng)."""
    ncol, nlev, ng = od.shape
    geo = regions(config, cloud_fraction, fractional_std, overlap_param)
    clear, u, v = geo["clear"], geo["u"], geo["v"]
    coef, (t_c, su_c, sd_c) = layer_coefficients(
        config, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        geo["od_scaling"], geo["reg_fracs"], planck_hl)
    at = lambda l: [c[:, l] for c in coef]                 # noqa: E731

    # the surface: every region where the lowest layer is cloudy, else
    # region 0 alone; each region emits by its fraction
    alb = clear_only(clear[:, -1], albedo[:, None, :].expand(ncol, 3, ng))
    src = geo["reg_fracs"][:, -1, :, None] * emission[:, None, :]

    # up: the albedo and source of what lies below each layer, per region
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        below[l] = (alb, src)
        R, T, SU, SD = at(l)
        inv = 1.0 / (1.0 - alb * R)
        a = clear_only(clear[:, l], R + T * T * alb * inv)
        s = clear_only(clear[:, l], SU + T * (src + alb * SD) * inv)
        mix = mixed_at(clear, l, l - 1)
        alb = torch.where(mix, albedo_above(v[:, l], a), a)
        src = torch.where(mix, source_above(u[:, l], s), s)

    # down: no flux enters at the top
    fdn = torch.zeros_like(src)
    up_toa = src.sum(1)
    up, dn = [up_toa.sum(-1)], [fdn.sum((1, 2))]
    for l in range(nlev):
        R, T, _, SD = at(l)
        alb_b, src_b = below[l]
        fdn = clear_only(clear[:, l],
                         (T * fdn + R * src_b + SD) / (1.0 - R * alb_b))
        fup = clear_only(clear[:, l], src_b + fdn * alb_b)
        up.append(fup.sum((1, 2)))
        dn.append(fdn.sum((1, 2)))
        surf_dn, surf_up = fdn.sum(1), fup.sum(1)
        mix = mixed_at(clear, l, l + 1)
        fdn = torch.where(mix, flux_below(v[:, l + 1], fdn), fdn)

    # the clear sky: down from the top, then up from the surface
    f = torch.zeros_like(emission)
    dn_c = [f.sum(-1)]
    for l in range(nlev):
        f = t_c[:, l] * f + sd_c[:, l]
        dn_c.append(f.sum(-1))
    dn_surf_c = f
    f = emission + albedo * dn_surf_c
    up_c = [f.sum(-1)]
    for l in range(nlev - 1, -1, -1):
        f = t_c[:, l] * f + su_c[:, l]
        up_c.append(f.sum(-1))

    stack = lambda xs: torch.stack(xs, dim=1)              # noqa: E731
    out = LwFluxes(
        flux_up=stack(up), flux_dn=stack(dn),
        flux_up_clear=stack(up_c[::-1]), flux_dn_clear=stack(dn_c),
        lw_dn_surf_g=surf_dn, lw_up_toa_g=up_toa,
        lw_dn_surf_clear_g=dn_surf_c, lw_up_toa_clear_g=f,
        cloud_cover=geo["cloud_cover"])
    if not config.do_lw_derivatives:
        return out
    # calc_lw_derivatives_region: the surface is one clear region, which
    # the regions' upward flux there leaves by the spectral shares; each
    # interface mixes it with u, each layer transmits it
    d = torch.zeros_like(src)
    d[:, 0] = surf_up / surf_up.sum(-1, keepdim=True)
    deriv = [torch.ones_like(up_toa[:, 0])]
    for l in range(nlev - 1, -1, -1):
        d = source_above(u[:, l + 1], d) * at(l)[1]
        deriv.append(d.sum((1, 2)))
    return out._replace(lw_derivatives=stack(deriv[::-1]))
