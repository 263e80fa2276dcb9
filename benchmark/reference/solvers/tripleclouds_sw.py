"""The reference's Tripleclouds SW solver (radiation_tripleclouds_sw.F90:
42-663, Shonk & Hogan 2008): three regions a layer, the clear sky and two
clouds whose optical depths the regions' scalings set, coupled between
layers by the overlap matrices.

Torch loops over levels, as ecRad's solver: each region's two-stream
coefficients of every layer (``two_stream.py``), the up sweep of the
regions' diffuse and direct albedos from the surface, mixed through each
interface with v, and the down sweep of the regions' direct and diffuse
fluxes from the top, mixed through each interface with v; a clear layer
keeps region 0 alone, and an interface between two clear layers mixes
nothing.  The clear-sky fluxes alongside, by the same adding.  Night
columns are computed with mu0 = 1 and their fluxes zeroed; the cloud
cover is set in every column, as ecRad sets it before the sun's test.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config
from benchmark.reference.solvers import two_stream
from benchmark.reference.solvers.outputs import SwFluxes
from benchmark.reference.solvers.regions import merge_regions
from benchmark.reference.solvers.tripleclouds import (albedo_above,
                                                      clear_only,
                                                      flux_below,
                                                      mixed_at, regions,
                                                      with_regions)


def layer_coefficients(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                       band_from_g, od_scaling, mu0):
    """Each region's (ref_diff, trans_diff, ref_dir, trans_dir_diff,
    trans_dir_dir), (ncol, nlev, 3, ng): region 0 from the clear sky's
    od, ssa and g, the cloudy regions from those merged with the cloud's
    scaled by each region's od scaling; the clear sky's (ncol, nlev, ng)
    beside them."""
    mu = mu0[:, None, None]
    clear = two_stream.sw_ref_trans(mu, od, ssa, g)
    od_r, ssa_r, g_r = merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                     g_cloud_b, band_from_g, od_scaling)
    cloudy = two_stream.sw_ref_trans(mu[..., None], od_r, ssa_r, g_r)
    return tuple(with_regions(c, r) for c, r in zip(clear, cloudy)), clear


def _up(R, T, Rd, Tdd, Tdir, alb, albd):
    """The diffuse and direct albedo at a layer's top from those at its
    base (the adding of radiation_tripleclouds_sw.F90's up loop)."""
    inv = 1.0 / (1.0 - alb * R)
    return (R + T * T * alb * inv,
            Rd + (Tdir * albd + Tdd * alb) * T * inv)


def _down(R, T, Tdd, Tdir, fdir, fdn, alb, albd):
    """The direct, diffuse down and up flux at a layer's base from the
    direct and diffuse flux at its top and the albedos below it."""
    fdn = (T * fdn + fdir * (Tdir * albd * R + Tdd)) / (1.0 - R * alb)
    fdir = Tdir * fdir
    return fdir, fdn, fdir * albd + fdn * alb


def solver_tripleclouds_sw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           incoming_sw, cos_sza, albedo_diffuse,
                           albedo_direct) -> SwFluxes:
    """The SW fluxes of the three regions and of the clear sky: od, ssa, g
    (ncol, nlev, ng) of the gases and aerosols, the cloud's per band
    (ncol, nlev, nband) and band_from_g, the cloud fraction (cropped),
    fractional std and overlap parameter, the incoming flux and the
    surface albedos (ncol, ng), cos_sza (ncol,)."""
    ncol, nlev, ng = od.shape
    day = cos_sza > 0.0
    mu0 = torch.where(day, cos_sza, torch.ones_like(cos_sza))
    geo = regions(config, cloud_fraction, fractional_std, overlap_param)
    clear, v = geo["clear"], geo["v"]
    coef, coef_c = layer_coefficients(
        od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        geo["od_scaling"], mu0)
    at = lambda l: [c[:, l] for c in coef]                 # noqa: E731
    at_c = lambda l: [c[:, l] for c in coef_c]             # noqa: E731

    # the surface: every region where the lowest layer is cloudy, else
    # region 0 alone
    alb_srf = albedo_diffuse
    albd_srf = mu0[:, None] * albedo_direct
    alb = clear_only(clear[:, -1], alb_srf[:, None, :].expand(ncol, 3, ng))
    albd = clear_only(clear[:, -1],
                      albd_srf[:, None, :].expand(ncol, 3, ng))
    alb_c, albd_c = alb_srf, albd_srf

    # up: the albedos of what lies below each layer, per region of the
    # layer, and the clear sky's
    below, below_c = [None] * nlev, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        below[l], below_c[l] = (alb, albd), (alb_c, albd_c)
        R, T, Rd, Tdd, Tdir = at(l)
        a, ad = (clear_only(clear[:, l], x)
                 for x in _up(R, T, Rd, Tdd, Tdir, alb, albd))
        mix = mixed_at(clear, l, l - 1)
        alb = torch.where(mix, albedo_above(v[:, l], a), a)
        albd = torch.where(mix, albedo_above(v[:, l], ad), ad)
        alb_c, albd_c = _up(*at_c(l), alb_c, albd_c)

    # down: the direct beam enters the top layer's regions by their
    # fractions (per unit area normal to the beam); the diffuse flux is 0
    fdir = incoming_sw[:, None, :] * geo["reg_fracs"][:, 0, :, None]
    fdn = torch.zeros_like(fdir)
    up_toa = (fdir * albd).sum(1)
    fdir_c, fdn_c = incoming_sw, torch.zeros_like(incoming_sw)
    up_toa_c = incoming_sw * albd_c
    up, dn, dr = [up_toa.sum(-1)], [fdn.sum((1, 2))], [fdir.sum((1, 2))]
    up_c, dn_c, dr_c = [up_toa_c.sum(-1)], [fdn_c.sum(-1)], [fdir_c.sum(-1)]
    for l in range(nlev):
        R, T, _, Tdd, Tdir = at(l)
        fdir, fdn, fup = (clear_only(clear[:, l], x) for x in _down(
            R, T, Tdd, Tdir, fdir, fdn, *below[l]))
        up.append(fup.sum((1, 2)))
        dn.append(fdn.sum((1, 2)))
        dr.append(fdir.sum((1, 2)))
        surf_dn, surf_dir = fdn.sum(1), fdir.sum(1)
        mix = mixed_at(clear, l, l + 1)
        fdir = torch.where(mix, flux_below(v[:, l + 1], fdir), fdir)
        fdn = torch.where(mix, flux_below(v[:, l + 1], fdn), fdn)

        R, T, _, Tdd, Tdir = at_c(l)
        fdir_c, fdn_c, fup_c = _down(R, T, Tdd, Tdir, fdir_c, fdn_c,
                                     *below_c[l])
        up_c.append(fup_c.sum(-1))
        dn_c.append(fdn_c.sum(-1))
        dr_c.append(fdir_c.sum(-1))

    mu = mu0[:, None]
    stack = lambda xs: torch.stack(xs, dim=1)              # noqa: E731
    direct, direct_c = mu * stack(dr), mu * stack(dr_c)
    out = SwFluxes(
        flux_up=stack(up), flux_dn=stack(dn) + direct,
        flux_dn_direct=direct,
        flux_up_clear=stack(up_c), flux_dn_clear=stack(dn_c) + direct_c,
        flux_dn_direct_clear=direct_c,
        sw_dn_diffuse_surf_g=surf_dn, sw_dn_direct_surf_g=mu * surf_dir,
        sw_up_toa_g=up_toa,
        sw_dn_diffuse_surf_clear_g=fdn_c,
        sw_dn_direct_surf_clear_g=mu * fdir_c,
        sw_up_toa_clear_g=up_toa_c,
        cloud_cover=geo["cloud_cover"])
    return SwFluxes(*(
        x if name == "cloud_cover" or x is None else torch.where(
            day.reshape((ncol,) + (1,) * (x.dim() - 1)), x,
            torch.zeros_like(x))
        for name, x in zip(SwFluxes._fields, out)))
