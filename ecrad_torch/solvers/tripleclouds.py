"""Tripleclouds solvers (Shonk & Hogan 2008): three regions per layer,
clear sky plus two cloudy regions with different optical depths.

Reference: radiation_tripleclouds_sw.F90:42-663,
radiation_tripleclouds_lw.F90:38-607, radiation_regions.F90:35-202,
radiation_overlap.F90:64-459; port of ``ecrad_tpu/solvers/tripleclouds.py``.

Configurations the fused kernels cover (csrc/tripleclouds_lw.cu,
csrc/tripleclouds_sw.cu, through solvers/cuda_tripleclouds.py) go there:
three regions and a band-contiguous g axis, and for LW cloud scattering on
with aerosol scattering off (the JAX package's ``_use_fused_tc`` without
its platform test).  The others run the scan form: torch loops over
levels carrying ``(ncol, 3, ng)`` states, mixed across regions at every
interface through the overlap matrices.  Spectral flux output
(``spec_matrix``) goes through the fused kernels' per-g planes, the
regions summed, projected outside them; the scan form projects its own
per-g fluxes, the regions summed, and the clear scene's from the adding
sweeps' planes, as the JAX package's scan form does.
"""

from __future__ import annotations

import torch

from ecrad_torch import profiling
from ecrad_torch.config import Config, PdfShape
from ecrad_torch.solvers import adding, cuda_tripleclouds, two_stream
from ecrad_torch.solvers.cuda_adding import keeper
from ecrad_torch.solvers.adding import _stack_bot, _stack_top
from ecrad_torch.solvers.cuda_tripleclouds import (
    merge_regions, mix_u, mix_v, mix_v_dn, skip_mix, with_regions,
    zero_cloudy_regions)
from ecrad_torch.solvers.mcica import _gcounts
from ecrad_torch.solvers.outputs import LwFluxes, SwFluxes, project

NREG = 3

# radiation_regions.F90:10-18
MIN_GAMMA_OD_SCALING = 0.025
MIN_LOWER_FRAC = 0.5
MAX_LOWER_FRAC = 0.9
FSD_AT_MIN_LOWER_FRAC = 1.5
FSD_AT_MAX_LOWER_FRAC = 3.725
_GRAD = (MAX_LOWER_FRAC - MIN_LOWER_FRAC) / (FSD_AT_MAX_LOWER_FRAC
                                             - FSD_AT_MIN_LOWER_FRAC)
_INTERCEPT = MIN_LOWER_FRAC - FSD_AT_MIN_LOWER_FRAC * _GRAD


def calc_region_properties(cloud_fraction, frac_std, do_gamma,
                           frac_threshold=1.0e-20, n_regions=3):
    """radiation_regions.F90:35-202.

    Returns (reg_fracs (ncol, nlev, 3), od_scaling (ncol, nlev, 2)).
    n_regions=2 is one homogeneous cloudy region, expressed as region 2
    = the whole cloud fraction with od scaling 1 and region 3 empty."""
    cf = cloud_fraction
    cloudy = cf >= frac_threshold
    zero, one = torch.zeros_like(cf), torch.ones_like(cf)
    if n_regions == 2:
        frac1 = torch.where(cloudy, 1.0 - cf, one)
        frac2 = torch.where(cloudy, cf, zero)
        return (torch.stack([frac1, frac2, zero], dim=-1),
                torch.stack([one, one], dim=-1))
    if n_regions != 3:
        raise NotImplementedError(
            f"n_regions={n_regions} not supported (reference allows "
            "2 or 3, radiation_regions.F90:105-202)")
    if do_gamma:
        frac2 = cf * torch.clamp(_INTERCEPT + frac_std * _GRAD,
                                 MIN_LOWER_FRAC, MAX_LOWER_FRAC)
        scale2 = MIN_GAMMA_OD_SCALING + (1.0 - MIN_GAMMA_OD_SCALING) \
            * torch.exp(-frac_std * (1.0 + 0.5 * frac_std
                                     * (1.0 + 0.5 * frac_std)))
        frac3 = cf - frac2
        scale3 = (cf - frac2 * scale2) / torch.clamp(frac3, min=1.0e-30)
    else:
        frac2 = cf * 0.5
        s = torch.sqrt(frac_std ** 2 + 1.0)
        scale2 = torch.exp(-torch.sqrt(torch.log(frac_std ** 2 + 1.0))) / s
        frac3 = cf * 0.5
        scale3 = 2.0 - scale2

    frac1 = torch.where(cloudy, 1.0 - cf, one)
    frac2 = torch.where(cloudy, frac2, zero)
    frac3 = torch.where(cloudy, frac3, zero)
    scale2 = torch.where(cloudy, scale2, one)
    scale3 = torch.where(cloudy, scale3, one)
    return (torch.stack([frac1, frac2, frac3], dim=-1),
            torch.stack([scale2, scale3], dim=-1))


def calc_overlap_matrices(reg_fracs, overlap_param, decorr_scaling,
                          frac_threshold=1.0e-20):
    """radiation_overlap.F90:280-459 (alpha overlap, three regions).

    reg_fracs (ncol, nlev, 3); overlap_param (ncol, nlev-1).  Returns
    (u_matrix, v_matrix) each (ncol, nlev+1, 3, 3) and cloud_cover
    (ncol,); u[upper, lower] = ov / frac_lower, v[lower, upper] =
    ov / frac_upper, interface j between layers j-1 and j."""
    ncol = reg_fracs.shape[0]
    kw = dict(dtype=reg_fracs.dtype, device=reg_fracs.device)
    clear1 = torch.tensor([1.0, 0.0, 0.0], **kw).expand(ncol, 1, NREG)
    fu = torch.cat([clear1, reg_fracs], dim=1)    # layer above (TOA clear)
    fl = torch.cat([reg_fracs, clear1], dim=1)    # layer below (surface)
    ones = torch.ones((ncol, 1), **kw)
    op1 = torch.cat([ones, overlap_param, ones], dim=1)
    op_inhom = torch.where(
        op1 >= 0.0, torch.clamp(op1, min=1e-30) ** (1.0 / decorr_scaling),
        op1)

    cf_u = fu[..., 1] + fu[..., 2]
    cf_l = fl[..., 1] + fl[..., 2]
    pcc = op1 * torch.maximum(cf_u, cf_l) \
        + (1.0 - op1) * (cf_u + cf_l - cf_u * cf_l)
    inv_l = 1.0 / torch.clamp(cf_l, min=1.0e-6)
    inv_u = 1.0 / torch.clamp(cf_u, min=1.0e-6)
    frac_both = cf_u + cf_l - pcc
    # within-cloud overlap of the optically thick regions
    cu = fu[..., 2] * inv_u
    cl = fl[..., 2] * inv_l
    pcc2 = op_inhom * torch.maximum(cu, cl) \
        + (1.0 - op_inhom) * (cu + cl - cu * cl)
    ov = torch.stack([
        torch.stack([1.0 - pcc, (pcc - cf_u) * fl[..., 1] * inv_l,
                     (pcc - cf_u) * fl[..., 2] * inv_l], dim=-1),
        torch.stack([(pcc - cf_l) * fu[..., 1] * inv_u,
                     frac_both * (1.0 - pcc2), frac_both * (pcc2 - cu)],
                    dim=-1),
        torch.stack([(pcc - cf_l) * fu[..., 2] * inv_u,
                     frac_both * (pcc2 - cl), frac_both * (cu + cl - pcc2)],
                    dim=-1)], dim=-2)                  # ov[upper, lower]

    zero = torch.zeros_like(ov)
    u_matrix = torch.where((fl >= frac_threshold)[..., None, :],
                           ov / torch.clamp(fl[..., None, :], min=1e-30),
                           zero)
    v_matrix = torch.where((fu >= frac_threshold)[..., None, :],
                           ov.transpose(-1, -2)
                           / torch.clamp(fu[..., None, :], min=1e-30),
                           zero)
    cloud_cover = 1.0 - torch.prod(v_matrix[..., 0, 0], dim=1)
    return u_matrix, v_matrix, cloud_cover


def _regions(config, cloud_fraction, fractional_std, overlap_param):
    """The region fractions and od scalings and the overlap matrices, in
    the span ``ecrad.solvers.regions``."""
    with profiling.scope("ecrad.solvers.regions"):
        reg_fracs, od_scaling = calc_region_properties(
            cloud_fraction, fractional_std,
            config.cloud_pdf_shape == PdfShape.GAMMA,
            config.cloud_fraction_threshold, n_regions=config.nregions)
        u_mat, v_mat, cloud_cover = calc_overlap_matrices(
            reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
            config.cloud_fraction_threshold)
    return reg_fracs, od_scaling, u_mat, v_mat, cloud_cover


def _use_fused(config, band_from_g):
    """The fused kernels take three regions on a band-contiguous g axis."""
    return config.nregions == NREG and _gcounts(band_from_g) is not None


def _use_fused_lw(config, band_from_g):
    return (_use_fused(config, band_from_g) and config.do_lw_cloud_scattering
            and not config.do_lw_aerosol_scattering)


def solver_tripleclouds_sw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           incoming_sw, cos_sza, albedo_diffuse,
                           albedo_direct, spec_matrix=None) -> SwFluxes:
    """radiation_tripleclouds_sw.F90:42-663 (batched, dense).
    spec_matrix: optional (ng, nspec) 0/1 projection for the spectral
    profiles."""
    if _use_fused(config, band_from_g):
        return _solver_tripleclouds_sw_fused(
            config, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
            band_from_g, cloud_fraction, fractional_std, overlap_param,
            incoming_sw, cos_sza, albedo_diffuse, albedo_direct,
            spec_matrix)
    ncol, nlev, ng = od.shape
    mu0 = torch.clamp(cos_sza, min=1.0e-10)[:, None, None]
    reg_fracs, od_scaling, u_mat, v_mat, cloud_cover = _regions(
        config, cloud_fraction, fractional_std, overlap_param)
    clear_layer = cloud_fraction <= 0.0

    # layer properties: region 0 = clear
    r_cl, t_cl, rd_cl, tdd_cl, tdir_cl = two_stream.sw_ref_trans(
        mu0, od, ssa, g)
    od_r, ssa_r, g_r = merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                     g_cloud_b, band_from_g, od_scaling)
    if config.do_sw_delta_scaling_with_gases:
        od_r, ssa_r, g_r = two_stream.delta_eddington(od_r, ssa_r, g_r)
    coeffs_c = two_stream.sw_ref_trans(mu0[..., None], od_r, ssa_r, g_r)
    refl, trans, ref_dir, tdd, tdir = (
        with_regions(clear_layer, a, b) for a, b in zip(
            (r_cl, t_cl, rd_cl, tdd_cl, tdir_cl), coeffs_c))

    # upward sweep: diffuse and direct albedo per region; regions 2 and 3
    # start at the surface only if the lowest layer is cloudy
    mask_srf = torch.ones((ncol, NREG, 1), dtype=torch.bool, device=od.device)
    mask_srf[:, 1:] = ~clear_layer[:, -1, None, None]
    zero3 = torch.zeros((ncol, NREG, ng), dtype=od.dtype, device=od.device)
    alb = torch.where(mask_srf, torch.broadcast_to(
        albedo_diffuse[:, None, :], (ncol, NREG, ng)), zero3)
    albd = torch.where(mask_srf, torch.broadcast_to(
        (cos_sza[:, None] * albedo_direct)[:, None, :], (ncol, NREG, ng)),
        zero3)
    alb_below, albd_below = [None] * nlev, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        alb_below[l], albd_below[l] = alb, albd
        inv = 1.0 / (1.0 - alb * refl[:, l])
        a = refl[:, l] + trans[:, l] * trans[:, l] * alb * inv
        ad = ref_dir[:, l] + (tdir[:, l] * albd + tdd[:, l] * alb) \
            * trans[:, l] * inv
        a = zero_cloudy_regions(clear_layer, l, a)
        ad = zero_cloudy_regions(clear_layer, l, ad)
        # mix at this layer's top interface unless this layer and the one
        # above are both clear
        skip = skip_mix(clear_layer, l, l - 1)
        alb = torch.where(skip, a, mix_v(v_mat[:, l], a))
        albd = torch.where(skip, ad, mix_v(v_mat[:, l], ad))
    albd_top = albd

    # clear-sky one-region fluxes
    clear = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct, mu0[:, :, 0],
        r_cl, t_cl, rd_cl, tdd_cl, tdir_cl, spec_matrix)

    # downward sweep, reduced per level (and kept per g, the regions
    # summed, for spectral flux output)
    fdir = incoming_sw[:, None, :] * reg_fracs[:, 0, :, None]
    fdir0, fup0 = fdir, fdir * albd_top
    fdn = torch.zeros_like(fdir)
    up_bb, dn_bb, dir_bb = [], [], []
    keep = keeper(spec_matrix is not None)
    up_g, dn_g, dir_g = [fup0.sum(1)], [fdn.sum(1)], [fdir0.sum(1)]
    for l in range(nlev):
        fdn = (trans[:, l] * fdn + fdir * (tdir[:, l] * albd_below[l]
                                           * refl[:, l] + tdd[:, l])) \
            / (1.0 - refl[:, l] * alb_below[l])
        fdir = tdir[:, l] * fdir
        fup = fdir * albd_below[l] + fdn * alb_below[l]
        fdn, fdir, fup = (zero_cloudy_regions(clear_layer, l, x)
                          for x in (fdn, fdir, fup))
        up_bb.append(fup.sum((1, 2)))
        dn_bb.append(fdn.sum((1, 2)))
        dir_bb.append(fdir.sum((1, 2)))
        fdn_surf_g, fdir_surf_g = fdn.sum(1), fdir.sum(1)
        keep(up_g, fup.sum(1))
        keep(dn_g, fdn_surf_g)
        keep(dir_g, fdir_surf_g)
        # mix through the interface below this layer
        skip = skip_mix(clear_layer, l, l + 1)
        fdn = torch.where(skip, fdn, mix_v_dn(v_mat[:, l + 1], fdn))
        fdir = torch.where(skip, fdir, mix_v_dn(v_mat[:, l + 1], fdir))

    mu0p = torch.clamp(cos_sza, min=0.0)
    stack = lambda xs: torch.stack(xs, dim=1)
    up0_bb = fup0.sum((1, 2))
    fdir_bb = mu0p[:, None] * _stack_top(fdir0.sum((1, 2)), stack(dir_bb))
    spectral = {}
    if spec_matrix is not None:
        up_s, dn_s, dir_s = (project(stack(x), spec_matrix)
                             for x in (up_g, dn_g, dir_g))
        dir_s = mu0p[:, None, None] * dir_s
        spectral = dict(
            flux_up_s=up_s, flux_dn_s=dn_s + dir_s, flux_dn_direct_s=dir_s,
            flux_up_clear_s=clear.up_s,
            flux_dn_clear_s=clear.dn_diffuse_s + clear.dn_direct_s,
            flux_dn_direct_clear_s=clear.dn_direct_s)
    return _zero_night(cos_sza, SwFluxes(
        flux_up=_stack_top(up0_bb, stack(up_bb)),
        flux_dn=_stack_top(torch.zeros_like(up0_bb), stack(dn_bb)) + fdir_bb,
        flux_dn_direct=fdir_bb,
        flux_up_clear=clear.up,
        flux_dn_clear=clear.dn_diffuse + clear.dn_direct,
        flux_dn_direct_clear=clear.dn_direct,
        sw_dn_diffuse_surf_g=fdn_surf_g,
        sw_dn_direct_surf_g=mu0p[:, None] * fdir_surf_g,
        sw_up_toa_g=fup0.sum(1),
        sw_dn_diffuse_surf_clear_g=clear.dn_diffuse_surf_g,
        sw_dn_direct_surf_clear_g=clear.dn_direct_surf_g,
        sw_up_toa_clear_g=clear.up_toa_g,
        cloud_cover=cloud_cover, **spectral))


def _zero_night(cos_sza, out: SwFluxes) -> SwFluxes:
    """Zero every field of night columns except cloud cover, which
    Tripleclouds assigns for all columns (calc_overlap_matrices runs
    before the mu0 check)."""
    day = cos_sza > 0.0

    def zn(x):
        if x is None:
            return None
        d = day.reshape(day.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, torch.zeros_like(x))

    return SwFluxes(*(x if name == "cloud_cover" else zn(x)
                      for name, x in zip(SwFluxes._fields, out)))


def solver_tripleclouds_lw(config: Config, od, ssa, g, od_cloud_b,
                           ssa_cloud_b, g_cloud_b, band_from_g,
                           cloud_fraction, fractional_std, overlap_param,
                           planck_hl, emission, albedo,
                           spec_matrix=None) -> LwFluxes:
    """radiation_tripleclouds_lw.F90:38-607 (batched, dense).
    spec_matrix: optional (ng, nspec) 0/1 projection for the spectral
    profiles."""
    if _use_fused_lw(config, band_from_g):
        return _solver_tripleclouds_lw_fused(
            config, od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            cloud_fraction, fractional_std, overlap_param, planck_hl,
            emission, albedo, spec_matrix)
    ncol, nlev, ng = od.shape
    reg_fracs, od_scaling, u_mat, v_mat, cloud_cover = _regions(
        config, cloud_fraction, fractional_std, overlap_param)
    clear_layer = cloud_fraction <= 0.0
    planck_top, planck_bot = planck_hl[:, :-1], planck_hl[:, 1:]
    aer_scat = config.do_lw_aerosol_scattering

    # clear-sky (region 1) properties + fluxes
    if aer_scat:
        r_cl, t_cl, su_cl, sd_cl = two_stream.lw_ref_trans(
            od, ssa, g, planck_top, planck_bot)
        clear = adding.adding_lw_reduced(r_cl, t_cl, su_cl, sd_cl,
                                         emission, albedo, spec_matrix)
    else:
        t_cl, su_cl, sd_cl = two_stream.lw_no_scattering_trans(
            od, planck_top, planck_bot)
        r_cl = torch.zeros_like(t_cl)
        clear = adding.lw_no_scattering_reduced(t_cl, su_cl, sd_cl,
                                                emission, albedo,
                                                spec_matrix)

    # cloudy regions
    od_r, ssa_r, g_r = merge_regions(
        od, ssa if aer_scat else None, g if aer_scat else None,
        od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g, od_scaling)
    pt, pb = planck_top[..., None, :], planck_bot[..., None, :]
    if config.do_lw_cloud_scattering:
        r_c, t_c, su_c, sd_c = two_stream.lw_ref_trans(od_r, ssa_r, g_r,
                                                       pt, pb)
    else:
        t_c, su_c, sd_c = two_stream.lw_no_scattering_trans(od_r, pt, pb)
        r_c = torch.zeros_like(t_c)

    refl = with_regions(clear_layer, r_cl, r_c)
    trans = with_regions(clear_layer, t_cl, t_c, clear_fill=1.0)
    # sources scaled by region fraction (tripleclouds_lw.F90:200-204)
    rf = reg_fracs[..., None]
    src_up = with_regions(clear_layer, su_cl, su_c) * rf
    src_dn = with_regions(clear_layer, sd_cl, sd_c) * rf

    # upward sweep: albedo + source per region
    alb = torch.broadcast_to(albedo[:, None, :], (ncol, NREG, ng))
    src = reg_fracs[:, -1, :, None] * emission[:, None, :]
    alb_below, src_below = [None] * nlev, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        alb_below[l], src_below[l] = alb, src
        inv = 1.0 / (1.0 - alb * refl[:, l])
        a = refl[:, l] + trans[:, l] * trans[:, l] * alb * inv
        s = src_up[:, l] + trans[:, l] * (src + alb * src_dn[:, l]) * inv
        # the source mixes with u[upper, lower] (tripleclouds_lw.F90:
        # 248-250), the albedo with v
        skip = skip_mix(clear_layer, l, l - 1)
        alb = torch.where(skip, a, mix_v(v_mat[:, l], a))
        src = torch.where(skip, s, mix_u(u_mat[:, l], s))
    alb_top, src_top = alb, src

    # downward sweep, reduced per level (and kept per g, the regions
    # summed, for spectral flux output)
    fdn = torch.zeros((ncol, NREG, ng), dtype=od.dtype, device=od.device)
    fup0 = src_top + alb_top * fdn
    up_bb, dn_bb = [], []
    keep = keeper(spec_matrix is not None)
    up_g, dn_g = [fup0.sum(1)], [fdn.sum(1)]
    for l in range(nlev):
        fdn = (trans[:, l] * fdn + refl[:, l] * src_below[l]
               + src_dn[:, l]) / (1.0 - refl[:, l] * alb_below[l])
        fup = src_below[l] + fdn * alb_below[l]
        fdn = zero_cloudy_regions(clear_layer, l, fdn)
        fup = zero_cloudy_regions(clear_layer, l, fup)
        up_bb.append(fup.sum((1, 2)))
        dn_bb.append(fdn.sum((1, 2)))
        fup_surf_g, fdn_surf_g = fup.sum(1), fdn.sum(1)
        keep(up_g, fup_surf_g)
        keep(dn_g, fdn_surf_g)
        skip = skip_mix(clear_layer, l, l + 1)
        fdn = torch.where(skip, fdn, mix_v_dn(v_mat[:, l + 1], fdn))

    stack = lambda xs: torch.stack(xs, dim=1)
    up0_bb = fup0.sum((1, 2))
    out = LwFluxes(
        flux_up=_stack_top(up0_bb, stack(up_bb)),
        flux_dn=_stack_top(torch.zeros_like(up0_bb), stack(dn_bb)),
        flux_up_clear=clear.up, flux_dn_clear=clear.dn,
        lw_dn_surf_g=fdn_surf_g, lw_up_toa_g=fup0.sum(1),
        lw_dn_surf_clear_g=clear.dn_surf_g,
        lw_up_toa_clear_g=clear.up_toa_g,
        cloud_cover=cloud_cover,
        flux_up_clear_s=clear.up_s, flux_dn_clear_s=clear.dn_s)
    if spec_matrix is not None:
        out = out._replace(flux_up_s=project(stack(up_g), spec_matrix),
                           flux_dn_s=project(stack(dn_g), spec_matrix))

    if config.do_lw_derivatives:
        # region-coupled Hogan-Bozzo derivatives
        # (radiation_lw_derivatives.F90:200-250): the per-region spectral
        # derivative propagates upward through u mixing + transmittance
        dg = torch.zeros((ncol, NREG, ng), dtype=od.dtype, device=od.device)
        dg[:, 0] = fup_surf_g / fup_surf_g.sum(-1, keepdim=True)
        deriv = [None] * nlev
        for l in range(nlev - 1, -1, -1):
            dg = mix_u(u_mat[:, l + 1], dg) * trans[:, l]
            deriv[l] = dg.sum((1, 2))
        ones = torch.ones((ncol, 1), dtype=od.dtype, device=od.device)
        out = out._replace(lw_derivatives=torch.cat([stack(deriv), ones],
                                                    dim=1))
    return out


# ---------------------------------------------------------------------------
# Fused-kernel path (solvers/cuda_tripleclouds.py)
# ---------------------------------------------------------------------------


def fused_prep(config, cloud_fraction, fractional_std, overlap_param):
    """Region properties, overlap matrices and clear flags as the fused
    kernels read them: scal2 (ncol, nlev, 2), rf3 (ncol, nlev, 3), u9/v9
    (ncol, nlev+1, 9) with k = 3*i + j, clear (ncol, nlev) bool."""
    ncol, nlev = cloud_fraction.shape
    reg_fracs, od_scaling, u_mat, v_mat, cloud_cover = _regions(
        config, cloud_fraction, fractional_std, overlap_param)
    c = lambda x: x.contiguous()
    return dict(reg_fracs=reg_fracs, scal2=c(od_scaling), rf3=c(reg_fracs),
                u9=c(u_mat.reshape(ncol, nlev + 1, 9)),
                v9=c(v_mat.reshape(ncol, nlev + 1, 9)),
                clear=c(cloud_fraction <= 0.0), cloud_cover=cloud_cover)


def lw_fused_args(config, od, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, cloud_fraction, fractional_std,
                  overlap_param, planck_hl, emission, albedo):
    """The arguments of cuda_tripleclouds.lw_fused for
    solver_tripleclouds_lw's inputs, and the prep dict."""
    P = fused_prep(config, cloud_fraction, fractional_std, overlap_param)
    c = lambda x: x.contiguous()
    src0 = P["reg_fracs"][:, -1, :, None] * emission[:, None, :]
    args = (c(od), c(od_cloud_b), c(ssa_cloud_b), c(g_cloud_b), P["scal2"],
            P["clear"], P["rf3"], P["u9"], P["v9"], c(planck_hl),
            c(emission), c(torch.broadcast_to(albedo, emission.shape)),
            c(src0), band_from_g, config.do_lw_derivatives)
    return args, P


def _solver_tripleclouds_lw_fused(config, od, od_cloud_b, ssa_cloud_b,
                                  g_cloud_b, band_from_g, cloud_fraction,
                                  fractional_std, overlap_param, planck_hl,
                                  emission, albedo,
                                  spec_matrix=None) -> LwFluxes:
    """Fused-kernel LW path (cuda_tripleclouds.lw_fused), with the
    kernel's per-g planes projected through spec_matrix when given."""
    ncol = cloud_fraction.shape[0]
    args, P = lw_fused_args(config, od, od_cloud_b, ssa_cloud_b, g_cloud_b,
                            band_from_g, cloud_fraction, fractional_std,
                            overlap_param, planck_hl, emission, albedo)
    r = cuda_tripleclouds.lw_fused(*args, planes=spec_matrix is not None)
    proj = lambda k: project(r.get(k), spec_matrix)  # noqa: E731
    zeros = torch.zeros((ncol,), dtype=od.dtype, device=od.device)
    src_top = r["src_top_t"]                          # (ncol, 3, ng)
    out = LwFluxes(
        flux_up=_stack_top(src_top.sum((1, 2)), r["up_bb_t"]),
        flux_dn=_stack_top(zeros, r["dn_bb_t"]),
        # the clear up sweep stores the flux above each layer (half
        # levels 0..nlev-1); the surface value is emission + albedo * fdn
        flux_up_clear=_stack_bot(r["up_bb_c"], r["fup_surf_c"].sum(-1)),
        flux_dn_clear=_stack_top(zeros, r["dn_bb_c"]),
        lw_dn_surf_g=r["fdn_surf_t"], lw_up_toa_g=src_top.sum(1),
        lw_dn_surf_clear_g=r["fdn_surf_c"],
        lw_up_toa_clear_g=r["fup_toa_c"],
        cloud_cover=P["cloud_cover"],
        flux_up_s=proj("up_g_t"), flux_dn_s=proj("dn_g_t"),
        flux_up_clear_s=proj("up_g_c"), flux_dn_clear_s=proj("dn_g_c"))
    if config.do_lw_derivatives:
        ones = torch.ones((ncol, 1), dtype=od.dtype, device=od.device)
        out = out._replace(lw_derivatives=torch.cat([r["deriv_t"], ones],
                                                    dim=1))
    return out


def sw_fused_args(config, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, cloud_fraction, fractional_std,
                  overlap_param, incoming_sw, cos_sza, albedo_diffuse,
                  albedo_direct):
    """The arguments of cuda_tripleclouds.sw_fused for
    solver_tripleclouds_sw's inputs, and the prep dict."""
    P = fused_prep(config, cloud_fraction, fractional_std, overlap_param)
    c = lambda x: x.contiguous()
    ncol = cloud_fraction.shape[0]
    shape = incoming_sw.shape
    mu0 = torch.clamp(cos_sza, min=1.0e-10)
    fdir0 = P["reg_fracs"][:, 0, :, None] * incoming_sw[:, None, :]
    alb_dif = torch.broadcast_to(albedo_diffuse, shape)
    alb_dir = torch.broadcast_to(albedo_direct, shape)
    # the three regions' surface uses the unclamped cos_sza; the clear
    # scene (adding_sw_reduced) the clamped one
    albd_mu0 = cos_sza[:, None] * alb_dir
    albd_mu0_c = mu0[:, None] * alb_dir
    # regions 2 and 3 start at the surface only if the lowest layer is
    # cloudy (tripleclouds_sw.F90 mask_srf)
    mask_srf = torch.ones((ncol, NREG, 1), dtype=torch.bool,
                          device=od.device)
    mask_srf[:, 1:] = (cloud_fraction[:, -1] > 0.0)[:, None, None]
    mk3 = lambda x: c(torch.where(mask_srf, x[:, None, :],
                                  torch.zeros_like(x)[:, None, :]))
    args = (c(od), c(ssa), c(g), c(od_cloud_b), c(ssa_cloud_b),
            c(g_cloud_b), P["scal2"], P["clear"], P["v9"], c(mu0),
            c(incoming_sw), c(fdir0), c(alb_dif), c(albd_mu0_c),
            mk3(alb_dif), mk3(albd_mu0), band_from_g,
            config.do_sw_delta_scaling_with_gases)
    P.update(fdir0=args[11], mu0=args[9])
    return args, P


def _solver_tripleclouds_sw_fused(config, od, ssa, g, od_cloud_b,
                                  ssa_cloud_b, g_cloud_b, band_from_g,
                                  cloud_fraction, fractional_std,
                                  overlap_param, incoming_sw, cos_sza,
                                  albedo_diffuse, albedo_direct,
                                  spec_matrix=None) -> SwFluxes:
    """Fused-kernel SW path (cuda_tripleclouds.sw_fused), with the
    kernel's per-g planes projected through spec_matrix when given (mu0
    applied to the direct flux after the projection, as in the JAX
    package: max(cos_sza, 0) for the three regions, the clamped mu0 for
    the clear scene)."""
    ncol = cloud_fraction.shape[0]
    args, P = sw_fused_args(config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                            g_cloud_b, band_from_g, cloud_fraction,
                            fractional_std, overlap_param, incoming_sw,
                            cos_sza, albedo_diffuse, albedo_direct)
    r = cuda_tripleclouds.sw_fused(*args, planes=spec_matrix is not None)
    proj = lambda k: project(r.get(k), spec_matrix)  # noqa: E731
    fdir0, mu0 = P["fdir0"], P["mu0"]
    zeros = torch.zeros((ncol,), dtype=od.dtype, device=od.device)
    mu0p = torch.clamp(cos_sza, min=0.0)[:, None]

    fup0 = fdir0 * r["albd_top"]                      # (ncol, 3, ng)
    fdir_bb = mu0p * _stack_top(fdir0.sum((1, 2)), r["dir_bb_t"])
    up_toa_c_g = incoming_sw * r["albd_top_c"]
    clear_dir = mu0p * _stack_top(incoming_sw.sum(-1), r["dir_bb_c"])
    return _zero_night(cos_sza, SwFluxes(
        flux_up=_stack_top(fup0.sum((1, 2)), r["up_bb_t"]),
        flux_dn=_stack_top(zeros, r["dn_bb_t"]) + fdir_bb,
        flux_dn_direct=fdir_bb,
        flux_up_clear=_stack_top(up_toa_c_g.sum(-1), r["up_bb_c"]),
        flux_dn_clear=_stack_top(zeros, r["dn_bb_c"]) + clear_dir,
        flux_dn_direct_clear=clear_dir,
        sw_dn_diffuse_surf_g=r["fdn_surf_t"],
        sw_dn_direct_surf_g=mu0p * r["fdir_surf_t"],
        sw_up_toa_g=fup0.sum(1),
        sw_dn_diffuse_surf_clear_g=r["fdn_surf_c"],
        sw_dn_direct_surf_clear_g=mu0[:, None] * r["fdir_surf_c"],
        sw_up_toa_clear_g=up_toa_c_g,
        cloud_cover=P["cloud_cover"],
        **_sw_spectral(proj, mu0p, mu0[:, None])))


def _sw_spectral(proj, mu0_t, mu0_c) -> dict:
    """The spectral SwFluxes fields of the fused SW path from its projected
    planes (proj(name), None without a projection): the direct flux times
    mu0 (mu0_t, mu0_c (ncol, 1) for the three regions and the clear
    scene), added to the diffuse flux for the total down flux."""
    out = {}
    for tag, mu0, sfx in (("t", mu0_t, "_s"), ("c", mu0_c, "_clear_s")):
        up, dn, dr = (proj(f"{k}_g_{tag}") for k in ("up", "dn", "dir"))
        if up is None:
            return {}
        dr = dr * mu0[:, :, None]
        out.update({f"flux_up{sfx}": up, f"flux_dn{sfx}": dn + dr,
                    f"flux_dn_direct{sfx}": dr})
    return out
