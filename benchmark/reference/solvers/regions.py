"""The three regions of a layer (clear, thin cloud, thick cloud) that the
SPARTACUS solvers work in: their fractions and cloud optical depth
scalings (radiation_regions.F90:35-202), the overlap matrices between the
regions of adjacent layers (radiation_overlap.F90:280-459, alpha overlap)
and the regions' merged optical properties.
"""

from __future__ import annotations

import torch

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


def region_properties(cloud_fraction, frac_std, do_gamma,
                      frac_threshold):
    """radiation_regions.F90:35-202, three regions: (reg_fracs (ncol,
    nlev, 3), od_scaling (ncol, nlev, 2) of the two cloudy regions)."""
    cf = cloud_fraction
    cloudy = cf >= frac_threshold
    zero, one = torch.zeros_like(cf), torch.ones_like(cf)
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


def overlap_matrices(reg_fracs, overlap_param, decorr_scaling,
                     frac_threshold):
    """radiation_overlap.F90:280-459 (alpha overlap, three regions):
    reg_fracs (ncol, nlev, 3), overlap_param (ncol, nlev-1).  Returns
    (u, v) each (ncol, nlev+1, 3, 3), interface j between layers j-1 and
    j (clear above the top and below the surface), u[upper, lower] =
    overlap / lower fraction, v[lower, upper] = overlap / upper fraction,
    and the total cloud cover (ncol,)."""
    ncol = reg_fracs.shape[0]
    kw = dict(dtype=reg_fracs.dtype, device=reg_fracs.device)
    clear1 = torch.tensor([1.0, 0.0, 0.0], **kw).expand(ncol, 1, NREG)
    fu = torch.cat([clear1, reg_fracs], dim=1)    # the layer above
    fl = torch.cat([reg_fracs, clear1], dim=1)    # the layer below
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
    # the overlap of the optically thick regions within the cloud
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
    u = torch.where((fl >= frac_threshold)[..., None, :],
                    ov / torch.clamp(fl[..., None, :], min=1e-30), zero)
    v = torch.where((fu >= frac_threshold)[..., None, :],
                    ov.transpose(-1, -2)
                    / torch.clamp(fu[..., None, :], min=1e-30), zero)
    cloud_cover = 1.0 - torch.prod(v[..., 0, 0], dim=1)
    return u, v, cloud_cover


def merge_regions(od, ssa, g, odc_b, ssac_b, gc_b, band_of_g, scal2):
    """The optical properties of the two cloudy regions: the clear-sky
    (gas and aerosol) od, ssa, g (ncol, nlev, ng) with the band-wise cloud
    properties (ncol, nlev, nband), the cloud's od scaled by each region's
    scaling scal2 (ncol, nlev, 2).  Returns od, ssa, g, each (ncol, nlev,
    2, ng); ssa is 0 where od is, g where the scattering is."""
    odc = scal2[..., :, None] * odc_b[..., band_of_g][..., None, :]
    ssac = ssac_b[..., band_of_g][..., None, :]
    gc = gc_b[..., band_of_g][..., None, :]
    od_tot = od[..., None, :] + odc
    scat_clear = (ssa * od)[..., None, :]
    scat_cloud = ssac * odc
    scat = scat_clear + scat_cloud
    gscat = g[..., None, :] * scat_clear + gc * scat_cloud
    zero = torch.zeros_like(scat)
    ssa_tot = torch.where(od_tot > 0.0,
                          scat / torch.clamp(od_tot, min=1e-300), zero)
    g_tot = torch.where(scat > 0.0, gscat / torch.clamp(scat, min=1e-300),
                        zero)
    return od_tot, ssa_tot, g_tot
