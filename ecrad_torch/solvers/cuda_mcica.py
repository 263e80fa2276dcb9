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

from ecrad_torch import kernels
from ecrad_torch.solvers import cuda_adding, two_stream


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
    sweeps of cuda_adding, then the derivatives."""
    nlev = od.shape[1]
    (trans_c, s_up_c, s_dn_c), (refl, trans, s_up, s_dn) = _lw_layers(
        od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl, band_of_g)
    clear = cuda_adding.lw_noscat_sweeps_plain(trans_c, s_up_c, s_dn_c,
                                               emission, albedo, planes)
    tot = cuda_adding.scat_sweeps_plain(refl, trans, s_up, s_dn, albedo,
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
    the kernel): cuda_adding's three SW sweeps on the clear and the
    total-sky coefficients.  mu0 (ncol,) already clamped to 1e-10."""
    cl, tot = _sw_layers(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask,
                         mu0, band_of_g, delta_gases)
    out = {}
    for tag, coeffs in (("c", cl), ("t", tot)):
        r = cuda_adding.sw_sweeps_plain(*coeffs, incoming, alb_dif,
                                        alb_dir_mu0, planes)
        out.update({f"{k}_{tag}": v for k, v in r.items()})
    return out


def _check(name, ref, specs, mask):
    """Device/dtype/shape/contiguity checks before a launch."""
    kernels.check_inputs(name, ref, specs)
    if mask.dtype != torch.bool or mask.device != ref.device \
            or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous bool tensor "
                         f"on {ref.device}")


def _band_index(band_of_g, ng, nband, device):
    """band_of_g as the kernels read it (int32 on the device), checked to
    index only existing bands: the kernels read band rows unguarded."""
    if tuple(band_of_g.shape) != (ng,):
        raise ValueError(f"band_of_g has shape {tuple(band_of_g.shape)}, "
                         f"expected ({ng},)")
    lo, hi = int(band_of_g.min()), int(band_of_g.max())
    if lo < 0 or hi >= nband:
        raise ValueError(f"band_of_g spans bands {lo}..{hi}, outside "
                         f"0..{nband - 1}")
    return band_of_g.to(device=device, dtype=torch.int32).contiguous()


LW_FUSED_MAX_NG = 256      # csrc/lw_fused.cu's __launch_bounds__


def plane_outputs(out, e, ncol, nlev, ng, names, planes):
    """Add the per-g planes ``names`` (ncol, nlev+1, ng) to a wrapper's
    outputs when planes is asked for; returns their pointers (None without
    planes) in the order of ``names``."""
    if not planes:
        return [None] * len(names)
    out.update({n: e(ncol, nlev + 1, ng) for n in names})
    return [out[n] for n in names]


LW_PLANES = ("up_g_c", "dn_g_c", "up_g_t", "dn_g_t")
SW_PLANES = ("up_g_c", "dn_g_c", "dir_g_c", "up_g_t", "dn_g_t", "dir_g_t")


def lw_fused(od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl,
             emission, albedo, band_of_g, do_derivatives, planes=False):
    """Fused McICA LW sweeps.  CPU tensors run lw_fused_plain; CUDA
    tensors launch the kernel (csrc/lw_fused.cu, its build with per-g
    planes when planes is asked for) or raise."""
    if od.device.type == "cpu":
        return lw_fused_plain(od, odc_b, ssac_b, gc_b, od_scaling, mask,
                              planck_hl, emission, albedo, band_of_g,
                              do_derivatives, planes)
    ncol, nlev, ng = od.shape
    nband = odc_b.shape[-1]
    _check("lw_fused", od, {
        "od": (od, (ncol, nlev, ng)), "odc_b": (odc_b, (ncol, nlev, nband)),
        "ssac_b": (ssac_b, (ncol, nlev, nband)),
        "gc_b": (gc_b, (ncol, nlev, nband)),
        "od_scaling": (od_scaling, (ncol, nlev, ng)),
        "planck_hl": (planck_hl, (ncol, nlev + 1, ng)),
        "emission": (emission, (ncol, ng)), "albedo": (albedo, (ncol, ng)),
    }, mask)
    if tuple(mask.shape) != (ncol, nlev):
        raise ValueError(f"lw_fused: mask has shape {tuple(mask.shape)}")
    if ng > LW_FUSED_MAX_NG:
        raise ValueError(f"lw_fused: ng={ng} exceeds the kernel's "
                         f"{LW_FUSED_MAX_NG} threads")
    bog = _band_index(band_of_g, ng, nband, od.device)
    e = lambda *shape: torch.empty(shape, dtype=od.dtype, device=od.device)
    out = dict(dn_bb_c=e(ncol, nlev), fdn_surf_c=e(ncol, ng),
               up_bb_c=e(ncol, nlev), fup_toa_c=e(ncol, ng),
               fup_surf_c=e(ncol, ng), src_top_t=e(ncol, ng),
               dn_bb_t=e(ncol, nlev), up_bb_t=e(ncol, nlev),
               fdn_surf_t=e(ncol, ng), fup_surf_t=e(ncol, ng))
    if do_derivatives:
        out.update(deriv_c=e(ncol, nlev), deriv_t=e(ncol, nlev))
    plane_ptrs = plane_outputs(out, e, ncol, nlev, ng, LW_PLANES, planes)
    if ncol == 0:
        return out
    # scratch: the total-sky albedo and source below each layer, and the
    # total-sky derivative weights
    scratch = [e(ncol, nlev, ng), e(ncol, nlev, ng),
               e(ncol, nlev, ng) if do_derivatives else None]
    ptrs = kernels.pointer_array([
        od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl, emission,
        albedo, bog, out["dn_bb_c"], out["fdn_surf_c"], out["up_bb_c"],
        out["fup_toa_c"], out["fup_surf_c"], out["src_top_t"],
        out["dn_bb_t"], out["up_bb_t"], out["fdn_surf_t"],
        out["fup_surf_t"], out.get("deriv_c"), out.get("deriv_t"),
        *scratch, *plane_ptrs])
    lib = kernels.library()
    fn = (lib.ecrad_lw_fused_f32 if od.dtype == torch.float32
          else lib.ecrad_lw_fused_f64)
    with torch.cuda.device(od.device):
        code = fn(ptrs, ncol, nlev, ng, nband, int(bool(planes)),
                  kernels.stream_of(od))
    kernels.check(code, "lw_fused")
    lw_fused.launches += 1
    return out


lw_fused.launches = 0


SW_FUSED_MAX_NG = 256      # csrc/sw_fused.cu's __launch_bounds__


def sw_fused(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling, mask, mu0,
             incoming, alb_dif, alb_dir_mu0, band_of_g, delta_gases,
             planes=False):
    """Fused McICA SW sweeps.  CPU tensors run sw_fused_plain; CUDA
    tensors launch the kernel (csrc/sw_fused.cu, its build with per-g
    planes when planes is asked for) or raise."""
    if od.device.type == "cpu":
        return sw_fused_plain(od, ssa, g, odc_b, ssac_b, gc_b, od_scaling,
                              mask, mu0, incoming, alb_dif, alb_dir_mu0,
                              band_of_g, delta_gases, planes)
    ncol, nlev, ng = od.shape
    nband = odc_b.shape[-1]
    _check("sw_fused", od, {
        "od": (od, (ncol, nlev, ng)), "ssa": (ssa, (ncol, nlev, ng)),
        "g": (g, (ncol, nlev, ng)),
        "odc_b": (odc_b, (ncol, nlev, nband)),
        "ssac_b": (ssac_b, (ncol, nlev, nband)),
        "gc_b": (gc_b, (ncol, nlev, nband)),
        "od_scaling": (od_scaling, (ncol, nlev, ng)),
        "mu0": (mu0, (ncol,)), "incoming": (incoming, (ncol, ng)),
        "alb_dif": (alb_dif, (ncol, ng)),
        "alb_dir_mu0": (alb_dir_mu0, (ncol, ng)),
    }, mask)
    if tuple(mask.shape) != (ncol, nlev):
        raise ValueError(f"sw_fused: mask has shape {tuple(mask.shape)}")
    if ng > SW_FUSED_MAX_NG:
        raise ValueError(f"sw_fused: ng={ng} exceeds the kernel's "
                         f"{SW_FUSED_MAX_NG} threads")
    bog = _band_index(band_of_g, ng, nband, od.device)
    e = lambda *shape: torch.empty(shape, dtype=od.dtype, device=od.device)
    out = {}
    for tag in ("c", "t"):
        out.update({f"dir_bb_{tag}": e(ncol, nlev),
                    f"fdir_surf_{tag}": e(ncol, ng),
                    f"src_top_{tag}": e(ncol, ng),
                    f"dn_bb_{tag}": e(ncol, nlev),
                    f"up_bb_{tag}": e(ncol, nlev),
                    f"fdn_surf_{tag}": e(ncol, ng)})
    plane_ptrs = plane_outputs(out, e, ncol, nlev, ng, SW_PLANES, planes)
    if ncol == 0:
        return out
    # scratch: the diffuse and direct albedos of both scenes below each layer
    scratch = [e(ncol, nlev, ng) for _ in range(4)]
    ptrs = kernels.pointer_array([
        od, ssa, g, od_scaling, odc_b, ssac_b, gc_b, mask, mu0, incoming,
        alb_dif, alb_dir_mu0, bog, out["dir_bb_c"], out["dir_bb_t"],
        out["fdir_surf_c"], out["fdir_surf_t"], out["src_top_c"],
        out["src_top_t"], out["dn_bb_c"], out["up_bb_c"], out["dn_bb_t"],
        out["up_bb_t"], out["fdn_surf_c"], out["fdn_surf_t"], *scratch,
        *plane_ptrs])
    lib = kernels.library()
    fn = (lib.ecrad_sw_fused_f32 if od.dtype == torch.float32
          else lib.ecrad_sw_fused_f64)
    with torch.cuda.device(od.device):
        code = fn(ptrs, ncol, nlev, ng, nband, int(bool(delta_gases)),
                  int(bool(planes)), kernels.stream_of(od))
    kernels.check(code, "sw_fused")
    sw_fused.launches += 1
    return out


sw_fused.launches = 0
