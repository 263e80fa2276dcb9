"""Fused Tripleclouds solvers: CUDA kernel wrappers and their plain torch
versions.

Replaces ``ecrad_tpu/solvers/pallas_tripleclouds.py:lw_fused`` and
``sw_fused``; the kernels are ``ecrad_torch/csrc/tripleclouds_lw.cu`` and
``tripleclouds_sw.cu``.  Each returns the same named outputs as its TPU
counterpart, in the port's layout: per-level broadband sums
``(ncol, nlev)``, per-g boundary planes ``(ncol, ng)``, per-region planes
``(ncol, 3, ng)``.

Inputs: gas optics ``(ncol, nlev, ng)``; in-cloud band properties
``(ncol, nlev, nband)``; the od scalings of the two cloudy regions
``scal2 (ncol, nlev, 2)``; the clear-layer flags ``clear (ncol, nlev)``
bool (cloud fraction <= 0); region fractions ``rf3 (ncol, nlev, 3)``; the
overlap matrices ``u9``/``v9 (ncol, nlev+1, 9)`` at the interfaces (entry
k = 3*i + j, interface j above layer j, interface nlev the surface);
Planck ``(ncol, nlev+1, ng)``; surface planes ``(ncol, ng)`` and
``(ncol, 3, ng)``; ``band_of_g (ng,)`` (the kernels look the band up).

Interface indexing, the three ways it is offset:
* the up sweeps mix at the interface above the layer (index l);
* the down sweeps mix at the interface below the layer (index l + 1);
* the derivative pass mixes with u at the interface below, surface up.
A mix is skipped where the layer and its neighbour across that interface
are both clear; the layers above TOA and below the surface count as clear.
"""

from __future__ import annotations

import torch

from ecrad_torch import kernels
from ecrad_torch.solvers import two_stream
from ecrad_torch.solvers.cuda_mcica import _band_index, _check

NREG = 3


def _mix(m9, x, eq):
    """Interface mix of a (ncol, 3, ng) carry with a (ncol, 9) matrix."""
    return torch.einsum(eq, m9.reshape(-1, NREG, NREG), x)


def mix_v(v9, x):
    """out[r] = sum_l v[l, r] x[l] (pallas_tripleclouds._mix_v)."""
    return _mix(v9, x, "clr,clg->crg")


def mix_v_dn(v9, x):
    """out[l] = sum_r v[l, r] x[r] (pallas_tripleclouds._mix_v_dn)."""
    return _mix(v9, x, "clr,crg->clg")


def mix_u(u9, x):
    """out[u] = sum_l u[u, l] x[l] (pallas_tripleclouds._mix_u)."""
    return _mix(u9, x, "cul,clg->cug")


def skip_mix(clear, l, other):
    """(ncol, 1, 1): layer l and layer `other` (its neighbour across the
    mixing interface) both clear; layers outside 0..nlev-1 (above TOA,
    below the surface) count as clear."""
    nlev = clear.shape[1]
    c = clear[:, l]
    if 0 <= other < nlev:
        c = c & clear[:, other]
    return c[:, None, None]


def zero_cloudy_regions(clear, l, x):
    """x (ncol, 3, ng) with the cloudy regions (1, 2) zeroed where layer l
    is clear."""
    reg = torch.arange(NREG, device=x.device) > 0
    return torch.where(clear[:, l, None, None] & reg[None, :, None], 0.0, x)


def with_regions(clear, clear_coef, cloudy2, clear_fill=0.0):
    """Clear-sky (ncol, nlev, ng) and cloudy-region (ncol, nlev, 2, ng)
    coefficients -> (ncol, nlev, 3, ng), the cloudy regions set to
    clear_fill in clear layers."""
    cl2 = torch.where(clear[..., None, None],
                      torch.full_like(cloudy2, clear_fill), cloudy2)
    return torch.cat([clear_coef[..., None, :], cl2], dim=-2)


def merge_regions(od, ssa, g, odc_b, ssac_b, gc_b, band_of_g, scal2):
    """Gas (+aerosol) and scaled cloud optical properties of the two
    cloudy regions (tripleclouds._merge_regions): od (ncol, nlev, ng),
    band properties (ncol, nlev, nband), scal2 (ncol, nlev, 2) ->
    (ncol, nlev, 2, ng) each.  ssa and g are None for an absorbing gas
    (the LW without aerosol scattering).  The reference's 1e-300 division
    floors sit behind a test of the divisor, so that a float32 0/0 (the
    floor is 0 there) gives 0, as the float64 floor does."""
    odc = scal2[..., :, None] * odc_b[..., band_of_g][..., None, :]
    ssac = ssac_b[..., band_of_g][..., None, :]
    gc = gc_b[..., band_of_g][..., None, :]
    od_tot = od[..., None, :] + odc
    scat_cloud = ssac * odc
    if ssa is None:
        scat, gscat = scat_cloud, gc * scat_cloud
    else:
        scat_clear = (ssa * od)[..., None, :]
        scat = scat_clear + scat_cloud
        gscat = g[..., None, :] * scat_clear + gc * scat_cloud
    zero = torch.zeros_like(scat)
    ssa_tot = torch.where(od_tot > 0.0,
                          scat / torch.clamp(od_tot, min=1e-300), zero)
    g_tot = torch.where(scat > 0.0, gscat / torch.clamp(scat, min=1e-300),
                        zero)
    return od_tot, ssa_tot, g_tot


def _lw_regions(od, odc_b, ssac_b, gc_b, scal2, clear, rf3, planck_hl,
                band_of_g):
    """Clear no-scattering coefficients (ncol, nlev, ng) and the three
    regions' (refl, trans, src_up, src_dn), (ncol, nlev, 3, ng), sources
    scaled by region fraction; in clear layers the cloudy regions take
    refl 0, trans 1, sources 0 (pallas_tripleclouds._regions_lw)."""
    ptop, pbot = planck_hl[:, :-1], planck_hl[:, 1:]
    trans_c, su_c, sd_c = two_stream.lw_no_scattering_trans(od, ptop, pbot)
    od_t, ssa_t, g_t = merge_regions(od, None, None, odc_b, ssac_b, gc_b,
                                     band_of_g, scal2)
    refl, trans, su, sd = two_stream.lw_ref_trans(
        od_t, ssa_t, g_t, ptop[..., None, :], pbot[..., None, :])
    rf = rf3[..., None]
    return (trans_c, su_c, sd_c), (
        with_regions(clear, torch.zeros_like(trans_c), refl),
        with_regions(clear, trans_c, trans, clear_fill=1.0),
        with_regions(clear, su_c, su) * rf, with_regions(clear, sd_c, sd) * rf)


def lw_fused_plain(od, odc_b, ssac_b, gc_b, scal2, clear, rf3, u9, v9,
                   planck_hl, emission, albedo, src0, band_of_g,
                   do_derivatives):
    """The fused Tripleclouds LW sweeps as torch loops over levels (the
    reference for the kernel)."""
    nlev = od.shape[1]
    (trans_c, su_c, sd_c), (refl, trans, su, sd) = _lw_regions(
        od, odc_b, ssac_b, gc_b, scal2, clear, rf3, planck_hl, band_of_g)
    stack = lambda xs: torch.stack(xs, dim=1)

    # P1: clear-sky downward
    fdn = torch.zeros_like(emission)
    dn_bb_c = []
    for l in range(nlev):
        fdn = trans_c[:, l] * fdn + sd_c[:, l]
        dn_bb_c.append(fdn.sum(-1))
    fdn_surf_c = fdn
    fup_surf_c = emission + albedo * fdn_surf_c

    # P2: clear up (unscaled sources) + 3-region Moebius up, surface -> TOA,
    # mixing at the interface above each layer
    fup = fup_surf_c
    alb = torch.broadcast_to(albedo[:, None, :], src0.shape)
    src = src0
    up_bb_c = [None] * nlev
    albb, srcb = [None] * nlev, [None] * nlev
    for l in range(nlev - 1, -1, -1):
        fup = trans_c[:, l] * fup + su_c[:, l]
        up_bb_c[l] = fup.sum(-1)
        albb[l], srcb[l] = alb, src
        inv = 1.0 / (1.0 - alb * refl[:, l])
        a = refl[:, l] + trans[:, l] * trans[:, l] * alb * inv
        s = su[:, l] + trans[:, l] * (src + alb * sd[:, l]) * inv
        skip = skip_mix(clear, l, l - 1)
        alb = torch.where(skip, a, mix_v(v9[:, l], a))
        src = torch.where(skip, s, mix_u(u9[:, l], s))

    # P3: 3-region downward, mixing at the interface below each layer
    fdn = torch.zeros_like(src0)
    dn_bb_t, up_bb_t = [], []
    for l in range(nlev):
        f = (trans[:, l] * fdn + refl[:, l] * srcb[l] + sd[:, l]) \
            / (1.0 - refl[:, l] * albb[l])
        u = srcb[l] + f * albb[l]
        f = zero_cloudy_regions(clear, l, f)
        u = zero_cloudy_regions(clear, l, u)
        dn_bb_t.append(f.sum((1, 2)))
        up_bb_t.append(u.sum((1, 2)))
        fdn_surf_t, fup_surf_t = f.sum(1), u.sum(1)
        skip = skip_mix(clear, l, l + 1)
        fdn = torch.where(skip, f, mix_v_dn(v9[:, l + 1], f))

    out = dict(dn_bb_c=stack(dn_bb_c), fdn_surf_c=fdn_surf_c,
               fup_surf_c=fup_surf_c, up_bb_c=stack(up_bb_c),
               fup_toa_c=fup, src_top_t=src,
               dn_bb_t=stack(dn_bb_t), up_bb_t=stack(up_bb_t),
               fdn_surf_t=fdn_surf_t, fup_surf_t=fup_surf_t)
    if do_derivatives:
        # Region-coupled Hogan-Bozzo derivatives (radiation_lw_
        # derivatives.F90:200-250), u at the interface below, surface up.
        # Normalised by max(sum_g fup_surf, 1e-30), as the fused TPU path
        # does (the scan form divides by the plain sum).
        dg = torch.zeros_like(src0)
        dg[:, 0] = fup_surf_t / torch.clamp(
            fup_surf_t.sum(-1, keepdim=True), min=1e-30)
        deriv = [None] * nlev
        for l in range(nlev - 1, -1, -1):
            dg = mix_u(u9[:, l + 1], dg) * trans[:, l]
            deriv[l] = dg.sum((1, 2))
        out["deriv_t"] = stack(deriv)
    return out


def _sw_regions(od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear, mu0,
                band_of_g, delta_gases):
    """Clear-sky Meador-Weaver coefficients (no delta scaling) and the
    three regions' (ncol, nlev, 3, ng); the cloudy regions' coefficients
    are zero in clear layers (pallas_tripleclouds._regions_sw)."""
    mu = mu0[:, None, None]
    cl = two_stream.sw_ref_trans(mu, od, ssa, g)
    od_t, ssa_t, g_t = merge_regions(od, ssa, g, odc_b, ssac_b, gc_b,
                                     band_of_g, scal2)
    if delta_gases:
        od_t, ssa_t, g_t = two_stream.delta_eddington(od_t, ssa_t, g_t)
    co = two_stream.sw_ref_trans(mu[..., None], od_t, ssa_t, g_t)
    return cl, tuple(with_regions(clear, c, r) for c, r in zip(cl, co))


def sw_fused_plain(od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear, v9, mu0,
                   incoming, fdir0, alb0_c, albd0_c, alb0_t, albd0_t,
                   band_of_g, delta_gases):
    """The fused Tripleclouds SW sweeps as torch loops over levels (the
    reference for the kernel).  mu0 (ncol,) clamped to 1e-10; incoming
    (ncol, ng); fdir0 (ncol, 3, ng) the region-weighted TOA direct flux;
    alb0_c/albd0_c (ncol, ng) and alb0_t/albd0_t (ncol, 3, ng) the surface
    albedos, the direct ones times mu0 (surface mask applied outside)."""
    nlev = od.shape[1]
    cl, regs = _sw_regions(od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear,
                           mu0, band_of_g, delta_gases)
    stack = lambda xs: torch.stack(xs, dim=1)
    masked = lambda l, x: zero_cloudy_regions(clear, l, x)

    # S1: direct beam down, clear scene and 3 regions
    fc, ft = incoming, fdir0
    ftc, ftt, dir_bb_c, dir_bb_t = [], [], [], []
    for l in range(nlev):
        ftc.append(fc)
        ftt.append(ft)
        fc = cl[4][:, l] * fc
        f = masked(l, regs[4][:, l] * ft)
        dir_bb_c.append(fc.sum(-1))
        dir_bb_t.append(f.sum((1, 2)))
        fdir_surf_t = f.sum(1)
        ft = torch.where(skip_mix(clear, l, l + 1), f,
                         mix_v_dn(v9[:, l + 1], f))

    def up(c, l, alb, albd):
        refl, trans, rdir, tdd, tdir = (x[:, l] for x in c)
        inv = 1.0 / (1.0 - alb * refl)
        return (refl + trans * trans * alb * inv,
                rdir + (tdir * albd + tdd * alb) * trans * inv)

    # S2: diffuse and direct albedos up, mixing at the interface above
    ac, adc, at, adt = alb0_c, albd0_c, alb0_t, albd0_t
    albb_c, albdb_c, albb_t, albdb_t = ([None] * nlev for _ in range(4))
    for l in range(nlev - 1, -1, -1):
        albb_c[l], albdb_c[l], albb_t[l], albdb_t[l] = ac, adc, at, adt
        ac, adc = up(cl, l, ac, adc)
        a, ad = up(regs, l, at, adt)
        a, ad = masked(l, a), masked(l, ad)
        skip = skip_mix(clear, l, l - 1)
        at = torch.where(skip, a, mix_v(v9[:, l], a))
        adt = torch.where(skip, ad, mix_v(v9[:, l], ad))

    def down(c, l, fdir_top, fdn, alb, albd):
        refl, trans, _, tdd, tdir = (x[:, l] for x in c)
        fdn = (trans * fdn + fdir_top * (tdir * albd * refl + tdd)) \
            / (1.0 - refl * alb)
        return fdn, fdn * alb + tdir * fdir_top * albd

    # S3: diffuse down, both scenes, mixing at the interface below
    dc = torch.zeros_like(incoming)
    dt = torch.zeros_like(fdir0)
    dn_bb_c, up_bb_c, dn_bb_t, up_bb_t = [], [], [], []
    for l in range(nlev):
        dc, uc = down(cl, l, ftc[l], dc, albb_c[l], albdb_c[l])
        dn_bb_c.append(dc.sum(-1))
        up_bb_c.append(uc.sum(-1))
        f, u = down(regs, l, ftt[l], dt, albb_t[l], albdb_t[l])
        f, u = masked(l, f), masked(l, u)
        dn_bb_t.append(f.sum((1, 2)))
        up_bb_t.append(u.sum((1, 2)))
        fdn_surf_t = f.sum(1)
        dt = torch.where(skip_mix(clear, l, l + 1), f,
                         mix_v_dn(v9[:, l + 1], f))

    return dict(albd_top=adt, albd_top_c=adc,
                dir_bb_c=stack(dir_bb_c), dir_bb_t=stack(dir_bb_t),
                fdir_surf_c=fc, fdir_surf_t=fdir_surf_t,
                dn_bb_c=stack(dn_bb_c), up_bb_c=stack(up_bb_c),
                dn_bb_t=stack(dn_bb_t), up_bb_t=stack(up_bb_t),
                fdn_surf_c=dc, fdn_surf_t=fdn_surf_t)


def _empty(ref):
    return lambda *shape: torch.empty(shape, dtype=ref.dtype,
                                      device=ref.device)


def lw_fused(od, odc_b, ssac_b, gc_b, scal2, clear, rf3, u9, v9, planck_hl,
             emission, albedo, src0, band_of_g, do_derivatives):
    """Fused Tripleclouds LW sweeps.  CPU tensors run lw_fused_plain; CUDA
    tensors launch the kernel (csrc/tripleclouds_lw.cu) or raise."""
    if od.device.type == "cpu":
        return lw_fused_plain(od, odc_b, ssac_b, gc_b, scal2, clear, rf3,
                              u9, v9, planck_hl, emission, albedo, src0,
                              band_of_g, do_derivatives)
    if od.device.type != "cuda":
        raise ValueError(f"tripleclouds lw_fused: unsupported device "
                         f"{od.device}")
    ncol, nlev, ng = od.shape
    nband = odc_b.shape[-1]
    _check("tripleclouds lw_fused", od, {
        "od": (od, (ncol, nlev, ng)), "odc_b": (odc_b, (ncol, nlev, nband)),
        "ssac_b": (ssac_b, (ncol, nlev, nband)),
        "gc_b": (gc_b, (ncol, nlev, nband)),
        "scal2": (scal2, (ncol, nlev, 2)), "rf3": (rf3, (ncol, nlev, NREG)),
        "u9": (u9, (ncol, nlev + 1, 9)), "v9": (v9, (ncol, nlev + 1, 9)),
        "planck_hl": (planck_hl, (ncol, nlev + 1, ng)),
        "emission": (emission, (ncol, ng)), "albedo": (albedo, (ncol, ng)),
        "src0": (src0, (ncol, NREG, ng)),
    }, clear)
    if tuple(clear.shape) != (ncol, nlev):
        raise ValueError(f"tripleclouds lw_fused: clear has shape "
                         f"{tuple(clear.shape)}")
    bog = _band_index(band_of_g, ng, nband, od.device)
    e = _empty(od)
    out = dict(dn_bb_c=e(ncol, nlev), fdn_surf_c=e(ncol, ng),
               fup_surf_c=e(ncol, ng), up_bb_c=e(ncol, nlev),
               fup_toa_c=e(ncol, ng), src_top_t=e(ncol, NREG, ng),
               dn_bb_t=e(ncol, nlev), up_bb_t=e(ncol, nlev),
               fdn_surf_t=e(ncol, ng), fup_surf_t=e(ncol, ng))
    if do_derivatives:
        out["deriv_t"] = e(ncol, nlev)
    if ncol == 0:
        return out
    # the albedo and source of the atmosphere below each layer, per region
    albb, srcb = e(ncol, nlev, NREG, ng), e(ncol, nlev, NREG, ng)
    ptrs = kernels.pointer_array([
        od, odc_b, ssac_b, gc_b, scal2, clear, rf3, u9, v9, planck_hl,
        emission, albedo, src0, bog, out["dn_bb_c"], out["fdn_surf_c"],
        out["fup_surf_c"], out["up_bb_c"], out["fup_toa_c"],
        out["src_top_t"], out["dn_bb_t"], out["up_bb_t"], out["fdn_surf_t"],
        out["fup_surf_t"], out.get("deriv_t"), albb, srcb])
    lib = kernels.library()
    fn = (lib.ecrad_tripleclouds_lw_f32 if od.dtype == torch.float32
          else lib.ecrad_tripleclouds_lw_f64)
    with torch.cuda.device(od.device):
        code = fn(ptrs, ncol, nlev, ng, nband, kernels.stream_of(od))
    kernels.check(code, "tripleclouds lw_fused")
    lw_fused.launches += 1
    return out


lw_fused.launches = 0


def sw_fused(od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear, v9, mu0,
             incoming, fdir0, alb0_c, albd0_c, alb0_t, albd0_t, band_of_g,
             delta_gases):
    """Fused Tripleclouds SW sweeps.  CPU tensors run sw_fused_plain; CUDA
    tensors launch the kernel (csrc/tripleclouds_sw.cu) or raise."""
    if od.device.type == "cpu":
        return sw_fused_plain(od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear,
                              v9, mu0, incoming, fdir0, alb0_c, albd0_c,
                              alb0_t, albd0_t, band_of_g, delta_gases)
    if od.device.type != "cuda":
        raise ValueError(f"tripleclouds sw_fused: unsupported device "
                         f"{od.device}")
    ncol, nlev, ng = od.shape
    nband = odc_b.shape[-1]
    _check("tripleclouds sw_fused", od, {
        "od": (od, (ncol, nlev, ng)), "ssa": (ssa, (ncol, nlev, ng)),
        "g": (g, (ncol, nlev, ng)), "odc_b": (odc_b, (ncol, nlev, nband)),
        "ssac_b": (ssac_b, (ncol, nlev, nband)),
        "gc_b": (gc_b, (ncol, nlev, nband)),
        "scal2": (scal2, (ncol, nlev, 2)), "v9": (v9, (ncol, nlev + 1, 9)),
        "mu0": (mu0, (ncol,)), "incoming": (incoming, (ncol, ng)),
        "fdir0": (fdir0, (ncol, NREG, ng)), "alb0_c": (alb0_c, (ncol, ng)),
        "albd0_c": (albd0_c, (ncol, ng)),
        "alb0_t": (alb0_t, (ncol, NREG, ng)),
        "albd0_t": (albd0_t, (ncol, NREG, ng)),
    }, clear)
    if tuple(clear.shape) != (ncol, nlev):
        raise ValueError(f"tripleclouds sw_fused: clear has shape "
                         f"{tuple(clear.shape)}")
    bog = _band_index(band_of_g, ng, nband, od.device)
    e = _empty(od)
    out = dict(albd_top=e(ncol, NREG, ng), albd_top_c=e(ncol, ng),
               dir_bb_c=e(ncol, nlev), dir_bb_t=e(ncol, nlev),
               fdir_surf_c=e(ncol, ng), fdir_surf_t=e(ncol, ng),
               dn_bb_c=e(ncol, nlev), up_bb_c=e(ncol, nlev),
               dn_bb_t=e(ncol, nlev), up_bb_t=e(ncol, nlev),
               fdn_surf_c=e(ncol, ng), fdn_surf_t=e(ncol, ng))
    if ncol == 0:
        return out
    # scratch: the direct flux at each layer top (clear, 3 regions) and
    # the diffuse and direct albedos below each layer (clear, 3 regions)
    scratch = [e(ncol, nlev, ng), e(ncol, nlev, NREG, ng),
               e(ncol, nlev, ng), e(ncol, nlev, ng),
               e(ncol, nlev, NREG, ng), e(ncol, nlev, NREG, ng)]
    ptrs = kernels.pointer_array([
        od, ssa, g, odc_b, ssac_b, gc_b, scal2, clear, v9, mu0, incoming,
        fdir0, alb0_c, albd0_c, alb0_t, albd0_t, bog, out["albd_top"],
        out["albd_top_c"], out["dir_bb_c"], out["dir_bb_t"],
        out["fdir_surf_c"], out["fdir_surf_t"], out["dn_bb_c"],
        out["up_bb_c"], out["dn_bb_t"], out["up_bb_t"], out["fdn_surf_c"],
        out["fdn_surf_t"], *scratch])
    lib = kernels.library()
    fn = (lib.ecrad_tripleclouds_sw_f32 if od.dtype == torch.float32
          else lib.ecrad_tripleclouds_sw_f64)
    with torch.cuda.device(od.device):
        code = fn(ptrs, ncol, nlev, ng, nband, int(bool(delta_gases)),
                  kernels.stream_of(od))
    kernels.check(code, "tripleclouds sw_fused")
    sw_fused.launches += 1
    return out


sw_fused.launches = 0
