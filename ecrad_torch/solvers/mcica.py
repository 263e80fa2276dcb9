"""McICA (Monte Carlo Independent Column Approximation) solvers.

Reference: radiation_mcica_lw.F90:39-285, radiation_mcica_sw.F90:41-410;
port of ``ecrad_tpu/solvers/mcica.py``.  The stochastic cloud sample
(``od_scaling`` per g-point/layer and ``total_cloud_cover``) is an
input.  Configurations the fused kernels cover (csrc/lw_fused.cu,
csrc/sw_fused.cu, through solvers/cuda_mcica.py) go there; the others
run the unfused two-stream + adding path.  The rule is the JAX
package's, without its platform test: band-contiguous g ordering, and
for LW cloud scattering on with aerosol scattering off.
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch.solvers import adding, cuda_mcica, two_stream
from ecrad_torch.solvers.adding import LwAdding, SwAdding, _stack_bot, \
    _stack_top
from ecrad_torch.solvers.lw_derivatives import lw_derivatives_ica
from ecrad_torch.solvers.outputs import LwFluxes, SwFluxes


def _gcounts(band_from_g):
    """Per-band g counts, or None when the g axis is not band-contiguous
    (RRTMG band-major ordering is)."""
    bfg = np.asarray(band_from_g.cpu() if torch.is_tensor(band_from_g)
                     else band_from_g)
    if np.any(np.diff(bfg) < 0):
        return None
    return tuple(int(c) for c in np.bincount(bfg))


def _mix(w, cloudy, clear):
    """total_cloud_cover-weighted scene blend, broadcasting w over
    trailing axes (radiation_mcica_lw.F90:236-248)."""
    w = w.reshape(w.shape + (1,) * (cloudy.dim() - 1))
    return w * cloudy + (1.0 - w) * clear


def solver_mcica_lw(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                    band_from_g, od_scaling, total_cloud_cover,
                    cloud_fraction, planck_hl, emission, albedo,
                    cloud_fraction_threshold=1.0e-6,
                    do_lw_cloud_scattering=True,
                    do_lw_aerosol_scattering=False,
                    do_lw_derivatives=False) -> LwFluxes:
    """Args:
      od/ssa/g: clear-sky (gas+aerosol) (ncol, nlev, ng)
      od_cloud_b/...: in-cloud per band (ncol, nlev, nband)
      band_from_g: (ng,) 0-based integer tensor
      od_scaling: (ncol, nlev, ng); total_cloud_cover (ncol,)
      cloud_fraction: (ncol, nlev); planck_hl (ncol, nlev+1, ng)
      emission/albedo: (ncol, ng)
    """
    if (_gcounts(band_from_g) is not None and do_lw_cloud_scattering
            and not do_lw_aerosol_scattering):
        return _solver_mcica_lw_fused(
            od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, planck_hl,
            emission, albedo, cloud_fraction_threshold, do_lw_derivatives)
    planck_top, planck_bot = planck_hl[:, :-1], planck_hl[:, 1:]
    bb = band_from_g

    # --- clear sky
    if do_lw_aerosol_scattering:
        ref_clear, trans_clear, src_up_clear, src_dn_clear = \
            two_stream.lw_ref_trans(od, ssa, g, planck_top, planck_bot)
        clear = adding.adding_lw_reduced(
            ref_clear, trans_clear, src_up_clear, src_dn_clear,
            emission, albedo)
    else:
        trans_clear, src_up_clear, src_dn_clear = \
            two_stream.lw_no_scattering_trans(od, planck_top, planck_bot)
        ref_clear = torch.zeros_like(trans_clear)
        clear = adding.lw_no_scattering_reduced(
            trans_clear, src_up_clear, src_dn_clear, emission, albedo)

    # --- total sky
    cloudy_layer = cloud_fraction >= cloud_fraction_threshold
    od_cloud_g = od_scaling * od_cloud_b[..., bb]
    mask = cloudy_layer[..., None]
    od_total, ssa_total, g_total = cuda_mcica.merge_cloud_lw(
        od, od_cloud_g, mask,
        ssa_cloud_g=ssa_cloud_b[..., bb] if ssa_cloud_b is not None
        else None,
        g_cloud_g=g_cloud_b[..., bb] if g_cloud_b is not None else None,
        ssa_clear=ssa, g_clear=g,
        do_cloud_scattering=do_lw_cloud_scattering,
        do_aerosol_scattering=do_lw_aerosol_scattering)

    if do_lw_cloud_scattering:
        refl_c, trans_c, src_up_c, src_dn_c = two_stream.lw_ref_trans(
            od_total, ssa_total, g_total, planck_top, planck_bot)
        refl = torch.where(mask, refl_c, ref_clear)
        trans = torch.where(mask, trans_c, trans_clear)
        src_up = torch.where(mask, src_up_c, src_up_clear)
        src_dn = torch.where(mask, src_dn_c, src_dn_clear)
        tot = adding.adding_lw_reduced(refl, trans, src_up, src_dn,
                                       emission, albedo)
    else:
        trans_c, src_up_c, src_dn_c = \
            two_stream.lw_no_scattering_trans(od_total, planck_top,
                                              planck_bot)
        trans = torch.where(mask, trans_c, trans_clear)
        src_up = torch.where(mask, src_up_c, src_up_clear)
        src_dn = torch.where(mask, src_dn_c, src_dn_clear)
        tot = adding.lw_no_scattering_reduced(trans, src_up, src_dn,
                                              emission, albedo)

    deriv_cloudy = deriv_clear = None
    if do_lw_derivatives:
        deriv_cloudy = lw_derivatives_ica(trans, tot.up_surf_g)
        deriv_clear = lw_derivatives_ica(trans_clear, clear.up_surf_g)
    return _finish_lw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, deriv_cloudy, deriv_clear)


def _finish_lw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               deriv_cloudy=None, deriv_clear=None) -> LwFluxes:
    """Blend total/clear scenes by cloud cover and pack LwFluxes
    (radiation_mcica_lw.F90:236-248)."""
    tcc = total_cloud_cover
    has_cloud = tcc >= cloud_fraction_threshold
    w = torch.where(has_cloud, tcc, torch.zeros_like(tcc))

    out = LwFluxes(
        flux_up=_mix(w, tot.up, clear.up),
        flux_dn=_mix(w, tot.dn, clear.dn),
        flux_up_clear=clear.up,
        flux_dn_clear=clear.dn,
        lw_dn_surf_g=_mix(w, tot.dn_surf_g, clear.dn_surf_g),
        lw_up_toa_g=_mix(w, tot.up_toa_g, clear.up_toa_g),
        lw_dn_surf_clear_g=clear.dn_surf_g,
        lw_up_toa_clear_g=clear.up_toa_g,
        cloud_cover=w)

    if deriv_cloudy is not None:
        # cloudy-scene derivative, then blend with clear
        # (modify_lw_derivatives_ica)
        wd = torch.where(has_cloud, 1.0 - tcc, torch.ones_like(tcc))[:, None]
        deriv = torch.where(has_cloud[:, None],
                            (1.0 - wd) * deriv_cloudy + wd * deriv_clear,
                            deriv_clear)
        # surface value is defined as exactly 1
        deriv = deriv.clone()
        deriv[:, -1] = 1.0
        out = out._replace(lw_derivatives=deriv)
    return out


def lw_fused_args(od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
                  od_scaling, cloud_fraction, planck_hl, emission, albedo,
                  cloud_fraction_threshold, do_lw_derivatives):
    """The arguments of cuda_mcica.lw_fused for solver_mcica_lw's inputs:
    contiguous, with the cloudy-layer mask and the albedo plane."""
    c = lambda x: x.contiguous()
    return (c(od), c(od_cloud_b), c(ssa_cloud_b), c(g_cloud_b),
            c(od_scaling), c(cloud_fraction >= cloud_fraction_threshold),
            c(planck_hl), c(emission),
            c(torch.broadcast_to(albedo, emission.shape)), band_from_g,
            do_lw_derivatives)


def _solver_mcica_lw_fused(od, od_cloud_b, ssa_cloud_b, g_cloud_b,
                           band_from_g, od_scaling, total_cloud_cover,
                           cloud_fraction, planck_hl, emission, albedo,
                           cloud_fraction_threshold,
                           do_lw_derivatives) -> LwFluxes:
    """Fused-kernel LW path (solvers/cuda_mcica.lw_fused)."""
    ncol = cloud_fraction.shape[0]
    r = cuda_mcica.lw_fused(*lw_fused_args(
        od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g, od_scaling,
        cloud_fraction, planck_hl, emission, albedo,
        cloud_fraction_threshold, do_lw_derivatives))

    zeros = torch.zeros((ncol,), dtype=od.dtype, device=od.device)
    fup_surf_c = r["fup_surf_c"]
    clear = LwAdding(
        up=_stack_bot(r["up_bb_c"], fup_surf_c.sum(-1)),
        dn=_stack_top(zeros, r["dn_bb_c"]),
        up_toa_g=r["fup_toa_c"], dn_surf_g=r["fdn_surf_c"],
        up_surf_g=fup_surf_c)
    src_top_t = r["src_top_t"]
    tot = LwAdding(
        up=_stack_top(src_top_t.sum(-1), r["up_bb_t"]),
        dn=_stack_top(zeros, r["dn_bb_t"]),
        up_toa_g=src_top_t, dn_surf_g=r["fdn_surf_t"],
        up_surf_g=r["fup_surf_t"])

    deriv_cloudy = deriv_clear = None
    if do_lw_derivatives:
        ones = torch.ones((ncol, 1), dtype=od.dtype, device=od.device)
        deriv_cloudy = torch.cat([r["deriv_t"], ones], dim=1)
        deriv_clear = torch.cat([r["deriv_c"], ones], dim=1)
    return _finish_lw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, deriv_cloudy, deriv_clear)


def solver_mcica_sw(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                    band_from_g, od_scaling, total_cloud_cover,
                    cloud_fraction, incoming_sw, cos_sza,
                    albedo_diffuse, albedo_direct,
                    cloud_fraction_threshold=1.0e-6,
                    do_sw_delta_scaling_with_gases=False) -> SwFluxes:
    if _gcounts(band_from_g) is not None:
        return _solver_mcica_sw_fused(
            od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, incoming_sw,
            cos_sza, albedo_diffuse, albedo_direct,
            cloud_fraction_threshold, do_sw_delta_scaling_with_gases)
    mu0 = torch.clamp(cos_sza, min=1.0e-10)[:, None, None]
    bb = band_from_g

    # --- clear sky
    od_c, ssa_c, g_c = od, ssa, g
    if do_sw_delta_scaling_with_gases:
        od_c, ssa_c, g_c = two_stream.delta_eddington(od_c, ssa_c, g_c)
    r_cl, t_cl, rdir_cl, tdd_cl, tdir_cl = two_stream.sw_ref_trans(
        mu0, od_c, ssa_c, g_c)
    clear = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct, mu0[:, :, 0],
        r_cl, t_cl, rdir_cl, tdd_cl, tdir_cl)

    # --- total sky: merge cloud into gas optics per g
    m = (cloud_fraction >= cloud_fraction_threshold)[..., None]
    od_tot, ssa_tot, g_tot = cuda_mcica.merge_cloud_sw(
        od, ssa, g, od_scaling * od_cloud_b[..., bb], ssa_cloud_b[..., bb],
        g_cloud_b[..., bb], m)
    if do_sw_delta_scaling_with_gases:
        od_tot, ssa_tot, g_tot = two_stream.delta_eddington(
            od_tot, ssa_tot, g_tot)
    mg = two_stream.sw_ref_trans(mu0, od_tot, ssa_tot, g_tot)
    refl, trans, rdir, tdd, tdir = (
        torch.where(m, a, b) for a, b in zip(
            mg, (r_cl, t_cl, rdir_cl, tdd_cl, tdir_cl)))
    tot = adding.adding_sw_reduced(
        incoming_sw, albedo_diffuse, albedo_direct, mu0[:, :, 0],
        refl, trans, rdir, tdd, tdir)

    return _finish_sw(clear, tot, total_cloud_cover,
                      cloud_fraction_threshold, cos_sza)


def _finish_sw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               cos_sza) -> SwFluxes:
    """Blend total/clear SW scenes by cloud cover, zero night columns,
    and pack SwFluxes (radiation_mcica_sw.F90 output section)."""
    tcc = total_cloud_cover
    has_cloud = tcc >= cloud_fraction_threshold
    day = cos_sza > 0.0
    w = torch.where(has_cloud, tcc, torch.zeros_like(tcc))

    def zn(x):
        """Zero night columns (the reference only assigns for
        cos_sza > 0, radiation_mcica_sw.F90)."""
        d = day.reshape(day.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, torch.zeros_like(x))

    return SwFluxes(
        flux_up=zn(_mix(w, tot.up, clear.up)),
        flux_dn=zn(_mix(w, tot.dn_diffuse + tot.dn_direct,
                        clear.dn_diffuse + clear.dn_direct)),
        flux_dn_direct=zn(_mix(w, tot.dn_direct, clear.dn_direct)),
        flux_up_clear=zn(clear.up),
        flux_dn_clear=zn(clear.dn_diffuse + clear.dn_direct),
        flux_dn_direct_clear=zn(clear.dn_direct),
        sw_dn_diffuse_surf_g=zn(_mix(w, tot.dn_diffuse_surf_g,
                                     clear.dn_diffuse_surf_g)),
        sw_dn_direct_surf_g=zn(_mix(w, tot.dn_direct_surf_g,
                                    clear.dn_direct_surf_g)),
        sw_up_toa_g=zn(_mix(w, tot.up_toa_g, clear.up_toa_g)),
        sw_dn_diffuse_surf_clear_g=zn(clear.dn_diffuse_surf_g),
        sw_dn_direct_surf_clear_g=zn(clear.dn_direct_surf_g),
        sw_up_toa_clear_g=zn(clear.up_toa_g),
        # night columns keep the reference's unset sentinel -1
        # (radiation_flux.F90 reset; radiation_mcica_sw.F90 only assigns
        # for cos_sza > 0)
        cloud_cover=torch.where(day, tcc, torch.full_like(tcc, -1.0)))


def sw_fused_args(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, od_scaling, cloud_fraction, incoming_sw,
                  cos_sza, albedo_diffuse, albedo_direct,
                  cloud_fraction_threshold, do_sw_delta_scaling_with_gases):
    """The arguments of cuda_mcica.sw_fused for solver_mcica_sw's inputs:
    contiguous, with the cloudy-layer mask, mu0 clamped to 1e-10 and the
    surface planes (the direct albedo times mu0)."""
    c = lambda x: x.contiguous()
    mu0 = torch.clamp(cos_sza, min=1.0e-10)                # (ncol,)
    shape = incoming_sw.shape
    return (c(od), c(ssa), c(g), c(od_cloud_b), c(ssa_cloud_b),
            c(g_cloud_b), c(od_scaling),
            c(cloud_fraction >= cloud_fraction_threshold), c(mu0),
            c(incoming_sw), c(torch.broadcast_to(albedo_diffuse, shape)),
            c(torch.broadcast_to(albedo_direct * mu0[:, None], shape)),
            band_from_g, do_sw_delta_scaling_with_gases)


def _solver_mcica_sw_fused(od, ssa, g, od_cloud_b, ssa_cloud_b,
                           g_cloud_b, band_from_g, od_scaling,
                           total_cloud_cover, cloud_fraction,
                           incoming_sw, cos_sza, albedo_diffuse,
                           albedo_direct, cloud_fraction_threshold,
                           do_sw_delta_scaling_with_gases) -> SwFluxes:
    """Fused-kernel SW path (solvers/cuda_mcica.sw_fused)."""
    ncol = cloud_fraction.shape[0]
    r = cuda_mcica.sw_fused(*sw_fused_args(
        od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        od_scaling, cloud_fraction, incoming_sw, cos_sza, albedo_diffuse,
        albedo_direct, cloud_fraction_threshold,
        do_sw_delta_scaling_with_gases))

    mu0_col = torch.clamp(cos_sza, min=1.0e-10)
    mu0 = mu0_col[:, None]                                 # (ncol, 1)
    dir_toa_bb = incoming_sw.sum(-1)
    zeros_bb = torch.zeros((ncol,), dtype=od.dtype, device=od.device)

    def scene(tag):
        src_top = r[f"src_top_{tag}"]
        return SwAdding(
            up=_stack_top(src_top.sum(-1), r[f"up_bb_{tag}"]),
            dn_diffuse=_stack_top(zeros_bb, r[f"dn_bb_{tag}"]),
            dn_direct=_stack_top(dir_toa_bb, r[f"dir_bb_{tag}"]) * mu0,
            up_toa_g=src_top,
            dn_diffuse_surf_g=r[f"fdn_surf_{tag}"],
            dn_direct_surf_g=r[f"fdir_surf_{tag}"] * mu0)

    return _finish_sw(scene("c"), scene("t"), total_cloud_cover,
                      cloud_fraction_threshold, cos_sza)
