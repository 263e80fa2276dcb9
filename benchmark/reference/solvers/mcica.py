"""McICA (Monte Carlo Independent Column Approximation) solvers, the
fused route only.

Frozen copy of the port's ``solvers/mcica.py`` for the benchmark's plain
reference (radiation_mcica_lw.F90:39-285, radiation_mcica_sw.F90:41-410):
the stochastic cloud sample (``od_scaling`` per g-point and layer, and
``total_cloud_cover``) is an input, and both band sets run the fused
sweeps' plain torch versions (``solvers/fused.py``), the route the two
benchmark configurations take (band-contiguous g-points; LW cloud
scattering on, LW aerosol scattering off).  Any other route raises.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.solvers import fused
from benchmark.reference.solvers.adding import LwAdding, SwAdding, _stack_bot, \
    _stack_top
from benchmark.reference.solvers.outputs import LwFluxes, SwFluxes, project


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
    trailing axes (radiation_mcica_lw.F90:236-248); None for an absent
    (spectral) field."""
    if cloudy is None:
        return None
    w = w.reshape(w.shape + (1,) * (cloudy.dim() - 1))
    return w * cloudy + (1.0 - w) * clear


def solver_mcica_lw(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                    band_from_g, od_scaling, total_cloud_cover,
                    cloud_fraction, planck_hl, emission, albedo,
                    cloud_fraction_threshold=1.0e-6,
                    do_lw_cloud_scattering=True,
                    do_lw_aerosol_scattering=False,
                    do_lw_derivatives=False, spec_matrix=None) -> LwFluxes:
    """Args:
      od/ssa/g: clear-sky (gas+aerosol) (ncol, nlev, ng)
      od_cloud_b/...: in-cloud per band (ncol, nlev, nband)
      band_from_g: (ng,) 0-based integer tensor
      od_scaling: (ncol, nlev, ng); total_cloud_cover (ncol,)
      cloud_fraction: (ncol, nlev); planck_hl (ncol, nlev+1, ng)
      emission/albedo: (ncol, ng)
      spec_matrix: optional (ng, nspec) 0/1 projection for the spectral
        profiles
    """
    if (_gcounts(band_from_g) is not None and do_lw_cloud_scattering
            and not do_lw_aerosol_scattering):
        return _solver_mcica_lw_fused(
            od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, planck_hl,
            emission, albedo, cloud_fraction_threshold, do_lw_derivatives,
            spec_matrix)
    raise NotImplementedError(
        "the reference follows the fused McICA LW route only: "
        "band-contiguous g-points, LW cloud scattering on, LW aerosol "
        "scattering off")


def _finish_lw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               deriv_cloudy=None, deriv_clear=None) -> LwFluxes:
    """Blend total/clear scenes by cloud cover and pack LwFluxes
    (radiation_mcica_lw.F90:236-248), the spectral profiles (None without
    spectral flux output) the same way."""
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
        cloud_cover=w,
        flux_up_s=_mix(w, tot.up_s, clear.up_s),
        flux_dn_s=_mix(w, tot.dn_s, clear.dn_s),
        flux_up_clear_s=clear.up_s, flux_dn_clear_s=clear.dn_s)

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
    """The arguments of fused.lw_fused for solver_mcica_lw's inputs:
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
                           cloud_fraction_threshold, do_lw_derivatives,
                           spec_matrix=None) -> LwFluxes:
    """Fused-kernel LW path (solvers/fused.lw_fused), with the
    kernel's per-g planes projected through spec_matrix when given."""
    ncol = cloud_fraction.shape[0]
    r = fused.lw_fused_plain(*lw_fused_args(
        od, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g, od_scaling,
        cloud_fraction, planck_hl, emission, albedo,
        cloud_fraction_threshold, do_lw_derivatives),
        planes=spec_matrix is not None)
    proj = lambda k: project(r.get(k), spec_matrix)  # noqa: E731

    zeros = torch.zeros((ncol,), dtype=od.dtype, device=od.device)
    fup_surf_c = r["fup_surf_c"]
    clear = LwAdding(
        up=_stack_bot(r["up_bb_c"], fup_surf_c.sum(-1)),
        dn=_stack_top(zeros, r["dn_bb_c"]),
        up_toa_g=r["fup_toa_c"], dn_surf_g=r["fdn_surf_c"],
        up_surf_g=fup_surf_c, up_s=proj("up_g_c"), dn_s=proj("dn_g_c"))
    src_top_t = r["src_top_t"]
    tot = LwAdding(
        up=_stack_top(src_top_t.sum(-1), r["up_bb_t"]),
        dn=_stack_top(zeros, r["dn_bb_t"]),
        up_toa_g=src_top_t, dn_surf_g=r["fdn_surf_t"],
        up_surf_g=r["fup_surf_t"], up_s=proj("up_g_t"), dn_s=proj("dn_g_t"))

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
                    do_sw_delta_scaling_with_gases=False,
                    spec_matrix=None) -> SwFluxes:
    if _gcounts(band_from_g) is not None:
        return _solver_mcica_sw_fused(
            od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
            od_scaling, total_cloud_cover, cloud_fraction, incoming_sw,
            cos_sza, albedo_diffuse, albedo_direct,
            cloud_fraction_threshold, do_sw_delta_scaling_with_gases,
            spec_matrix)
    raise NotImplementedError(
        "the reference follows the fused McICA SW route only: "
        "band-contiguous g-points")


def _finish_sw(clear, tot, total_cloud_cover, cloud_fraction_threshold,
               cos_sza) -> SwFluxes:
    """Blend total/clear SW scenes by cloud cover, zero night columns,
    and pack SwFluxes (radiation_mcica_sw.F90 output section), the
    spectral profiles (None without spectral flux output) the same way."""
    tcc = total_cloud_cover
    has_cloud = tcc >= cloud_fraction_threshold
    day = cos_sza > 0.0
    w = torch.where(has_cloud, tcc, torch.zeros_like(tcc))

    def zn(x):
        """Zero night columns (the reference only assigns for
        cos_sza > 0, radiation_mcica_sw.F90); None stays None."""
        if x is None:
            return None
        d = day.reshape(day.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, torch.zeros_like(x))

    def total_dn(scene):
        return None if scene.up_s is None \
            else scene.dn_diffuse_s + scene.dn_direct_s

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
        cloud_cover=torch.where(day, tcc, torch.full_like(tcc, -1.0)),
        flux_up_s=zn(_mix(w, tot.up_s, clear.up_s)),
        flux_dn_s=zn(_mix(w, total_dn(tot), total_dn(clear))),
        flux_dn_direct_s=zn(_mix(w, tot.dn_direct_s, clear.dn_direct_s)),
        flux_up_clear_s=zn(clear.up_s),
        flux_dn_clear_s=zn(total_dn(clear)),
        flux_dn_direct_clear_s=zn(clear.dn_direct_s))


def sw_fused_args(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                  band_from_g, od_scaling, cloud_fraction, incoming_sw,
                  cos_sza, albedo_diffuse, albedo_direct,
                  cloud_fraction_threshold, do_sw_delta_scaling_with_gases):
    """The arguments of fused.sw_fused for solver_mcica_sw's inputs:
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
                           do_sw_delta_scaling_with_gases,
                           spec_matrix=None) -> SwFluxes:
    """Fused-kernel SW path (solvers/fused.sw_fused), with the
    kernel's per-g planes projected through spec_matrix when given (the
    direct flux's mu0 applied after the projection, as in the JAX
    package)."""
    ncol = cloud_fraction.shape[0]
    r = fused.sw_fused_plain(*sw_fused_args(
        od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        od_scaling, cloud_fraction, incoming_sw, cos_sza, albedo_diffuse,
        albedo_direct, cloud_fraction_threshold,
        do_sw_delta_scaling_with_gases), planes=spec_matrix is not None)
    proj = lambda k: project(r.get(k), spec_matrix)  # noqa: E731

    mu0_col = torch.clamp(cos_sza, min=1.0e-10)
    mu0 = mu0_col[:, None]                                 # (ncol, 1)
    dir_toa_bb = incoming_sw.sum(-1)
    zeros_bb = torch.zeros((ncol,), dtype=od.dtype, device=od.device)

    def scene(tag):
        src_top = r[f"src_top_{tag}"]
        dir_s = proj(f"dir_g_{tag}")
        return SwAdding(
            up=_stack_top(src_top.sum(-1), r[f"up_bb_{tag}"]),
            dn_diffuse=_stack_top(zeros_bb, r[f"dn_bb_{tag}"]),
            dn_direct=_stack_top(dir_toa_bb, r[f"dir_bb_{tag}"]) * mu0,
            up_toa_g=src_top,
            dn_diffuse_surf_g=r[f"fdn_surf_{tag}"],
            dn_direct_surf_g=r[f"fdir_surf_{tag}"] * mu0,
            up_s=proj(f"up_g_{tag}"), dn_diffuse_s=proj(f"dn_g_{tag}"),
            dn_direct_s=None if dir_s is None else dir_s * mu0[:, :, None])

    return _finish_sw(scene("c"), scene("t"), total_cloud_cover,
                      cloud_fraction_threshold, cos_sza)
