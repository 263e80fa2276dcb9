"""SPARTACUS solvers: 3D radiative transfer with matrix exponentials (port
of ``ecrad_tpu/solvers/spartacus.py``).

Reference: radiation_spartacus_sw.F90 (solver L41-965, step_migrations
L966-1046), radiation_spartacus_lw.F90 (solver L35-607),
radiation_lw_derivatives.F90:138-193 (calc_lw_derivatives_matrix).

Three regions per layer (clear, two cloudy) on a g axis reordered by
increasing gas optical depth.  Small matrices are in plane form
(``solvers/matrix.py``): a 3x3 region matrix is a ``(3, 3, *batch)``
tensor, a region vector ``(3, *batch)``.

Two phases, as in the JAX package:

* the per-layer region matrices R, T, ...
  (``cuda_spartacus.sw_layer_mats``, ``lw_layer_mats``): the diagonal
  two-stream everywhere, and the 3D refinement (a 9x9 block-triangular SW
  exponential, a 6x6 LW one) on the (column, layer, g-point) elements
  whose ``use_expm`` mask is set.  The JAX package maps the layer-matrix
  build over single levels and skips inactive levels with ``lax.cond``.
  On the card two CUDA kernels a band set build every element's matrices,
  the refined ones by one thread each (``csrc/spartacus_layer_mats.cu``),
  from the band set's raw optics: each element's region optics, the LW
  side emissivity and the clear-sky coefficients the sweeps read are made
  there too, so no per-element plane is built in torch before the sweeps;
  on the CPU their plain versions (``_sw_layer_mats``, ``_lw_layer_mats``)
  gather the active elements into a flat batch and run the refinement over
  chunks of ``_REFINE_CHUNK`` of them.  The arithmetic of each element is
  the JAX package's, so the two agree to roundoff in float64; the LW
  refinement runs in float64 in a float32 run too (see
  ``_lw_layer_mats``);
* the up and down adding sweeps (``solvers/cuda_spartacus.py``): a CUDA
  kernel on the card, the step cores below in a level loop on the CPU.
  The inputs travel in the layout of ``ecrad_tpu/solvers/
  pallas_spartacus.py`` (layer matrices ``(nlev, 9, ncol, ng)``,
  per-column data ``(nlev, ncol, K)``).

The sweeps already return per-g half-level profiles; spectral flux
output projects them (``outputs.lw_from_g_profiles`` and
``sw_from_g_profiles`` with a ``spec_matrix``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ecrad_torch import profiling
from ecrad_torch.config import Config, Entrapment, PdfShape
from ecrad_torch.solvers import cuda_spartacus, two_stream
from ecrad_torch.solvers.cuda_tripleclouds import merge_regions
from ecrad_torch.solvers.matrix import (pl_expm, pl_expm_blockut,
                                        pl_fast_expm_exchange_3, pl_matmul,
                                        pl_matvec, pl_solve_mat,
                                        pl_solve_vec)
from ecrad_torch.solvers.outputs import (LwFluxes, SwFluxes,
                                         lw_from_g_profiles,
                                         sw_from_g_profiles)
from ecrad_torch.solvers.tripleclouds import (calc_overlap_matrices,
                                              calc_region_properties)

# radiation_constants.F90:30-33
R_OVER_G = 287.058 / 9.80665
FOUR_OVER_PI = 4.0 / np.pi
TAN_DIFFUSE_ANGLE_3D = np.pi * 0.5          # radiation_spartacus_sw.F90:94
MIN_MU0_3D = 0.004625
SIDE_EMISS_THIN = 1.4107                    # radiation_spartacus_lw.F90:130
LW_DIFFUSIVITY = 1.66
NREG = 3
_EPS = float(np.finfo(np.float64).eps)
# The spans of the solvers' stages, inside ``ecrad.solvers`` with
# ``ecrad.solvers.regions`` (``_prep``): the exponential mask, the layer-
# matrix build (the kernels' launch set on the card, the plain build on the
# CPU) and the sweeps, one open a band set each; the rest of the sweep
# arguments, two opens a band set (before and after the layer matrices);
# the LW derivatives, one a block; the flux profiles from the sweeps'
# outputs, one a band set.  None opens inside a level loop.
MASK = "ecrad.solvers.mask"
SWEEP_INPUTS = "ecrad.solvers.sweep_inputs"
LAYER_MATS = "ecrad.solvers.layer_mats"
SWEEPS = "ecrad.solvers.sweeps"
LW_DERIVATIVES = "ecrad.solvers.lw_derivatives"
ASSEMBLE = "ecrad.solvers.assemble"
# 3D-active elements per refinement chunk of the plain build: the SW
# exponential keeps a few hundred planes of this length alive, a few GB
_REFINE_CHUNK = 1 << 21


# ---------------------------------------------------------------------------
# Plane-form plumbing: matrices (3, 3, *batch), vectors (3, *batch); stacked
# forms carry k = 3*i + j on one axis of length 9.

def _m3(x9):
    """(9, ...) stacked -> (3, 3, ...)."""
    return x9.reshape((NREG, NREG) + tuple(x9.shape[1:]))


def _eye3(like):
    eye = torch.eye(NREG, dtype=like.dtype, device=like.device)
    return eye.reshape((NREG, NREG) + (1,) * (like.dim() - 2))


def _diag(A):
    """(3, *batch): the diagonal of a plane matrix."""
    return torch.stack([A[r, r] for r in range(NREG)])


def _diag_embed(d):
    """Plane matrix with diagonal d (3, *batch), zeros elsewhere."""
    out = d.new_zeros((NREG,) + tuple(d.shape))
    for r in range(NREG):
        out[r, r] = d[r]
    return out


def _embed00(x, like):
    """Plane matrix shaped like ``like`` with only [0][0] = x."""
    out = torch.zeros_like(like)
    out[0, 0] = x
    return out


def _embed0(x, like):
    out = torch.zeros_like(like)
    out[0] = x
    return out


def _vmix(x, v):
    """out[i] = sum_j x[j] v[j][i], summed in j order."""
    return x[0] * v[0] + x[1] * v[1] + x[2] * v[2]


def _rsum(x):
    """Sum of a region vector over regions, in region order."""
    return x[0] + x[1] + x[2]


def _transfer_rates(reg_fracs, edge_length, dz, tan_angle, max_rate):
    """Transfer rates between regions (radiation_spartacus_sw.F90:259-296).

    reg_fracs/edge_length (..., 3), dz (...), tan_angle broadcastable.
    Returns (..., 3, 3) clamped at max_3d_transfer_rate."""
    f = reg_fracs

    def rate(el, fr):
        return torch.where(fr > _EPS, dz * el * tan_angle
                           / torch.clamp(fr, min=_EPS),
                           torch.zeros_like(fr))

    z = torch.zeros_like(f[..., 0])
    row0 = torch.stack([z, rate(edge_length[..., 0], f[..., 0]),
                        rate(edge_length[..., 2], f[..., 0])], -1)
    row1 = torch.stack([rate(edge_length[..., 0], f[..., 1]), z,
                        rate(edge_length[..., 1], f[..., 1])], -1)
    row2 = torch.stack([rate(edge_length[..., 2], f[..., 2]),
                        rate(edge_length[..., 1], f[..., 2]), z], -1)
    return torch.clamp(torch.stack([row0, row1, row2], -2), max=max_rate)


def _prep(config: Config, cloud_fraction, fractional_std, overlap_param,
          pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size):
    """Shared SPARTACUS geometry prep (radiation_spartacus_sw.F90:110-296);
    the region fractions and overlap matrices in the span
    ``ecrad.solvers.regions``."""
    with profiling.scope("ecrad.solvers.regions"):
        reg_fracs, od_scaling = calc_region_properties(
            cloud_fraction, fractional_std,
            config.cloud_pdf_shape == PdfShape.GAMMA,
            config.cloud_fraction_threshold, n_regions=config.nregions)
        u_mat, v_mat, cloud_cover = calc_overlap_matrices(
            reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
            config.cloud_fraction_threshold)
    clear_layer = cloud_fraction <= 0.0

    phl, thl = pressure_hl, temperature_hl
    layer_depth = R_OVER_G * (phl[:, 1:] - phl[:, :-1]) \
        * (thl[:, :-1] + thl[:, 1:]) / (phl[:, :-1] + phl[:, 1:])

    max_inv_size = 1.0 / config.min_cloud_effective_size
    inv_size = torch.clamp(inv_cloud_size, max=max_inv_size)
    if inv_inhom_size is None:
        inv_inhom = inv_size
    else:
        inv_inhom = torch.clamp(inv_inhom_size, max=max_inv_size)

    active_3d = (bool(config.do_3d_effects) & ~clear_layer
                 & (inv_cloud_size > 0.0))
    f0 = reg_fracs[..., 0]
    f2 = reg_fracs[..., 2]
    el0 = FOUR_OVER_PI * f0 * (1.0 - f0) * inv_size
    el1 = FOUR_OVER_PI * f2 * (1.0 - f2) * inv_inhom
    if config.clear_to_thick_fraction > 0.0:
        el2 = config.clear_to_thick_fraction * torch.minimum(el0, el1)
        el0 = el0 - el2
        el1 = el1 - el2
    else:
        el2 = torch.zeros_like(el0)
    edge_length = torch.where(active_3d[..., None],
                              torch.stack([el0, el1, el2], -1), 0.0)

    return dict(reg_fracs=reg_fracs, od_scaling=od_scaling, u_mat=u_mat,
                v_mat=v_mat, cloud_cover=cloud_cover,
                clear_layer=clear_layer, layer_depth=layer_depth,
                edge_length=edge_length, active_3d=active_3d,
                inv_size=inv_size)


def _region_optics(max_cloud_od, od, ssa, g, od_cloud_b, ssa_cloud_b,
                   g_cloud_b, band_from_g, od_scaling):
    """Per-region od/ssa/g, region axis last: (ncol, nlev, ng, 3).

    Follows radiation_spartacus_sw.F90:297-320: ssa/g from unclamped od,
    then od clamped at max_cloud_od."""
    od_c, ssa_c, g_c = merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                     g_cloud_b, band_from_g, od_scaling)
    od_c = torch.clamp(od_c.movedim(-2, -1), max=max_cloud_od)
    od3 = torch.cat([od[..., None], od_c], -1)
    ssa3 = torch.cat([ssa[..., None], ssa_c.movedim(-2, -1)], -1)
    g3 = torch.cat([g[..., None], g_c.movedim(-2, -1)], -1)
    return od3, ssa3, g3


def _side_emissivity(aspect, od3, ssa3, g3):
    """LW side emissivity (radiation_spartacus_lw.F90:289-310) of elements
    with region axis last, od3/ssa3/g3 (..., 3), from the cloud aspect
    ratio of each element's (column, layer), aspect (...): 0 where the side
    emissivity is 1 (no cloud of both kinds, or no cloud size).  In the
    working type; the refine pass of csrc/spartacus_layer_mats.cu computes
    it op for op."""
    lateral_od = (aspect / (NREG - 1.0)) * (od3[..., 1] * (1.0 - ssa3[..., 1])
                                            + od3[..., 2] * (1.0 - ssa3[..., 2]))
    sq1 = torch.sqrt(torch.clamp(1.0 - ssa3[..., 1], min=0.0))
    thick = 2.0 * sq1 / (sq1 + torch.sqrt(
        torch.clamp(1.0 - ssa3[..., 1] * g3[..., 1], min=0.0)))
    side = (SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
    return torch.where(aspect > 0.0, side, 1.0)


def _use_expm_mask(config: Config, od_gas, active_3d):
    """Per-g exponential mask, the ng3D prefix rule
    (radiation_spartacus_sw.F90:208-216, 326-330): the g-points before
    the first whose (reordered) clear-sky od exceeds max_gas_od_3d, in
    3D-active layers (every layer with use_expm_everywhere).  Returns
    bool (ncol, nlev, ng).  The prefix ends at the first exceeding g-point
    (argmax returns the first of equal maxima), found by a reduction over
    g: on the card a scan over g, cumsum, took ~7 times as long."""
    exceeds = od_gas > config.max_gas_od_3d
    ng = exceeds.shape[-1]
    first = torch.where(exceeds.any(-1),
                        exceeds.to(torch.uint8).argmax(-1), ng)
    prefix = torch.arange(ng, device=od_gas.device) < first[..., None]
    if config.use_expm_everywhere:
        return prefix
    return prefix & active_3d[..., None]


class SwOpts(NamedTuple):
    """Static SW sweep options (the kernels' switches)."""
    mode: Entrapment
    do_3d: bool
    overhang_factor: float
    cloud_fraction_threshold: float
    max_cloud_od: float


class LwOpts(NamedTuple):
    multilayer: bool


# ---------------------------------------------------------------------------
# Step cores: the math of one level of each sweep, shared by the plain
# sweeps (cuda_spartacus.*_plain) and mirrored by the CUDA kernels.  All
# per-column inputs arrive broadcast-ready: (9|3, ncol, 1) stacks and
# (ncol, 1) planes.


def _sw_up_core(carry, mats, cl5, u9b, v9b, msk, ent, opts: SwOpts):
    """One SW upward adding step (radiation_spartacus_sw.F90:444-777).

    carry: (alb (3,3,..), albd (3,3,..), alb_c, albd_c, xdif (3,..),
    xdir (3,..)); mats: (R, T, Rd, Tdd, Tdir) plane matrices; cl5: clear-sky
    (rcl, tcl, rdcl, tddcl, tdircl) planes; u9b/v9b (9, ...) overlap
    matrices at the interface above the layer; msk: (clr, clr_above,
    migrate, not_top) bool planes; ent: (rf3 (3,..), elp3, rfp3, invszp,
    opp, xld, xldir).  Returns the new carry."""
    alb, albd, alb_c, albd_c, xdif, xdir = carry
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = cl5
    cm, above_clear, mm, ntop = msk
    rf3, elp3, rfp3, invszp, opp, xld, xldir = ent
    mode = opts.mode
    explicit = mode in (Entrapment.EXPLICIT, Entrapment.EXPLICIT_NON_FRACTAL)
    u, v = _m3(u9b), _m3(v9b)

    # clear-sky scalar adding (radiation_spartacus_sw.F90:444-456)
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    albd_c_new = rdcl + (tdircl * albd_c + tddcl * alb_c) * tcl * inv_d

    # layer adding: full matrix (radiation_spartacus_sw.F90:474-494)
    denom = _eye3(R) - pl_matmul(alb, R)
    X = R + pl_matmul(T, pl_solve_mat(denom, pl_matmul(alb, T)))
    srcm = pl_matmul(albd, Tdir) + pl_matmul(alb, Tdd)
    Xd = Rd + pl_matmul(T, pl_solve_mat(denom, srcm))
    # clear-layer scalar version (L458-473), region (0,0) only
    a00, ad00 = alb[0, 0], albd[0, 0]
    R00, T00 = R[0, 0], T[0, 0]
    inv_s = 1.0 / (1.0 - a00 * R00)
    s00 = R00 + T00 * T00 * a00 * inv_s
    sd00 = Rd[0, 0] + (Tdir[0, 0] * ad00 + Tdd[0, 0] * a00) * T00 * inv_s
    X = torch.where(cm, _embed00(s00, X), X)
    Xd = torch.where(cm, _embed00(sd00, Xd), Xd)

    # step_migrations (radiation_spartacus_sw.F90:966-1046), all regions
    if explicit:
        cf = 1.0 - rf3[0]
        act = torch.stack([cf < 1.0, cf > 0.0, cf > 0.0])
        Rdg, Tdg, Rddg, Tddg, Tdirg = (_diag(M) for M in (R, T, Rd, Tdd,
                                                         Tdir))
        Adg, Addg = _diag(alb), _diag(albd)
        ms = Tdg / (1.0 - Rdg * Adg)
        xe = (1.0 - Rdg * Adg) ** (-1.5)
        top_alb_dir = torch.clamp(
            Rddg + ms * (Tddg * Adg + Tdirg * Addg), min=1.0e-8)
        xdir_new = torch.clamp(xldir + (
            (Tddg * Adg * xe + Tdirg * Addg * (xe - 1.0))
            * (xdif + xld)
            + Tdirg * Addg * (xdir + xldir))
            * Tdg / top_alb_dir, min=0.0)
        top_alb = torch.clamp(Rdg + ms * Tdg * Adg, min=1.0e-8)
        xdif_new = xld + xe * Adg * Tdg * Tdg * (xdif + xld) / top_alb
        xdir_new = torch.where(act, xdir_new, 0.0)
        xdif_new = torch.where(act, xdif_new, 0.0)
        xdif = torch.where(mm, xdif_new, xdif)
        xdir = torch.where(mm, xdir_new, xdir)

    # overlap / entrapment mixing (radiation_spartacus_sw.F90:510-760)
    def full(A):
        return pl_matmul(pl_matmul(u, A), v)

    fX, fXd = full(X), full(Xd)
    both_clear = cm & above_clear

    if mode == Entrapment.MAXIMUM:
        alb_new, albd_new = fX, fXd
    elif mode == Entrapment.ZERO:
        def zero_mix(A):
            return _diag_embed(_vmix(A[0] + A[1] + A[2], v))
        alb_new = torch.where(above_clear, fX, zero_mix(X))
        albd_new = torch.where(above_clear, fXd, zero_mix(Xd))
    else:
        on_diag = _eye3(X) != 0.0

        def offd(A):
            return torch.where(on_diag, 0.0, A)

        base, based = full(offd(X)), full(offd(Xd))
        if mode == Entrapment.EDGE_ONLY or not opts.do_3d:
            def dmix(A):
                return _diag_embed(_vmix(_diag(A), v))
            alb_new = base + dmix(X)
            albd_new = based + dmix(Xd)
        else:
            # Explicit entrapment (radiation_spartacus_sw.F90:586-760)
            acc = torch.zeros_like(X)
            accd = torch.zeros_like(Xd)
            for j2 in range(NREG):
                ts = 1.0 - (1.0 - opts.overhang_factor) * opp \
                    * torch.minimum(rf3[j2], rfp3[j2]) \
                    / torch.clamp(rf3[j2],
                                  min=opts.cloud_fraction_threshold)
                ts = torch.where(ntop, ts, 0.0)

                def trd_entry(el_e, iup):
                    return ts * el_e \
                        / torch.clamp(u9b[NREG * iup + j2], min=1.0e-5)
                tr01 = trd_entry(elp3[0], 0)
                tr10 = trd_entry(elp3[0], 1)
                tr12 = trd_entry(elp3[1], 1)
                tr21 = trd_entry(elp3[1], 2)

                def entrap(xmig):
                    xj = xmig[j2]
                    if mode == Entrapment.EXPLICIT:
                        ff = 1.0 / torch.sqrt(torch.clamp(
                            2.5 * xj * invszp, min=1.0))
                    else:
                        ff = 1.0
                    e10 = tr01 * xj * ff
                    e01 = tr10 * xj * ff
                    e21 = tr12 * xj * ff
                    e12 = tr21 * xj * ff
                    max_entr = -torch.minimum(-e10, -e01 - e21)
                    scale = torch.where(
                        max_entr > opts.max_cloud_od,
                        opts.max_cloud_od / torch.clamp(max_entr, min=1e-300),
                        1.0)
                    return (e10 * scale, e01 * scale, e21 * scale,
                            e12 * scale)

                Pm = pl_fast_expm_exchange_3(*entrap(xdif))
                Pmd = pl_fast_expm_exchange_3(*entrap(xdir))
                vrow = v[j2][None]
                acc = acc + Pm * vrow * X[j2, j2]
                accd = accd + Pmd * vrow * Xd[j2, j2]
            alb_new = base + acc
            albd_new = based + accd
        alb_new = torch.where(above_clear, fX, alb_new)
        albd_new = torch.where(above_clear, fXd, albd_new)
    alb_new = torch.where(both_clear, _embed00(X[0, 0], X), alb_new)
    albd_new = torch.where(both_clear, _embed00(Xd[0, 0], Xd), albd_new)

    # migrate x through the interface (radiation_spartacus_sw.F90:758-777)
    if explicit:
        active_j2 = torch.stack([torch.ones_like(cm), ~cm, ~cm])
        nskip = ~both_clear
        xdif = torch.where(nskip, _vmix(torch.where(active_j2, xdif, 0.0),
                                        v), xdif)
        xdir = torch.where(nskip, _vmix(torch.where(active_j2, xdir, 0.0),
                                        v), xdir)

    return (alb_new, albd_new, alb_c_new, albd_c_new, xdif, xdir)


def _sw_dn_core(carry, mats, cl5, below, v9b, msk):
    """One SW downward step (radiation_spartacus_sw.F90:779-957).

    carry: (fdn (3,..), ddn (3,..), fdn_c, ddn_c); below: (alb_n, albd_n,
    alb_cn, albd_cn), the albedos below the layer; v9b (9, ...) of the
    interface below; msk: (clr, clr_below).  Returns (new carry, (fup_sum,
    fdn_sum, ddn_sum, fup_c, fdn_c2, ddn_c2)) at the layer base."""
    fdn, ddn, fdn_c, ddn_c = carry
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = cl5
    alb_n, albd_n, alb_cn, albd_cn = below
    cm, clr_below = msk
    src = pl_matvec(Tdd, ddn)
    ddn_above = pl_matvec(Tdir, ddn)
    # clear-sky scalars
    src_c = tddcl * ddn_c
    ddn_c2 = tdircl * ddn_c
    fdn_c2 = (tcl * fdn_c + rcl * albd_cn * ddn_c2 + src_c) \
        / (1.0 - rcl * alb_cn)
    fup_c = albd_cn * ddn_c2 + alb_cn * fdn_c2
    # matrix branch
    denom = _eye3(R) - pl_matmul(R, alb_n)
    tsrc = pl_matvec(albd_n, ddn_above)
    rhs = pl_matvec(T, fdn) + pl_matvec(R, tsrc) + src
    fdn_above = pl_solve_vec(denom, rhs)
    fup_above = pl_matvec(alb_n, fdn_above) + tsrc
    # clear-layer scalar branch, region 0
    f0 = (T[0, 0] * fdn[0] + R[0, 0] * albd_n[0, 0] * ddn_above[0]
          + src[0]) / (1.0 - R[0, 0] * alb_n[0, 0])
    u0 = albd_n[0, 0] * ddn_above[0] + alb_n[0, 0] * f0
    fdn_above = torch.where(cm, _embed0(f0, fdn_above), fdn_above)
    fup_above = torch.where(cm, _embed0(u0, fup_above), fup_above)
    # through the interface below
    skip = cm & clr_below
    v = _m3(v9b)
    fdn_next = torch.where(skip, fdn_above, pl_matvec(v, fdn_above))
    ddn_next = torch.where(skip, ddn_above, pl_matvec(v, ddn_above))
    return (fdn_next, ddn_next, fdn_c2, ddn_c2), \
        (_rsum(fup_above), _rsum(fdn_above), _rsum(ddn_above), fup_c,
         fdn_c2, ddn_c2)


def _lw_up_core(carry, mats, cl4, u9b, v9b, msk, opts: LwOpts):
    """One LW upward step (radiation_spartacus_lw.F90:425-508).

    carry: (alb (3,3,..), src (3,..), alb_c, src_c); mats: (R, T, SU, SD);
    cl4 = (rcl, tcl, sucl, sdcl).  Returns the new carry."""
    alb, src, alb_c, src_c = carry
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = cl4
    cm, above_clear = msk
    u, v = _m3(u9b), _m3(v9b)
    # clear-sky scalar (radiation_spartacus_lw.F90:425-437)
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    src_c_new = sucl + tcl * (src_c + alb_c * sdcl) * inv_d
    # matrix branch (L452-467)
    denom = _eye3(R) - pl_matmul(alb, R)
    X = R + pl_matmul(T, pl_solve_mat(denom, pl_matmul(alb, T)))
    rhs = src + pl_matvec(alb, SD)
    S = SU + pl_matvec(T, pl_solve_vec(denom, rhs))
    # clear-layer scalar branch (L438-451), region 0
    a00 = alb[0, 0]
    inv_s = 1.0 / (1.0 - a00 * R[0, 0])
    x00 = R[0, 0] + T[0, 0] * T[0, 0] * a00 * inv_s
    s0 = SU[0] + T[0, 0] * (src[0] + a00 * SD[0]) * inv_s
    X = torch.where(cm, _embed00(x00, X), X)
    S = torch.where(cm, _embed0(s0, S), S)
    # mixing (L485-508)
    both_clear = cm & above_clear
    src_new = torch.where(both_clear, _embed0(S[0], S), pl_matvec(u, S))
    if opts.multilayer:
        mixed = pl_matmul(pl_matmul(u, X), v)
    else:
        mixed = _diag_embed(_vmix(_diag(X), v))
    alb_new = torch.where(both_clear, _embed00(X[0, 0], X), mixed)
    return (alb_new, src_new, alb_c_new, src_c_new)


def _lw_dn_core(carry, mats, cl4, below, v9b, msk):
    """One LW downward step (radiation_spartacus_lw.F90:509-595).

    carry: (fdn (3,..), fdn_c); below: (src_n (3,..), alb_n (3,3,..),
    src_cn, alb_cn).  Returns (new carry, (fup_sum, fdn_sum, fup_c,
    fdn_c2))."""
    fdn, fdn_c = carry
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = cl4
    src_n, alb_n, src_cn, alb_cn = below
    cm, clr_below = msk
    fdn_c2 = (tcl * fdn_c + rcl * src_cn + sdcl) / (1.0 - rcl * alb_cn)
    fup_c = src_cn + alb_cn * fdn_c2
    denom = _eye3(R) - pl_matmul(R, alb_n)
    rhs = pl_matvec(T, fdn) + pl_matvec(R, src_n) + SD
    fdn_above = pl_solve_vec(denom, rhs)
    fup_above = pl_matvec(alb_n, fdn_above) + src_n
    f0 = (T[0, 0] * fdn[0] + R[0, 0] * src_n[0] + SD[0]) \
        / (1.0 - R[0, 0] * alb_n[0, 0])
    u0 = src_n[0] + alb_n[0, 0] * f0
    fdn_above = torch.where(cm, _embed0(f0, fdn_above), fdn_above)
    fup_above = torch.where(cm, _embed0(u0, fup_above), fup_above)
    skip = cm & clr_below
    fdn_next = torch.where(skip, fdn_above,
                           pl_matvec(_m3(v9b), fdn_above))
    return (fdn_next, fdn_c2), \
        (_rsum(fup_above), _rsum(fdn_above), fup_c, fdn_c2)


# ---------------------------------------------------------------------------
# Layer matrices


def _exchange(t):
    """Exchange matrix of transfer rates t (3, 3, N): X[i][i] = sum_k
    t[i][k], X[i][j] = -t[j][i]."""
    X = -t.transpose(0, 1)
    for i in range(NREG):
        X[i, i] = t[i, 0] + t[i, 1] + t[i, 2]
    return X


def _active_chunks(use_expm):
    """(col, lev, g) index triples of the elements to refine, in chunks."""
    idx = use_expm.nonzero(as_tuple=True)
    for s in range(0, idx[0].numel(), _REFINE_CHUNK):
        yield tuple(i[s:s + _REFINE_CHUNK] for i in idx)


def _sw_refine(odr, ssar, gr, mu0p, inv_mu0p, trd, trdir):
    """The 3D SW layer matrices of a flat batch of elements
    (radiation_spartacus_sw.F90:327-430): odr/ssar/gr (3, N), mu0p and
    inv_mu0p (N,), transfer rates (3, 3, N).  Returns (R, T, Rd, Tdd,
    Tdir), each (3, 3, N)."""
    g1, g2, g3 = two_stream.sw_gammas(mu0p, ssar, gr)
    Xd, Xdir = _exchange(trd), _exchange(trdir)
    n = odr.shape[-1]
    # diffuse 6x6 block, direct 3x3 block, 6x3 coupling; the lower-left
    # 3x6 is structurally zero (matrix.pl_expm_blockut)
    A11 = odr.new_zeros((2 * NREG, 2 * NREG, n))
    A13 = odr.new_zeros((2 * NREG, NREG, n))
    D = Xd.clone()
    A33 = -Xdir
    for i in range(NREG):
        D[i, i] = odr[i] * g1[i] + Xd[i, i]
        A33[i, i] = -Xdir[i, i] + -odr[i] * inv_mu0p
    A11[:NREG, :NREG] = D
    A11[NREG:, NREG:] = -D
    for i in range(NREG):
        A11[i, NREG + i] = -odr[i] * g2[i]
        A11[NREG + i, i] = odr[i] * g2[i]
        A13[i, i] = -odr[i] * ssar[i] * g3[i]
        A13[NREG + i, i] = odr[i] * ssar[i] * (1.0 - g3[i])
    Eb11, Eb13, Eb33 = pl_expm_blockut(A11, A13, A33)
    E11, E12 = Eb11[:NREG, :NREG], Eb11[:NREG, NREG:]
    E21, E22 = Eb11[NREG:, :NREG], Eb11[NREG:, NREG:]
    E13, E23 = Eb13[:NREG], Eb13[NREG:]
    tdir_e = torch.clamp(Eb33, 0.0, 1.0)
    refl_e = torch.clamp(-pl_solve_mat(E11, E12), 0.0, 1.0)
    trans_e = torch.clamp(pl_matmul(E21, refl_e) + E22, 0.0, 1.0)
    rdir_e = torch.minimum(torch.clamp(-pl_solve_mat(E11, E13), min=0.0),
                           mu0p)
    tdd_e = torch.minimum(torch.clamp(pl_matmul(E21, rdir_e) + E23,
                                      min=0.0), mu0p)
    return refl_e, trans_e, rdir_e, tdd_e, tdir_e


def _sw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                   band_from_g, od_scaling, max_cloud_od, mu0, tr_diff,
                   tr_dir, use_expm, clear_layer, any_expm):
    """SW region matrices (R, T, Rd, Tdd, Tdir), each (nlev, 9, ncol, ng),
    from a band set's raw optics (the region optics of _region_optics): the
    diagonal two-stream everywhere, the exponential where use_expm, and in
    clear layers only the [0][0] entry (a select, never a 0/1 multiply: a
    degenerate exponential may leave NaN there); and the clear-sky planes
    cl5, sw_ref_trans of the gas, (nlev, ncol, ng) each.  Returns (R, T,
    Rd, Tdd, Tdir, cl5).  The plain version of cuda_spartacus.sw_layer_mats,
    and its CPU route."""
    od3, ssa3, g3 = _region_optics(max_cloud_od, od, ssa, g, od_cloud_b,
                                   ssa_cloud_b, g_cloud_b, band_from_g,
                                   od_scaling)
    ncol, nlev, ng, _ = od3.shape
    mats = [od3.new_zeros((nlev, NREG * NREG, ncol, ng)) for _ in range(5)]
    mu0p = mu0[:, None, None]
    for r in range(NREG):
        coefs = two_stream.sw_ref_trans(mu0p, od3[..., r], ssa3[..., r],
                                        g3[..., r])
        for M, c in zip(mats, coefs):
            M[:, 4 * r] = c.transpose(0, 1)
    if any_expm:
        inv_mu0 = 1.0 / mu0
        for c, l, k in _active_chunks(use_expm):
            res = _sw_refine(od3[c, l, k].T, ssa3[c, l, k].T,
                             g3[c, l, k].T, mu0[c], inv_mu0[c],
                             tr_diff[c, l].permute(1, 2, 0),
                             tr_dir[c, l].permute(1, 2, 0))
            for M, x in zip(mats, res):
                M[l, :, c, k] = x.reshape(NREG * NREG, -1).T
    clr = clear_layer.T[:, None, :, None]
    for M in mats:
        M[:, 1:] = torch.where(clr, 0.0, M[:, 1:])
    cl5 = tuple(_lev(x) for x in two_stream.sw_ref_trans(mu0p, od, ssa, g))
    return (*mats, cl5)


def _lw_refine(odr, ssar, gr, trl, sidel, rfr, plt, plb):
    """The 3D LW layer matrices and sources of a flat batch of elements
    (radiation_spartacus_lw.F90:311-424): odr/ssar/gr/rfr (3, N), trl
    (3, 3, N), sidel/plt/plb (N,).  Returns (R, T) (3, 3, N) and (SU, SD)
    (3, N)."""
    g1, g2 = two_stream.lw_gammas(ssar, gr)
    trs = trl.clone()
    trs[1, 0] = trs[1, 0] * sidel
    trs[2, 0] = trs[2, 0] * sidel
    D = -trs.transpose(0, 1)
    for i in range(NREG):
        D[i, i] = odr[i] * g1[i] + (trs[i, 0] + trs[i, 1] + trs[i, 2])
    G2d = odr * g2
    n = odr.shape[-1]
    G = odr.new_zeros((2 * NREG, 2 * NREG, n))
    G[:NREG, :NREG] = D
    G[NREG:, NREG:] = -D
    for i in range(NREG):
        G[i, NREG + i] = -G2d[i]
        G[NREG + i, i] = G2d[i]
    emis = odr * (1.0 - ssar) * rfr * LW_DIFFUSIVITY
    dpl = plb - plt
    pt = torch.cat([-emis * plt, emis * plt])
    pd = torch.cat([-emis * dpl, emis * dpl])
    sol_d = -pl_solve_vec(G, pd)
    sol0 = pl_solve_vec(G, sol_d - pt)
    # the LW 6x6 norm is bounded by ~2*max_cloud_od*gamma1 +
    # 4*max_3d_transfer_rate*side_emiss ~ 120 << 2^6 * theta3 = 251
    E = pl_expm(G, max_squarings=6)
    E11, E12 = E[:NREG, :NREG], E[:NREG, NREG:]
    E21, E22 = E[NREG:, :NREG], E[NREG:, NREG:]
    R_e = -pl_solve_mat(E11, E12)
    T_e = pl_matmul(E21, R_e) + E22
    tmp = sol0[:NREG] + sol_d[:NREG] - pl_matvec(E12, sol0[NREG:])
    su_e = sol0[:NREG] - pl_solve_vec(E11, tmp)
    sd_e = pl_matvec(E21, su_e - sol0[:NREG]) + sol0[NREG:] \
        - pl_matvec(E22, sol0[NREG:]) + sol_d[NREG:]
    return R_e, T_e, su_e, sd_e


def _lw_layer_mats(od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b,
                   band_from_g, od_scaling, max_cloud_od, tr, aspect,
                   reg_fracs, clear_layer, pl_top, pl_bot, use_expm,
                   any_expm):
    """LW region matrices R, T (nlev, 9, ncol, ng) and sources SU, SD
    (nlev, 3, ncol, ng), sources scaled by region fraction, from a band
    set's raw optics (ssa and g None for an absorbing gas); clear layers
    keep only the region-0 entries (selects, as in the SW); and the
    clear-sky planes cl4, lw_ref_trans of the gas with the unscaled Planck
    terms, (nlev, ncol, ng) each.  The refined elements' side emissivity
    comes from aspect (_side_emissivity).  Returns (R, T, SU, SD, cl4).
    The plain version of cuda_spartacus.lw_layer_mats, and its CPU
    route."""
    if ssa is None:
        ssa = g = torch.zeros_like(od)
    od3, ssa3, g3 = _region_optics(max_cloud_od, od, ssa, g, od_cloud_b,
                                   ssa_cloud_b, g_cloud_b, band_from_g,
                                   od_scaling)
    ncol, nlev, ng, _ = od3.shape
    R9 = od3.new_zeros((nlev, NREG * NREG, ncol, ng))
    T9 = torch.zeros_like(R9)
    SU = od3.new_zeros((nlev, NREG, ncol, ng))
    SD = torch.zeros_like(SU)
    for r in range(NREG):
        rfr = reg_fracs[..., r, None]
        coefs = two_stream.lw_ref_trans(od3[..., r], ssa3[..., r],
                                        g3[..., r], rfr * pl_top,
                                        rfr * pl_bot)
        for M, k, c in zip((R9, T9, SU, SD), (4 * r, 4 * r, r, r), coefs):
            M[:, k] = c.transpose(0, 1)
    if any_expm:
        # in float64 whatever the working type: in float32 the sources
        # (two solves with the 6x6 generator, which is near singular in
        # thin regions) lose so much that the JAX package's float32 run of
        # spartacus_3d on the CPU is 8 W m-2 from its float64 run in lw_dn
        for c, l, k in _active_chunks(use_expm):
            o3, s3, g3k = od3[c, l, k], ssa3[c, l, k], g3[c, l, k]
            side = _side_emissivity(aspect[c, l], o3, s3, g3k)
            res = _lw_refine(*(x.double() for x in (
                o3.T, s3.T, g3k.T, tr[c, l].permute(1, 2, 0), side,
                reg_fracs[c, l].T, pl_top[c, l, k], pl_bot[c, l, k])))
            for M, x in zip((R9, T9, SU, SD), res):
                M[l, :, c, k] = x.reshape(-1, x.shape[-1]).T.to(M.dtype)
    clr = clear_layer.T[:, None, :, None]
    for M in (R9, T9, SU, SD):
        M[:, 1:] = torch.where(clr, 0.0, M[:, 1:])
    cl4 = tuple(_lev(x) for x in two_stream.lw_ref_trans(od, ssa, g, pl_top,
                                                        pl_bot))
    return R9, T9, SU, SD, cl4


# ---------------------------------------------------------------------------
# Sweep inputs in the kernels' layout


def _per_level(ncol, nlev, dtype, *fields):
    """(ncol, nlev)-broadcastable fields -> (nlev, ncol, K) stack."""
    return torch.stack([torch.broadcast_to(f, (ncol, nlev)).to(dtype)
                        for f in fields], -1).transpose(0, 1).contiguous()


def _iface9(m, ncol, nlev):
    """(ncol, nlev, 3, 3) interface matrices -> (nlev, ncol, 9)."""
    return m.reshape(ncol, nlev, 9).transpose(0, 1).contiguous()


def _lev(a):
    """(ncol, nlev, ...) -> contiguous (nlev, ncol, ...)."""
    return a.transpose(0, 1).contiguous()


def _diag9(d, ncol, ng):
    """(9, ncol, ng) stacked matrix with d broadcast on the diagonal."""
    out = d.new_zeros((NREG * NREG, ncol, ng))
    for r in range(NREG):
        out[4 * r] = d
    return out


def sw_sweep_args(config: Config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                  g_cloud_b, band_from_g, cloud_fraction, fractional_std,
                  overlap_param, inv_cloud_size, inv_inhom_size,
                  pressure_hl, temperature_hl, incoming_sw, cos_sza,
                  albedo_diffuse, albedo_direct):
    """The arguments of cuda_spartacus.sw_sweeps for solver_spartacus_sw's
    inputs, and the prep dict (with ``ddn0``)."""
    ncol, nlev, ng = od.shape
    dtype = od.dtype
    P = _prep(config, cloud_fraction, fractional_std, overlap_param,
              pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    with profiling.scope(MASK):
        use_expm = _use_expm_mask(config, od, P["active_3d"])
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer, edge_length = P["clear_layer"], P["edge_length"]

    with profiling.scope(SWEEP_INPUTS):
        # Night columns are masked at the end (the reference cycles them);
        # mu0 = 1 there keeps the 1/mu0 Gamma entries small
        day_mask = cos_sza >= 1.0e-10
        mu0 = torch.where(day_mask, torch.clamp(cos_sza, min=1.0e-10), 1.0)
        one_over_mu0 = 1.0 / mu0
        # radiation_spartacus_sw.F90:168-176
        tan_sza = torch.where(
            mu0 < MIN_MU0_3D, math.sqrt(1.0 / MIN_MU0_3D ** 2 - 1.0),
            torch.where(one_over_mu0 > 1.0,
                        torch.sqrt(torch.clamp(one_over_mu0 ** 2 - 1.0,
                                               min=0.0)
                                   + config.overhead_sun_factor),
                        math.sqrt(config.overhead_sun_factor)))

        tr_diff = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                                  TAN_DIFFUSE_ANGLE_3D,
                                  config.max_3d_transfer_rate)
        tr_dir = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                                 tan_sza[:, None],
                                 config.max_3d_transfer_rate)
        band = band_from_g.to(torch.int32)
    # the layer matrices and the clear-sky planes, (R, T, Rd, Tdd, Tdir, cl5)
    with profiling.scope(LAYER_MATS):
        mats = cuda_spartacus.sw_layer_mats(
            od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band,
            P["od_scaling"], config.max_cloud_od, mu0, tr_diff, tr_dir,
            use_expm, clear_layer,
            config.do_3d_effects or config.use_expm_everywhere)

    def above(a):
        """The value of the layer above (zero above the top layer)."""
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)

    def bc(x):
        return torch.broadcast_to(x, (ncol, ng)).to(dtype).contiguous()

    lv = lambda *fs: _per_level(ncol, nlev, dtype, *fs)  # noqa: E731
    with profiling.scope(SWEEP_INPUTS):
        ones = torch.ones((ncol, 1), dtype=torch.bool, device=od.device)
        clear_pad = torch.cat([ones, clear_layer, ones], 1)
        # "jlev >= i_cloud_top": a cloudy layer exists at or above
        at_or_below_cloud_top = torch.cumsum(~clear_layer, 1) > 0
        el_above, rf_above = above(edge_length), above(reg_fracs)
        not_top = torch.arange(nlev, device=od.device) > 0
        ld = P["layer_depth"]
        x_lay_dif = ld * (TAN_DIFFUSE_ANGLE_3D / np.sqrt(2.0))
        x_lay_dir = ld * 0.5 * torch.sqrt(tan_sza[:, None] ** 2
                                          + TAN_DIFFUSE_ANGLE_3D ** 2)
        msk_up = lv(clear_layer, clear_pad[:, :-2], at_or_below_cloud_top,
                    not_top[None, :])
        msk_dn = lv(clear_layer, clear_pad[:, 2:])
        # overlap parameter between the layer above and this one
        op_above = torch.cat([torch.zeros_like(overlap_param[:, :1]),
                              overlap_param], 1)
        ent13 = lv(*reg_fracs.unbind(-1), *el_above.unbind(-1),
                   *rf_above.unbind(-1), above(P["inv_size"]), op_above,
                   x_lay_dif, x_lay_dir)
        alb_dir = bc(mu0[:, None] * albedo_direct)
        ddn0 = (incoming_sw[None] * reg_fracs[:, 0].T[..., None]
                ).contiguous()
        args = (*mats, _iface9(u_mat[:, :-1], ncol, nlev),
                _iface9(v_mat[:, :-1], ncol, nlev),
                _iface9(v_mat[:, 1:], ncol, nlev), msk_up, msk_dn, ent13,
                _diag9(bc(albedo_diffuse), ncol, ng),
                _diag9(alb_dir, ncol, ng), bc(albedo_diffuse), alb_dir, ddn0,
                bc(incoming_sw))
    P["ddn0"] = ddn0
    return SwOpts(mode=config.sw_entrapment, do_3d=config.do_3d_effects,
                  overhang_factor=config.overhang_factor,
                  cloud_fraction_threshold=config.cloud_fraction_threshold,
                  max_cloud_od=config.max_cloud_od), args, P


def solver_spartacus_sw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size,
                        pressure_hl, temperature_hl,
                        incoming_sw, cos_sza, albedo_diffuse,
                        albedo_direct, spec_matrix=None) -> SwFluxes:
    """radiation_spartacus_sw.F90:41-965.  All g-dependent inputs must be
    in SPARTACUS (reordered) g order; band_from_g is the reordered map, and
    spec_matrix (optional, for spectral profiles) has its rows in that
    order too, so the projected profiles come out in band or natural g
    order."""
    ncol, nlev, ng = od.shape
    opts, args, P = sw_sweep_args(
        config, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        cloud_fraction, fractional_std, overlap_param, inv_cloud_size,
        inv_inhom_size, pressure_hl, temperature_hl, incoming_sw, cos_sza,
        albedo_diffuse, albedo_direct)
    with profiling.scope(SWEEPS):
        albd_f9, _, albd_c_f, dn = cuda_spartacus.sw_sweeps(opts, *args)
    with profiling.scope(ASSEMBLE):
        fup_l, fdn_l, fdir_l, fup_cl, fdn_cl, fdir_cl = (x.transpose(0, 1)
                                                         for x in dn)
        fup_toa = _rsum(pl_matvec(_m3(albd_f9), P["ddn0"]))
        zeros = torch.zeros((ncol, 1, ng), dtype=od.dtype, device=od.device)
        top = lambda x, y: torch.cat([x[:, None], y], 1)  # noqa: E731
        mu0p = torch.clamp(cos_sza, min=0.0)[:, None, None]
        day = (cos_sza >= 1.0e-10)[:, None, None]
        zn = lambda a: torch.where(day, a, 0.0)  # noqa: E731
        return sw_from_g_profiles(
            flux_up_g=zn(top(fup_toa, fup_l)),
            flux_dn_diffuse_g=zn(torch.cat([zeros, fdn_l], 1)),
            flux_dn_direct_g=zn(mu0p * top(incoming_sw, fdir_l)),
            flux_up_clear_g=zn(top(incoming_sw * albd_c_f, fup_cl)),
            flux_dn_diffuse_clear_g=zn(torch.cat([zeros, fdn_cl], 1)),
            flux_dn_direct_clear_g=zn(mu0p * top(incoming_sw, fdir_cl)),
            cloud_cover=P["cloud_cover"], spec_matrix=spec_matrix)


def lw_sweep_args(config: Config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                  g_cloud_b, band_from_g, cloud_fraction, fractional_std,
                  overlap_param, inv_cloud_size, inv_inhom_size,
                  pressure_hl, temperature_hl, planck_hl, emission, albedo):
    """The arguments of cuda_spartacus.lw_sweeps for solver_spartacus_lw's
    inputs, and the prep dict."""
    ncol, nlev, ng = od.shape
    dtype = od.dtype
    P = _prep(config, cloud_fraction, fractional_std, overlap_param,
              pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    with profiling.scope(MASK):
        use_expm = _use_expm_mask(config, od, P["active_3d"])
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer, edge_length = P["clear_layer"], P["edge_length"]

    with profiling.scope(SWEEP_INPUTS):
        if not config.do_lw_aerosol_scattering:
            ssa = g = None          # an absorbing gas
        if not config.do_lw_cloud_scattering:
            ssa_cloud_b = g_cloud_b = torch.zeros_like(od_cloud_b)
        tr = _transfer_rates(reg_fracs, edge_length, P["layer_depth"],
                             TAN_DIFFUSE_ANGLE_3D,
                             config.max_3d_transfer_rate)

        # the side emissivity's part without a g axis
        # (radiation_spartacus_lw.F90:289-310): the clouds' aspect ratio
        # where it applies, 0 where the side emissivity is 1
        # (_side_emissivity)
        f0, f1 = reg_fracs[..., 0], reg_fracs[..., 1]
        aspect = torch.where(
            bool(config.do_lw_side_emissivity and config.do_3d_effects)
            & (f0 > 0.0) & (f1 > 0.0) & (P["inv_size"] > 0.0),
            1.0 / torch.clamp(P["inv_size"] * f0 * P["layer_depth"],
                              min=1e-30),
            0.0)

        pl_top, pl_bot = planck_hl[:, :-1], planck_hl[:, 1:]
        band = band_from_g.to(torch.int32)
    # the layer matrices and the clear-sky planes, (R, T, SU, SD, cl4)
    with profiling.scope(LAYER_MATS):
        mats = cuda_spartacus.lw_layer_mats(
            od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band,
            P["od_scaling"], config.max_cloud_od, tr, aspect, reg_fracs,
            clear_layer, pl_top, pl_bot, use_expm,
            config.do_3d_effects or config.use_expm_everywhere)
    lv = lambda *fs: _per_level(ncol, nlev, dtype, *fs)  # noqa: E731

    def bc(x):
        return torch.broadcast_to(x, (ncol, ng)).to(dtype).contiguous()

    with profiling.scope(SWEEP_INPUTS):
        ones = torch.ones((ncol, 1), dtype=torch.bool, device=od.device)
        clear_pad = torch.cat([ones, clear_layer, ones], 1)
        src0 = (emission[None] * reg_fracs[:, -1].T[..., None]).contiguous()
        args = (*mats, _iface9(u_mat[:, :-1], ncol, nlev),
                _iface9(v_mat[:, :-1], ncol, nlev),
                _iface9(v_mat[:, 1:], ncol, nlev),
                lv(clear_layer, clear_pad[:, :-2]),
                lv(clear_layer, clear_pad[:, 2:]),
                _diag9(bc(albedo), ncol, ng), src0, bc(albedo),
                bc(emission))
    return LwOpts(multilayer=config.do_3d_lw_multilayer_effects), args, P


def solver_spartacus_lw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size,
                        pressure_hl, temperature_hl,
                        planck_hl, emission, albedo,
                        spec_matrix=None) -> LwFluxes:
    """radiation_spartacus_lw.F90:35-607.  g-dependent inputs reordered,
    and so are the rows of spec_matrix (see solver_spartacus_sw)."""
    ncol, nlev, ng = od.shape
    opts, args, P = lw_sweep_args(
        config, od, ssa, g, od_cloud_b, ssa_cloud_b, g_cloud_b, band_from_g,
        cloud_fraction, fractional_std, overlap_param, inv_cloud_size,
        inv_inhom_size, pressure_hl, temperature_hl, planck_hl, emission,
        albedo)
    with profiling.scope(SWEEPS):
        src_f3, src_c_f, dn = cuda_spartacus.lw_sweeps(opts, *args)
    fup_l, fdn_l, fup_cl, fdn_cl = dn

    lw_derivatives = None
    if config.do_lw_derivatives:
        with profiling.scope(LW_DERIVATIVES):
            # calc_lw_derivatives_matrix
            # (radiation_lw_derivatives.F90:138-193)
            fup_surf = fup_l[-1]
            total = fup_surf.sum(-1, keepdim=True)
            d = torch.zeros((NREG, ncol, ng), dtype=od.dtype,
                            device=od.device)
            d[0] = torch.where(total > 0.0,
                               fup_surf / torch.clamp(total, min=1e-300),
                               0.0)
            Ts, u_mat = args[1], P["u_mat"]
            dvals = [None] * nlev
            for l in range(nlev - 1, -1, -1):
                d = pl_matvec(u_mat[:, l + 1].permute(1, 2, 0)[..., None], d)
                d = pl_matvec(_m3(Ts[l]), d)
                dvals[l] = d[0].sum(-1) + d[1].sum(-1) + d[2].sum(-1)
            lw_derivatives = torch.cat(
                [torch.stack(dvals, 1),
                 torch.ones((ncol, 1), dtype=od.dtype, device=od.device)],
                1)

    with profiling.scope(ASSEMBLE):
        zeros = torch.zeros((ncol, 1, ng), dtype=od.dtype, device=od.device)

        def top(x, y):
            return torch.cat([x[:, None], y.transpose(0, 1)], 1)

        return lw_from_g_profiles(
            flux_up_g=top(_rsum(src_f3), fup_l),
            flux_dn_g=torch.cat([zeros, fdn_l.transpose(0, 1)], 1),
            flux_up_clear_g=top(src_c_f, fup_cl),
            flux_dn_clear_g=torch.cat([zeros, fdn_cl.transpose(0, 1)], 1),
            cloud_cover=P["cloud_cover"], lw_derivatives=lw_derivatives,
            spec_matrix=spec_matrix)
