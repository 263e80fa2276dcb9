"""The reference's SPARTACUS SW solver (radiation_spartacus_sw.F90:41-965,
step_migrations L966-1046): three regions per layer, lateral transfer
between them through a 9x9 block-triangular matrix exponential, and the
entrapment of the light that migrates between them.

Everything is a torch loop over levels, as ecRad's solver: the layer
matrices of each level (the two-stream coefficients of each region on the
diagonal, and the exponential's wherever ecRad computes it, ``use_expm``),
the up sweep of albedos from the surface, and the down sweep of fluxes
from the top.  Night columns are computed with mu0 = 1 and zeroed at the
end.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.config import Config, Entrapment
from benchmark.reference.solvers import two_stream
from benchmark.reference.solvers.matrix import (pl_expm_blockut,
                                                pl_fast_expm_exchange_3,
                                                pl_matmul, pl_matvec,
                                                pl_solve_mat, pl_solve_vec)
from benchmark.reference.solvers.outputs import SwFluxes
from benchmark.reference.solvers.regions import NREG
from benchmark.reference.solvers.spartacus import (
    column_matrix, column_vector, diag, diag_embed, exchange, eye3,
    geometry, only0, only00, region_optics, rsum, transfer_rates,
    use_expm, vmix)

TAN_DIFFUSE_ANGLE_3D = np.pi * 0.5          # radiation_spartacus_sw.F90:94
MIN_MU0_3D = 0.004625


def refine(odr, ssar, gr, mu0, inv_mu0, trd, trdir):
    """The 3D layer matrices of a batch of elements
    (radiation_spartacus_sw.F90:327-430): odr, ssar, gr (3, N), mu0 and
    inv_mu0 (N,), the diffuse and direct transfer rates (3, 3, N).
    Returns (R, T, Rdir, Tdiff, Tdir), each (3, 3, N)."""
    g1, g2, g3 = two_stream.sw_gammas(mu0, ssar, gr)
    Xd, Xdir = exchange(trd), exchange(trdir)
    n = odr.shape[-1]
    # the diffuse 6x6 block, the direct 3x3 block and their 6x3 coupling;
    # the lower-left 3x6 block is zero
    A11 = odr.new_zeros((2 * NREG, 2 * NREG, n))
    A13 = odr.new_zeros((2 * NREG, NREG, n))
    D = Xd.clone()
    A33 = -Xdir
    for i in range(NREG):
        D[i, i] = odr[i] * g1[i] + Xd[i, i]
        A33[i, i] = -Xdir[i, i] + -odr[i] * inv_mu0
    A11[:NREG, :NREG] = D
    A11[NREG:, NREG:] = -D
    for i in range(NREG):
        A11[i, NREG + i] = -odr[i] * g2[i]
        A11[NREG + i, i] = odr[i] * g2[i]
        A13[i, i] = -odr[i] * ssar[i] * g3[i]
        A13[NREG + i, i] = odr[i] * ssar[i] * (1.0 - g3[i])
    E11b, E13b, E33 = pl_expm_blockut(A11, A13, A33)
    E11, E12 = E11b[:NREG, :NREG], E11b[:NREG, NREG:]
    E21, E22 = E11b[NREG:, :NREG], E11b[NREG:, NREG:]
    E13, E23 = E13b[:NREG], E13b[NREG:]
    tdir = torch.clamp(E33, 0.0, 1.0)
    refl = torch.clamp(-pl_solve_mat(E11, E12), 0.0, 1.0)
    trans = torch.clamp(pl_matmul(E21, refl) + E22, 0.0, 1.0)
    rdir = torch.minimum(torch.clamp(-pl_solve_mat(E11, E13), min=0.0), mu0)
    tdd = torch.minimum(torch.clamp(pl_matmul(E21, rdir) + E23, min=0.0),
                        mu0)
    return refl, trans, rdir, tdd, tdir


def layer_matrices(l, od3, ssa3, g3, mu0, tr_diff, tr_dir, use, clear):
    """The region matrices (R, T, Rdir, Tdiff, Tdir) of level l, each (3,
    3, ncol, ng): each region's two-stream coefficients on the diagonal,
    the exponential's where ``use`` (ncol, ng) holds, and in clear layers
    ``clear`` (ncol,) the [0][0] entry alone (a select: an exponential
    never computed there leaves nothing to multiply away)."""
    ncol, _, ng, _ = od3.shape
    mats = [od3.new_zeros((NREG, NREG, ncol, ng)) for _ in range(5)]
    for r in range(NREG):
        coefs = two_stream.sw_ref_trans(mu0[:, None], od3[:, l, :, r],
                                        ssa3[:, l, :, r], g3[:, l, :, r])
        for M, c in zip(mats, coefs):
            M[r, r] = c
    if bool(use.any()):
        c, g = use.nonzero(as_tuple=True)
        res = refine(od3[c, l, g].T, ssa3[c, l, g].T, g3[c, l, g].T,
                     mu0[c], 1.0 / mu0[c], tr_diff[c, l].permute(1, 2, 0),
                     tr_dir[c, l].permute(1, 2, 0))
        for M, x in zip(mats, res):
            M[:, :, c, g] = x
    keep = torch.zeros((NREG, NREG, 1, 1), dtype=torch.bool,
                       device=od3.device)
    keep[0, 0] = True
    drop = ~keep & clear[:, None]
    return [torch.where(drop, 0.0, M) for M in mats]


def migrations(x_dif, x_dir, mats, alb, albd, x_lay_dif, x_lay_dir,
               cloud_fraction):
    """step_migrations (radiation_spartacus_sw.F90:966-1046): the
    horizontal distances that diffuse and direct light travels through a
    layer and the atmosphere below it, per region, from those below the
    layer (x_dif, x_dir (3, ...)) and the layer's own."""
    R, T, Rd, Tdd, Tdir = mats
    act = torch.stack([cloud_fraction < 1.0, cloud_fraction > 0.0,
                       cloud_fraction > 0.0])
    Rg, Tg, Rdg, Tddg, Tdirg = (diag(M) for M in (R, T, Rd, Tdd, Tdir))
    A, Ad = diag(alb), diag(albd)
    ms = Tg / (1.0 - Rg * A)
    xe = (1.0 - Rg * A) ** (-1.5)
    top_alb_dir = torch.clamp(Rdg + ms * (Tddg * A + Tdirg * Ad), min=1.0e-8)
    new_dir = torch.clamp(x_lay_dir + (
        (Tddg * A * xe + Tdirg * Ad * (xe - 1.0)) * (x_dif + x_lay_dif)
        + Tdirg * Ad * (x_dir + x_lay_dir)) * Tg / top_alb_dir, min=0.0)
    top_alb = torch.clamp(Rg + ms * Tg * A, min=1.0e-8)
    new_dif = x_lay_dif + xe * A * Tg * Tg * (x_dif + x_lay_dif) / top_alb
    return (torch.where(act, new_dif, 0.0), torch.where(act, new_dir, 0.0))


def entrapment_mix(config: Config, X, u, v, x_mig, not_top, rf, el_above,
                   rf_above, inv_size_above, op_above):
    """Explicit entrapment (radiation_spartacus_sw.F90:586-760): the part
    of the albedo matrix X reflected back into the region it entered
    from, redistributed among the regions of the layer above by the
    lateral exchange over the distance x_mig (3, ...) it travelled."""
    acc = torch.zeros_like(X)
    for j2 in range(NREG):
        ts = 1.0 - (1.0 - config.overhang_factor) * op_above \
            * torch.minimum(rf[j2], rf_above[j2]) \
            / torch.clamp(rf[j2], min=config.cloud_fraction_threshold)
        if not not_top:
            ts = torch.zeros_like(ts)

        def rate(el, iup):
            return ts * el / torch.clamp(u[iup, j2], min=1.0e-5)
        tr01, tr10 = rate(el_above[0], 0), rate(el_above[0], 1)
        tr12, tr21 = rate(el_above[1], 1), rate(el_above[1], 2)
        xj = x_mig[j2]
        if config.sw_entrapment == Entrapment.EXPLICIT:
            ff = 1.0 / torch.sqrt(torch.clamp(2.5 * xj * inv_size_above,
                                              min=1.0))
        else:
            ff = 1.0
        e10, e01, e21, e12 = (t * xj * ff for t in (tr01, tr10, tr12, tr21))
        max_entr = -torch.minimum(-e10, -e01 - e21)
        scale = torch.where(max_entr > config.max_cloud_od,
                            config.max_cloud_od
                            / torch.clamp(max_entr, min=1e-300), 1.0)
        P = pl_fast_expm_exchange_3(e10 * scale, e01 * scale, e21 * scale,
                                    e12 * scale)
        acc = acc + P * v[j2][None] * X[j2, j2]
    return acc


def up_step(config: Config, carry, mats, clear_sky, u, v, cm, above_clear,
            migrate, not_top, ent):
    """One step of the up sweep through a layer
    (radiation_spartacus_sw.F90:444-777): the diffuse and direct albedos
    of the regions at the layer's top, from those at its base, then
    through the interface above into the layer above's regions; and the
    clear-sky albedos.  ``carry``: (alb, albd (3, 3, ...), alb_c, albd_c,
    x_dif, x_dir (3, ...)); ``cm``, ``above_clear``, ``migrate`` (ncol, 1)
    bool: the layer clear, the layer above clear, a cloud at or above the
    layer; ``not_top``: a layer below the top."""
    alb, albd, alb_c, albd_c, x_dif, x_dir = carry
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = clear_sky
    rf, el_above, rf_above, inv_size_above, op_above, xld, xldir = ent
    mode = config.sw_entrapment
    explicit = mode in (Entrapment.EXPLICIT, Entrapment.EXPLICIT_NON_FRACTAL)

    # clear sky (L444-456)
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    albd_c_new = rdcl + (tdircl * albd_c + tddcl * alb_c) * tcl * inv_d

    # the layer's regions (L474-494), and region 0 alone in a clear layer
    # (L458-473)
    denom = eye3(R) - pl_matmul(alb, R)
    X = R + pl_matmul(T, pl_solve_mat(denom, pl_matmul(alb, T)))
    Xd = Rd + pl_matmul(T, pl_solve_mat(
        denom, pl_matmul(albd, Tdir) + pl_matmul(alb, Tdd)))
    a00, ad00 = alb[0, 0], albd[0, 0]
    inv_s = 1.0 / (1.0 - a00 * R[0, 0])
    s00 = R[0, 0] + T[0, 0] * T[0, 0] * a00 * inv_s
    sd00 = Rd[0, 0] + (Tdir[0, 0] * ad00 + Tdd[0, 0] * a00) * T[0, 0] * inv_s
    X = torch.where(cm, only00(s00, X), X)
    Xd = torch.where(cm, only00(sd00, Xd), Xd)

    if explicit:
        new_dif, new_dir = migrations(x_dif, x_dir, mats, alb, albd, xld,
                                      xldir, 1.0 - rf[0])
        x_dif = torch.where(migrate, new_dif, x_dif)
        x_dir = torch.where(migrate, new_dir, x_dir)

    # through the interface above (L510-760)
    def full(A):
        return pl_matmul(pl_matmul(u, A), v)

    fX, fXd = full(X), full(Xd)
    both_clear = cm & above_clear
    if mode == Entrapment.MAXIMUM:
        alb_new, albd_new = fX, fXd
    elif mode == Entrapment.ZERO:
        def zero_mix(A):
            return diag_embed(vmix(A[0] + A[1] + A[2], v))
        alb_new = torch.where(above_clear, fX, zero_mix(X))
        albd_new = torch.where(above_clear, fXd, zero_mix(Xd))
    else:
        def off_diagonal(A):
            return torch.where(eye3(A) != 0.0, 0.0, A)

        base, based = full(off_diagonal(X)), full(off_diagonal(Xd))
        if mode == Entrapment.EDGE_ONLY or not config.do_3d_effects:
            alb_new = base + diag_embed(vmix(diag(X), v))
            albd_new = based + diag_embed(vmix(diag(Xd), v))
        else:
            geo = (not_top, rf, el_above, rf_above, inv_size_above, op_above)
            alb_new = base + entrapment_mix(config, X, u, v, x_dif, *geo)
            albd_new = based + entrapment_mix(config, Xd, u, v, x_dir, *geo)
        alb_new = torch.where(above_clear, fX, alb_new)
        albd_new = torch.where(above_clear, fXd, albd_new)
    alb_new = torch.where(both_clear, only00(X[0, 0], X), alb_new)
    albd_new = torch.where(both_clear, only00(Xd[0, 0], Xd), albd_new)

    # the distances migrate through the interface (L758-777)
    if explicit:
        regions = torch.stack([torch.ones_like(cm), ~cm, ~cm])
        moved = ~both_clear
        x_dif = torch.where(moved, vmix(torch.where(regions, x_dif, 0.0), v),
                            x_dif)
        x_dir = torch.where(moved, vmix(torch.where(regions, x_dir, 0.0), v),
                            x_dir)
    return (alb_new, albd_new, alb_c_new, albd_c_new, x_dif, x_dir)


def down_step(state, mats, clear_sky, below, v, cm, below_clear):
    """One step of the down sweep through a layer
    (radiation_spartacus_sw.F90:779-957): the diffuse and direct fluxes of
    the regions at the layer's base from those at its top and the albedos
    below it, then through the interface below.  Returns the new state
    and the layer base's (up, diffuse down, direct down) summed over the
    regions and the clear sky's."""
    fdn, ddn, fdn_c, ddn_c = state
    R, T, Rd, Tdd, Tdir = mats
    rcl, tcl, rdcl, tddcl, tdircl = clear_sky
    alb, albd, alb_c, albd_c = below
    src_c = tddcl * ddn_c
    ddn_c2 = tdircl * ddn_c
    fdn_c2 = (tcl * fdn_c + rcl * albd_c * ddn_c2 + src_c) \
        / (1.0 - rcl * alb_c)
    fup_c = albd_c * ddn_c2 + alb_c * fdn_c2

    src = pl_matvec(Tdd, ddn)
    ddn_base = pl_matvec(Tdir, ddn)
    tsrc = pl_matvec(albd, ddn_base)
    fdn_base = pl_solve_vec(eye3(R) - pl_matmul(R, alb),
                            pl_matvec(T, fdn) + pl_matvec(R, tsrc) + src)
    fup_base = pl_matvec(alb, fdn_base) + tsrc
    f0 = (T[0, 0] * fdn[0] + R[0, 0] * albd[0, 0] * ddn_base[0] + src[0]) \
        / (1.0 - R[0, 0] * alb[0, 0])
    u0 = albd[0, 0] * ddn_base[0] + alb[0, 0] * f0
    fdn_base = torch.where(cm, only0(f0, fdn_base), fdn_base)
    fup_base = torch.where(cm, only0(u0, fup_base), fup_base)
    skip = cm & below_clear
    fdn_next = torch.where(skip, fdn_base, pl_matvec(v, fdn_base))
    ddn_next = torch.where(skip, ddn_base, pl_matvec(v, ddn_base))
    return ((fdn_next, ddn_next, fdn_c2, ddn_c2),
            (rsum(fup_base), rsum(fdn_base), rsum(ddn_base), fup_c, fdn_c2,
             ddn_c2))


def solver_spartacus_sw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size, pressure_hl,
                        temperature_hl, incoming_sw, cos_sza,
                        albedo_diffuse, albedo_direct) -> SwFluxes:
    """SPARTACUS SW fluxes: clear-sky od, ssa, g (ncol, nlev, ng), the
    band-wise cloud properties, the cropped cloud fraction and the
    columns' cloud geometry, the incoming flux and surface albedos per
    g-point (ncol, ng)."""
    ncol, nlev, ng = od.shape
    P = geometry(config, cloud_fraction, fractional_std, overlap_param,
                 pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer, edge_length = P["clear_layer"], P["edge_length"]

    day = cos_sza >= 1.0e-10
    mu0 = torch.where(day, torch.clamp(cos_sza, min=1.0e-10), 1.0)
    inv_mu0 = 1.0 / mu0
    # radiation_spartacus_sw.F90:168-176
    tan_sza = torch.where(
        mu0 < MIN_MU0_3D, math.sqrt(1.0 / MIN_MU0_3D ** 2 - 1.0),
        torch.where(inv_mu0 > 1.0,
                    torch.sqrt(torch.clamp(inv_mu0 ** 2 - 1.0, min=0.0)
                               + config.overhead_sun_factor),
                    math.sqrt(config.overhead_sun_factor)))
    od3, ssa3, g3 = region_optics(config, od, ssa, g, od_cloud_b,
                                  ssa_cloud_b, g_cloud_b, band_from_g,
                                  P["od_scaling"])
    expm_at = use_expm(config, od, P["active_3d"])
    ld = P["layer_depth"]
    tr_diff = transfer_rates(reg_fracs, edge_length, ld,
                             TAN_DIFFUSE_ANGLE_3D, config.max_3d_transfer_rate)
    tr_dir = transfer_rates(reg_fracs, edge_length, ld, tan_sza[:, None],
                            config.max_3d_transfer_rate)
    mats = [layer_matrices(l, od3, ssa3, g3, mu0, tr_diff, tr_dir,
                           expm_at[:, l], clear_layer[:, l])
            for l in range(nlev)]
    clear_sky = [two_stream.sw_ref_trans(mu0[:, None], od[:, l], ssa[:, l],
                                         g[:, l]) for l in range(nlev)]

    # per-column values of each level, (ncol, 1)
    x_lay_dif = ld * (TAN_DIFFUSE_ANGLE_3D / np.sqrt(2.0))
    x_lay_dir = ld * 0.5 * torch.sqrt(tan_sza[:, None] ** 2
                                      + TAN_DIFFUSE_ANGLE_3D ** 2)
    cloud_at_or_above = torch.cumsum(~clear_layer, 1) > 0
    true = torch.ones((ncol, 1), dtype=torch.bool, device=od.device)

    def col(x, l):
        return x[:, l, None]

    def col_above(x, l, fill):
        """The layer above's value at level l, ``fill`` at the top."""
        if l == 0:
            return torch.full_like(x[:, 0, None], fill)
        return x[:, l - 1, None]

    # the up sweep from the surface, keeping the albedos below each layer
    alb_dif = torch.broadcast_to(albedo_diffuse, (ncol, ng))
    alb_dir = torch.broadcast_to(mu0[:, None] * albedo_direct, (ncol, ng))
    zero3 = od.new_zeros((NREG, ncol, ng))
    carry = (diag_embed(torch.stack([alb_dif] * NREG)),
             diag_embed(torch.stack([alb_dir] * NREG)), alb_dif, alb_dir,
             zero3, zero3)
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        below[l] = carry[:4]
        ent = (column_vector(reg_fracs[:, l]),
               column_vector(edge_length[:, l - 1]) if l
               else od.new_zeros((NREG, ncol, 1)),
               column_vector(reg_fracs[:, l - 1]) if l
               else od.new_zeros((NREG, ncol, 1)),
               col_above(P["inv_size"], l, 0.0),
               col_above(overlap_param, l, 0.0),
               col(x_lay_dif, l), col(x_lay_dir, l))
        carry = up_step(
            config, carry, mats[l], clear_sky[l], column_matrix(u_mat[:, l]),
            column_matrix(v_mat[:, l]), col(clear_layer, l),
            col_above(clear_layer, l, True), col(cloud_at_or_above, l),
            l > 0, ent)
    albd_top = carry[1]
    albd_c_top = carry[3]

    # the down sweep from the top
    ddn0 = incoming_sw[None] * reg_fracs[:, 0].T[..., None]
    state = (zero3, ddn0, torch.zeros_like(incoming_sw), incoming_sw)
    levels = []
    for l in range(nlev):
        below_clear = (col(clear_layer, l + 1) if l + 1 < nlev else true)
        state, out = down_step(state, mats[l], clear_sky[l], below[l],
                               column_matrix(v_mat[:, l + 1]),
                               col(clear_layer, l), below_clear)
        levels.append(out)
    fup, fdn, fdir, fup_c, fdn_c, fdir_c = (torch.stack(x, 1)
                                            for x in zip(*levels))

    fup_toa = rsum(pl_matvec(albd_top, ddn0))
    mu0_day = torch.clamp(cos_sza, min=0.0)[:, None, None]
    is_day = day[:, None, None]
    zeros = od.new_zeros((ncol, 1, ng))

    def profile(top, levels):
        return torch.where(is_day, torch.cat([top[:, None], levels], 1), 0.0)

    up = profile(fup_toa, fup)
    dn_diffuse = profile(zeros[:, 0], fdn)
    dn_direct = mu0_day * profile(incoming_sw, fdir)
    up_clear = profile(incoming_sw * albd_c_top, fup_c)
    dn_diffuse_clear = profile(zeros[:, 0], fdn_c)
    dn_direct_clear = mu0_day * profile(incoming_sw, fdir_c)
    dn, dn_clear = dn_diffuse + dn_direct, dn_diffuse_clear + dn_direct_clear
    return SwFluxes(
        flux_up=up.sum(-1), flux_dn=dn.sum(-1),
        flux_dn_direct=dn_direct.sum(-1), flux_up_clear=up_clear.sum(-1),
        flux_dn_clear=dn_clear.sum(-1),
        flux_dn_direct_clear=dn_direct_clear.sum(-1),
        sw_dn_diffuse_surf_g=dn_diffuse[:, -1],
        sw_dn_direct_surf_g=dn_direct[:, -1], sw_up_toa_g=up[:, 0],
        sw_dn_diffuse_surf_clear_g=dn_diffuse_clear[:, -1],
        sw_dn_direct_surf_clear_g=dn_direct_clear[:, -1],
        sw_up_toa_clear_g=up_clear[:, 0], cloud_cover=P["cloud_cover"])
