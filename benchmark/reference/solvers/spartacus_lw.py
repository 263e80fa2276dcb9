"""The reference's SPARTACUS LW solver (radiation_spartacus_lw.F90:35-607)
and its LW derivatives (radiation_lw_derivatives.F90:138-193,
calc_lw_derivatives_matrix): three regions per layer, lateral exchange
between them through a 6x6 matrix exponential, the emission of the
cloud sides.

Everything is a torch loop over levels, as ecRad's solver: the layer
matrices and sources of each level (each region's two-stream
coefficients on the diagonal, and the exponential's wherever ecRad
computes it, ``use_expm``), the up sweep of albedos and sources from the
surface, the down sweep of fluxes from the top, and the derivatives of
the upwelling flux with respect to the surface's.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config
from benchmark.reference.constants import LW_DIFFUSIVITY
from benchmark.reference.solvers import two_stream
from benchmark.reference.solvers.matrix import (pl_expm, pl_matmul,
                                                pl_matvec, pl_solve_mat,
                                                pl_solve_vec)
from benchmark.reference.solvers.outputs import LwFluxes
from benchmark.reference.solvers.regions import NREG
from benchmark.reference.solvers.spartacus import (
    column_matrix, diag, diag_embed, eye3, geometry, only0, only00,
    region_optics, rsum, transfer_rates, use_expm, vmix)
from benchmark.reference.solvers.spartacus_sw import TAN_DIFFUSE_ANGLE_3D

SIDE_EMISS_THIN = 1.4107                    # radiation_spartacus_lw.F90:130
# The squarings the exponential may take: the 6x6 generator's 1-norm is
# bounded by ~2 max_cloud_od gamma1 + 4 max_3d_transfer_rate side_emiss
# ~ 120, below 2^6 theta3 = 251
MAX_SQUARINGS = 6


def refine(odr, ssar, gr, tr, side, rf, planck_top, planck_base):
    """The 3D layer matrices and sources of a batch of elements
    (radiation_spartacus_lw.F90:311-424): odr, ssar, gr and the region
    fractions rf (3, N), transfer rates tr (3, 3, N), the side emissivity
    and the Planck function at the layer's top and base (N,).  Returns (R,
    T) (3, 3, N) and the sources up and down (3, N)."""
    g1, g2 = two_stream.lw_gammas(ssar, gr)
    trs = tr.clone()
    trs[1, 0] = trs[1, 0] * side
    trs[2, 0] = trs[2, 0] * side
    D = -trs.transpose(0, 1)
    for i in range(NREG):
        D[i, i] = odr[i] * g1[i] + (trs[i, 0] + trs[i, 1] + trs[i, 2])
    G2 = odr * g2
    n = odr.shape[-1]
    G = odr.new_zeros((2 * NREG, 2 * NREG, n))
    G[:NREG, :NREG] = D
    G[NREG:, NREG:] = -D
    for i in range(NREG):
        G[i, NREG + i] = -G2[i]
        G[NREG + i, i] = G2[i]
    emis = odr * (1.0 - ssar) * rf * LW_DIFFUSIVITY
    dpl = planck_base - planck_top
    pt = torch.cat([-emis * planck_top, emis * planck_top])
    pd = torch.cat([-emis * dpl, emis * dpl])
    sol_d = -pl_solve_vec(G, pd)
    sol0 = pl_solve_vec(G, sol_d - pt)
    E = pl_expm(G, max_squarings=MAX_SQUARINGS)
    E11, E12 = E[:NREG, :NREG], E[:NREG, NREG:]
    E21, E22 = E[NREG:, :NREG], E[NREG:, NREG:]
    R = -pl_solve_mat(E11, E12)
    T = pl_matmul(E21, R) + E22
    tmp = sol0[:NREG] + sol_d[:NREG] - pl_matvec(E12, sol0[NREG:])
    su = sol0[:NREG] - pl_solve_vec(E11, tmp)
    sd = pl_matvec(E21, su - sol0[:NREG]) + sol0[NREG:] \
        - pl_matvec(E22, sol0[NREG:]) + sol_d[NREG:]
    return R, T, su, sd


def layer_matrices(l, od3, ssa3, g3, tr, side, reg_fracs, planck_hl, use,
                   clear):
    """R, T (3, 3, ncol, ng) and the sources up and down (3, ncol, ng) of
    level l, the sources weighted by region fraction: each region's
    two-stream coefficients on the diagonal, the exponential's where
    ``use`` (ncol, ng) holds, and in clear layers ``clear`` (ncol,)
    region 0's entries alone (selects, as in the SW)."""
    ncol, _, ng, _ = od3.shape
    R = od3.new_zeros((NREG, NREG, ncol, ng))
    T = torch.zeros_like(R)
    SU = od3.new_zeros((NREG, ncol, ng))
    SD = torch.zeros_like(SU)
    top, base = planck_hl[:, l], planck_hl[:, l + 1]
    for r in range(NREG):
        rf = reg_fracs[:, l, r, None]
        R[r, r], T[r, r], SU[r], SD[r] = two_stream.lw_ref_trans(
            od3[:, l, :, r], ssa3[:, l, :, r], g3[:, l, :, r], rf * top,
            rf * base)
    if bool(use.any()):
        c, g = use.nonzero(as_tuple=True)
        res = refine(od3[c, l, g].T, ssa3[c, l, g].T, g3[c, l, g].T,
                     tr[c, l].permute(1, 2, 0), side[c, l, g],
                     reg_fracs[c, l].T, top[c, g], base[c, g])
        for M, x in zip((R, T, SU, SD), res):
            M[..., c, g] = x
    keep = torch.zeros((NREG, NREG, 1, 1), dtype=torch.bool,
                       device=od3.device)
    keep[0, 0] = True
    drop = ~keep & clear[:, None]
    return (torch.where(drop, 0.0, R), torch.where(drop, 0.0, T),
            torch.where(drop[0], 0.0, SU), torch.where(drop[0], 0.0, SD))


def side_emissivity(config: Config, P, od3, ssa3, g3):
    """The effective emissivity of the cloud sides
    (radiation_spartacus_lw.F90:289-310), (ncol, nlev, ng): 1 without 3D
    effects or where the layer has no clear and thin-cloud pair."""
    f0, f1 = P["reg_fracs"][..., 0], P["reg_fracs"][..., 1]
    if not (config.do_lw_side_emissivity and config.do_3d_effects):
        return torch.ones_like(od3[..., 0])
    aspect = 1.0 / torch.clamp(P["inv_size"] * f0 * P["layer_depth"],
                               min=1e-30)
    lateral_od = (aspect[..., None] / (NREG - 1.0)) * torch.sum(
        od3[..., 1:] * (1.0 - ssa3[..., 1:]), -1)
    sq1 = torch.sqrt(torch.clamp(1.0 - ssa3[..., 1], min=0.0))
    thick = 2.0 * sq1 / (sq1 + torch.sqrt(
        torch.clamp(1.0 - ssa3[..., 1] * g3[..., 1], min=0.0)))
    side = (SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
    cond = ((f0 > 0.0) & (f1 > 0.0) & (P["inv_size"] > 0.0))[..., None]
    return torch.where(cond, side, 1.0)


def up_step(config: Config, carry, mats, clear_sky, u, v, cm, above_clear):
    """One step of the up sweep through a layer
    (radiation_spartacus_lw.F90:425-508): the albedo matrix and source of
    the regions at the layer's top from those at its base, then through
    the interface above; and the clear sky's.  ``carry``: (alb (3, 3,
    ...), src (3, ...), alb_c, src_c)."""
    alb, src, alb_c, src_c = carry
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = clear_sky
    inv_d = 1.0 / (1.0 - alb_c * rcl)
    alb_c_new = rcl + tcl * tcl * alb_c * inv_d
    src_c_new = sucl + tcl * (src_c + alb_c * sdcl) * inv_d
    denom = eye3(R) - pl_matmul(alb, R)
    X = R + pl_matmul(T, pl_solve_mat(denom, pl_matmul(alb, T)))
    S = SU + pl_matvec(T, pl_solve_vec(denom, src + pl_matvec(alb, SD)))
    # region 0 alone in a clear layer (L438-451)
    a00 = alb[0, 0]
    inv_s = 1.0 / (1.0 - a00 * R[0, 0])
    x00 = R[0, 0] + T[0, 0] * T[0, 0] * a00 * inv_s
    s0 = SU[0] + T[0, 0] * (src[0] + a00 * SD[0]) * inv_s
    X = torch.where(cm, only00(x00, X), X)
    S = torch.where(cm, only0(s0, S), S)
    # through the interface above (L485-508)
    both_clear = cm & above_clear
    src_new = torch.where(both_clear, only0(S[0], S), pl_matvec(u, S))
    if config.do_3d_lw_multilayer_effects:
        mixed = pl_matmul(pl_matmul(u, X), v)
    else:
        mixed = diag_embed(vmix(diag(X), v))
    alb_new = torch.where(both_clear, only00(X[0, 0], X), mixed)
    return (alb_new, src_new, alb_c_new, src_c_new)


def down_step(state, mats, clear_sky, below, v, cm, below_clear):
    """One step of the down sweep through a layer
    (radiation_spartacus_lw.F90:509-595).  Returns the new state and the
    layer base's up and down fluxes summed over the regions and the clear
    sky's."""
    fdn, fdn_c = state
    R, T, SU, SD = mats
    rcl, tcl, sucl, sdcl = clear_sky
    src, alb, src_c, alb_c = below
    fdn_c2 = (tcl * fdn_c + rcl * src_c + sdcl) / (1.0 - rcl * alb_c)
    fup_c = src_c + alb_c * fdn_c2
    fdn_base = pl_solve_vec(eye3(R) - pl_matmul(R, alb),
                            pl_matvec(T, fdn) + pl_matvec(R, src) + SD)
    fup_base = pl_matvec(alb, fdn_base) + src
    f0 = (T[0, 0] * fdn[0] + R[0, 0] * src[0] + SD[0]) \
        / (1.0 - R[0, 0] * alb[0, 0])
    u0 = src[0] + alb[0, 0] * f0
    fdn_base = torch.where(cm, only0(f0, fdn_base), fdn_base)
    fup_base = torch.where(cm, only0(u0, fup_base), fup_base)
    skip = cm & below_clear
    fdn_next = torch.where(skip, fdn_base, pl_matvec(v, fdn_base))
    return ((fdn_next, fdn_c2),
            (rsum(fup_base), rsum(fdn_base), fup_c, fdn_c2))


def solver_spartacus_lw(config: Config, od, ssa, g, od_cloud_b,
                        ssa_cloud_b, g_cloud_b, band_from_g,
                        cloud_fraction, fractional_std, overlap_param,
                        inv_cloud_size, inv_inhom_size, pressure_hl,
                        temperature_hl, planck_hl, emission,
                        albedo) -> LwFluxes:
    """SPARTACUS LW fluxes: clear-sky od, ssa, g (ncol, nlev, ng), the
    band-wise cloud properties, the cropped cloud fraction and the
    columns' cloud geometry, the Planck function at half-levels (ncol,
    nlev+1, ng), the surface emission and albedo (ncol, ng)."""
    ncol, nlev, ng = od.shape
    P = geometry(config, cloud_fraction, fractional_std, overlap_param,
                 pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size)
    reg_fracs, u_mat, v_mat = P["reg_fracs"], P["u_mat"], P["v_mat"]
    clear_layer = P["clear_layer"]
    if not config.do_lw_aerosol_scattering:
        ssa = torch.zeros_like(od)
        g = torch.zeros_like(od)
    if not config.do_lw_cloud_scattering:
        ssa_cloud_b = g_cloud_b = torch.zeros_like(od_cloud_b)
    od3, ssa3, g3 = region_optics(config, od, ssa, g, od_cloud_b,
                                  ssa_cloud_b, g_cloud_b, band_from_g,
                                  P["od_scaling"])
    expm_at = use_expm(config, od, P["active_3d"])
    tr = transfer_rates(reg_fracs, P["edge_length"], P["layer_depth"],
                        TAN_DIFFUSE_ANGLE_3D, config.max_3d_transfer_rate)
    side = side_emissivity(config, P, od3, ssa3, g3)
    mats = [layer_matrices(l, od3, ssa3, g3, tr, side, reg_fracs, planck_hl,
                           expm_at[:, l], clear_layer[:, l])
            for l in range(nlev)]
    clear_sky = [two_stream.lw_ref_trans(od[:, l], ssa[:, l], g[:, l],
                                         planck_hl[:, l], planck_hl[:, l + 1])
                 for l in range(nlev)]
    true = torch.ones((ncol, 1), dtype=torch.bool, device=od.device)

    def col(x, l):
        return x[:, l, None]

    # the up sweep from the surface
    alb = torch.broadcast_to(albedo, (ncol, ng))
    emis = torch.broadcast_to(emission, (ncol, ng))
    carry = (diag_embed(torch.stack([alb] * NREG)),
             emis[None] * reg_fracs[:, -1].T[..., None], alb, emis)
    below = [None] * nlev
    for l in range(nlev - 1, -1, -1):
        a, s, a_c, s_c = carry
        below[l] = (s, a, s_c, a_c)
        carry = up_step(config, carry, mats[l], clear_sky[l],
                        column_matrix(u_mat[:, l]),
                        column_matrix(v_mat[:, l]), col(clear_layer, l),
                        col(clear_layer, l - 1) if l else true)
    src_top, src_c_top = carry[1], carry[3]

    # the down sweep from the top
    state = (od.new_zeros((NREG, ncol, ng)), torch.zeros_like(emis))
    levels = []
    for l in range(nlev):
        below_clear = col(clear_layer, l + 1) if l + 1 < nlev else true
        state, out = down_step(state, mats[l], clear_sky[l], below[l],
                               column_matrix(v_mat[:, l + 1]),
                               col(clear_layer, l), below_clear)
        levels.append(out)
    fup, fdn, fup_c, fdn_c = (torch.stack(x, 1) for x in zip(*levels))

    derivatives = None
    if config.do_lw_derivatives:
        # the transmission of each layer's regions back up from the
        # surface (calc_lw_derivatives_matrix)
        total = fup[:, -1].sum(-1, keepdim=True)
        d = od.new_zeros((NREG, ncol, ng))
        d[0] = torch.where(total > 0.0, fup[:, -1]
                           / torch.clamp(total, min=1e-300), 0.0)
        rows = [None] * nlev
        for l in range(nlev - 1, -1, -1):
            d = pl_matvec(column_matrix(u_mat[:, l + 1]), d)
            d = pl_matvec(mats[l][1], d)
            rows[l] = d[0].sum(-1) + d[1].sum(-1) + d[2].sum(-1)
        derivatives = torch.cat([torch.stack(rows, 1),
                                 od.new_ones((ncol, 1))], 1)

    zeros = od.new_zeros((ncol, 1, ng))
    up = torch.cat([rsum(src_top)[:, None], fup], 1)
    dn = torch.cat([zeros, fdn], 1)
    up_clear = torch.cat([src_c_top[:, None], fup_c], 1)
    dn_clear = torch.cat([zeros, fdn_c], 1)
    return LwFluxes(
        flux_up=up.sum(-1), flux_dn=dn.sum(-1),
        flux_up_clear=up_clear.sum(-1), flux_dn_clear=dn_clear.sum(-1),
        lw_dn_surf_g=dn[:, -1], lw_up_toa_g=up[:, 0],
        lw_dn_surf_clear_g=dn_clear[:, -1], lw_up_toa_clear_g=up_clear[:, 0],
        cloud_cover=P["cloud_cover"], lw_derivatives=derivatives)
