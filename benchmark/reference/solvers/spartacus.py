"""What the reference's SPARTACUS solvers share (``spartacus_sw.py``,
``spartacus_lw.py``): the geometry of the three regions of each layer
(radiation_spartacus_sw.F90:110-296, radiation_spartacus_lw.F90:119-310),
their optical properties, the elements where the 3D exponential is
computed, and the plane helpers of the region algebra.

A 3x3 region matrix is a plane matrix ``(3, 3, ncol, ng)`` and a region
vector ``(3, ncol, ng)`` (``matrix.py``); per-column values of a level
are ``(ncol, 1)`` planes that broadcast against them.  The g axis is in
the order the route hands in (``routes/spartacus.py``): ecRad's SPARTACUS
order, RRTMG's g-points by roughly increasing gas optical depth, so that
``use_expm``'s prefix holds the thin ones; ecCKD's own order.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import Config, PdfShape
from benchmark.reference.solvers.regions import (NREG, merge_regions,
                                                 overlap_matrices,
                                                 region_properties)

# radiation_constants.F90:30-33
R_OVER_G = 287.058 / 9.80665
FOUR_OVER_PI = 4.0 / np.pi
EPS = float(np.finfo(np.float64).eps)


def eye3(like):
    """The 3x3 identity, broadcasting against a plane matrix ``like``."""
    eye = torch.eye(NREG, dtype=like.dtype, device=like.device)
    return eye.reshape((NREG, NREG) + (1,) * (like.dim() - 2))


def diag(A):
    """(3, ...): the diagonal of a plane matrix."""
    return torch.stack([A[r, r] for r in range(NREG)])


def diag_embed(d):
    """The plane matrix with diagonal d (3, ...), zeros elsewhere."""
    out = d.new_zeros((NREG,) + tuple(d.shape))
    for r in range(NREG):
        out[r, r] = d[r]
    return out


def only00(x, like):
    """A plane matrix shaped like ``like`` that holds x at [0][0] only."""
    out = torch.zeros_like(like)
    out[0, 0] = x
    return out


def only0(x, like):
    """A region vector shaped like ``like`` that holds x in region 0."""
    out = torch.zeros_like(like)
    out[0] = x
    return out


def vmix(x, v):
    """out[i] = sum_j x[j] v[j][i], summed in j order."""
    return x[0] * v[0] + x[1] * v[1] + x[2] * v[2]


def rsum(x):
    """The sum of a region vector over its regions, in region order."""
    return x[0] + x[1] + x[2]


def column_matrix(m):
    """(ncol, 3, 3) per-column matrices -> a (3, 3, ncol, 1) plane
    matrix."""
    return m.permute(1, 2, 0)[..., None]


def column_vector(x):
    """(ncol, 3) per-column region values -> (3, ncol, 1)."""
    return x.T[..., None]


def transfer_rates(reg_fracs, edge_length, dz, tan_angle, max_rate):
    """The rates of lateral transfer between the regions
    (radiation_spartacus_sw.F90:259-296): reg_fracs and edge_length (...,
    3), dz (...), tan_angle broadcasting.  Returns (..., 3, 3), capped at
    max_3d_transfer_rate; [i][j] from region i into region j."""
    f = reg_fracs

    def rate(el, fr):
        return torch.where(fr > EPS, dz * el * tan_angle
                           / torch.clamp(fr, min=EPS), torch.zeros_like(fr))

    z = torch.zeros_like(f[..., 0])
    row0 = torch.stack([z, rate(edge_length[..., 0], f[..., 0]),
                        rate(edge_length[..., 2], f[..., 0])], -1)
    row1 = torch.stack([rate(edge_length[..., 0], f[..., 1]), z,
                        rate(edge_length[..., 1], f[..., 1])], -1)
    row2 = torch.stack([rate(edge_length[..., 2], f[..., 2]),
                        rate(edge_length[..., 1], f[..., 2]), z], -1)
    return torch.clamp(torch.stack([row0, row1, row2], -2), max=max_rate)


def exchange(t):
    """The exchange matrix of transfer rates t (3, 3, N): X[i][i] =
    sum_k t[i][k], X[i][j] = -t[j][i]."""
    X = -t.transpose(0, 1)
    for i in range(NREG):
        X[i, i] = t[i, 0] + t[i, 1] + t[i, 2]
    return X


def geometry(config: Config, cloud_fraction, fractional_std, overlap_param,
             pressure_hl, temperature_hl, inv_cloud_size, inv_inhom_size):
    """The regions and their geometry (radiation_spartacus_sw.F90:110-296):
    a dict of the region fractions and od scalings, the overlap matrices
    and cloud cover, the clear layers, the layer depths, the region edge
    lengths per unit area (clear-thin, thin-thick, clear-thick; zero where
    a layer takes no 3D transfer), the 3D-active layers and the clamped
    inverse cloud size."""
    reg_fracs, od_scaling = region_properties(
        cloud_fraction, fractional_std,
        config.cloud_pdf_shape == PdfShape.GAMMA,
        config.cloud_fraction_threshold)
    u_mat, v_mat, cloud_cover = overlap_matrices(
        reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling,
        config.cloud_fraction_threshold)
    clear_layer = cloud_fraction <= 0.0
    phl, thl = pressure_hl, temperature_hl
    layer_depth = R_OVER_G * (phl[:, 1:] - phl[:, :-1]) \
        * (thl[:, :-1] + thl[:, 1:]) / (phl[:, :-1] + phl[:, 1:])

    max_inv_size = 1.0 / config.min_cloud_effective_size
    inv_size = torch.clamp(inv_cloud_size, max=max_inv_size)
    inv_inhom = (inv_size if inv_inhom_size is None
                 else torch.clamp(inv_inhom_size, max=max_inv_size))
    active_3d = (bool(config.do_3d_effects) & ~clear_layer
                 & (inv_cloud_size > 0.0))
    f0, f2 = reg_fracs[..., 0], reg_fracs[..., 2]
    el0 = FOUR_OVER_PI * f0 * (1.0 - f0) * inv_size
    el1 = FOUR_OVER_PI * f2 * (1.0 - f2) * inv_inhom
    if config.clear_to_thick_fraction > 0.0:
        el2 = config.clear_to_thick_fraction * torch.minimum(el0, el1)
        el0, el1 = el0 - el2, el1 - el2
    else:
        el2 = torch.zeros_like(el0)
    edge_length = torch.where(active_3d[..., None],
                              torch.stack([el0, el1, el2], -1), 0.0)
    return dict(reg_fracs=reg_fracs, od_scaling=od_scaling, u_mat=u_mat,
                v_mat=v_mat, cloud_cover=cloud_cover,
                clear_layer=clear_layer, layer_depth=layer_depth,
                edge_length=edge_length, active_3d=active_3d,
                inv_size=inv_size)


def region_optics(config: Config, od, ssa, g, od_cloud_b, ssa_cloud_b,
                  g_cloud_b, band_from_g, od_scaling):
    """The od, ssa and g of the three regions, region axis last: (ncol,
    nlev, ng, 3); the cloudy regions' ssa and g from their unclamped od,
    then that od capped at max_cloud_od
    (radiation_spartacus_sw.F90:297-320)."""
    od_c, ssa_c, g_c = merge_regions(od, ssa, g, od_cloud_b, ssa_cloud_b,
                                     g_cloud_b, band_from_g, od_scaling)
    od_c = torch.clamp(od_c.movedim(-2, -1), max=config.max_cloud_od)
    return (torch.cat([od[..., None], od_c], -1),
            torch.cat([ssa[..., None], ssa_c.movedim(-2, -1)], -1),
            torch.cat([g[..., None], g_c.movedim(-2, -1)], -1))


def use_expm(config: Config, od_clear, active_3d):
    """Where the 3D exponential is computed, (ncol, nlev, ng) bool: the
    g-points before the first whose clear-sky od exceeds max_gas_od_3d
    (ng3D, radiation_spartacus_sw.F90:208-216, 326-330), in 3D-active
    layers, or in every layer with use_expm_everywhere."""
    exceeds = od_clear > config.max_gas_od_3d
    prefix = torch.cumsum(exceeds, dim=-1) == 0
    if config.use_expm_everywhere:
        return prefix
    return prefix & active_3d[..., None]

