"""What the reference's Tripleclouds solvers share (``tripleclouds_sw.py``,
``tripleclouds_lw.py``): the three regions of each layer and the overlap
matrices between them (``regions.py``), the clear layers, and the mixes of
a region vector through an interface (radiation_matrix.F90
singlemat_x_vec, written out as sums in region order).

A region vector is ``(ncol, 3, ng)``: region 0 the clear sky, 1 and 2 the
thin and thick cloud.  An interface's overlap matrices are ``(ncol, 3,
3)``, ``u[upper, lower]`` and ``v[lower, upper]`` (``regions.py``).
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config, PdfShape
from benchmark.reference.solvers.regions import (NREG, overlap_matrices,
                                                 region_properties)


def regions(config: Config, cloud_fraction, fractional_std, overlap_param):
    """The regions of every layer (radiation_regions.F90:35-202), the
    overlap matrices at every interface and the cloud cover
    (radiation_overlap.F90:280-459), and the clear layers: those whose
    cloud fraction is below the threshold (ecRad's is_clear_sky_layer).
    A dict of reg_fracs (ncol, nlev, 3), od_scaling (ncol, nlev, 2), u and
    v (ncol, nlev+1, 3, 3), cloud_cover (ncol,), clear (ncol, nlev)."""
    thr = config.cloud_fraction_threshold
    reg_fracs, od_scaling = region_properties(
        cloud_fraction, fractional_std,
        config.cloud_pdf_shape == PdfShape.GAMMA, thr)
    u, v, cloud_cover = overlap_matrices(
        reg_fracs, overlap_param, config.cloud_inhom_decorr_scaling, thr)
    return dict(reg_fracs=reg_fracs, od_scaling=od_scaling, u=u, v=v,
                cloud_cover=cloud_cover, clear=~(cloud_fraction >= thr))


def mixed_at(clear, l: int, other: int):
    """(ncol, 1, 1): whether the interface between layer l and layer
    ``other`` mixes the regions, that is unless both layers are clear;
    the layers above the top and below the surface are clear."""
    both = clear[:, l]
    if 0 <= other < clear.shape[1]:
        both = both & clear[:, other]
    return ~both[:, None, None]


def _mix(m, x):
    """out[:, i] = sum_j m[:, i, j] x[:, j], summed in j order."""
    return torch.stack([sum(m[:, i, j, None] * x[:, j] for j in range(NREG))
                        for i in range(NREG)], dim=1)


def albedo_above(v, x):
    """The albedo of each region of the layer above an interface from
    those of the layer below: out[upper] = sum_lower v[lower, upper]
    x[lower]."""
    return _mix(v.transpose(-1, -2), x)


def source_above(u, x):
    """The upward flux (or source) entering each region of the layer above
    an interface: out[upper] = sum_lower u[upper, lower] x[lower]."""
    return _mix(u, x)


def flux_below(v, x):
    """The downward flux entering each region of the layer below an
    interface: out[lower] = sum_upper v[lower, upper] x[upper]."""
    return _mix(v, x)


def clear_only(clear_l, x):
    """A region vector with its cloudy regions zeroed in the clear layers
    ``clear_l`` (ncol,): ecRad computes region 0 alone there."""
    cloudy_region = torch.arange(NREG, device=x.device) > 0
    return torch.where(clear_l[:, None, None] & cloudy_region[:, None],
                       torch.zeros_like(x), x)


def with_regions(clear_coef, cloudy2):
    """Clear-sky (ncol, nlev, ng) and cloudy-region (ncol, nlev, 2, ng)
    layer coefficients -> (ncol, nlev, 3, ng)."""
    return torch.cat([clear_coef[..., None, :], cloudy2], dim=-2)
