"""McICA cloud-generator level scan: the two builds of its CUDA kernel,
their wrappers and their plain torch versions.

Replaces ``ecrad_tpu/solvers/pallas_generator.py:generator_scan`` and the
threefry draws that feed it (``ecrad_tpu/solvers/cloud_generator.py``
draw); the kernel is ``ecrad_torch/csrc/generator_scan.cu``.  Layout is
the port's classic one: random planes and the CDF ``(ncol, nlev, ng)``,
the eight packed per-level scalars ``(ncol, nlev, 8)`` in the order
(any_cloud, frac, frac_m1, cum, cum_m1, pair_m1, overhang_m1,
op_inhom_m1), the trigger ``(ncol, ng)``.

* ``generator_scan``: the planes-in build, the counterpart of the Pallas
  function, fed the random planes and the trigger.
* ``generator_draw_scan``: the draw build, which the McICA paths run: fed
  the per-column seeds and the total cloud cover, it draws the sample of
  ``draw_planes`` itself, element by element (``threefry.uniform_at``),
  so the planes never reach device memory.
"""

from __future__ import annotations

import torch

from benchmark.reference.solvers import threefry

_ANY, _F, _FM1, _C, _CM1, _PM1, _OM1, _OPIM1 = range(8)


def generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp):
    """The level scan as a torch loop over levels (the reference for the
    kernel; radiation_cloud_generator.F90:587-720)."""
    ncol, nlev, ng = rc.shape
    found = torch.zeros((ncol, ng), dtype=torch.bool, device=rc.device)
    is_cloud = torch.zeros_like(found)
    ri_prev = torch.zeros((ncol, ng), dtype=rc.dtype, device=rc.device)
    zero = torch.zeros_like(ri_prev)
    out = []
    for l in range(nlev):
        sc = scalars[:, l, :, None]                     # (ncol, 8, 1)
        any_c = sc[:, _ANY] != 0.0
        f, f_m1, c, c_m1 = sc[:, _F], sc[:, _FM1], sc[:, _C], sc[:, _CM1]
        p_m1, o_m1, opi_m1 = sc[:, _PM1], sc[:, _OM1], sc[:, _OPIM1]
        vrc, vri, vri2 = rc[:, l], ri[:, l], ri2[:, l]
        prev = is_cloud
        first = (trigger <= c) & ~found
        found = found | first
        cond = torch.where(prev, vrc * f_m1 < (f + f_m1 - p_m1),
                           vrc * (c_m1 - f_m1) < (p_m1 - o_m1 - f_m1))
        is_cloud = (first | (found & cond)) & any_c
        keep = vri2 < opi_m1
        if exp_exp:
            # the inhomogeneity chain runs across clear gaps
            # (radiation_cloud_generator.F90:497-509)
            chain = torch.where(keep, ri_prev, vri)
            emit = torch.where(is_cloud, chain, zero)
            ri_prev = chain
        else:
            emit = torch.where(is_cloud,
                               torch.where(keep & prev, ri_prev, vri), zero)
            ri_prev = emit
        out.append(emit)
    return torch.stack(out, dim=1)


def draw_planes(iseed, nlev, ng, dtype):
    """The per-column random planes of the JAX generator's ``draw``:
    key(seed) -> split(4) -> trigger (ncol, ng), rc/ri/ri2
    (ncol, nlev, ng)."""
    k1, k2, k3, k4 = threefry.split(threefry.seed_keys(iseed), 4)
    return (threefry.uniform(k1, (ng,), dtype),
            threefry.uniform(k2, (nlev, ng), dtype),
            threefry.uniform(k3, (nlev, ng), dtype),
            threefry.uniform(k4, (nlev, ng), dtype))


def generator_draw_scan_plain(iseed, scalars, total_cloud_cover, ng,
                              exp_exp):
    """The draws (``draw_planes``), the trigger scaled by the total cloud
    cover, and the level scan, in plain torch (the reference for the draw
    build)."""
    trig, rc, ri, ri2 = draw_planes(iseed, scalars.shape[1], ng,
                                    scalars.dtype)
    trigger = trig * total_cloud_cover[:, None]
    return generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp)
