"""McICA cloud-generator level scan: CUDA kernel wrapper and its plain
torch version.

Replaces ``ecrad_tpu/solvers/pallas_generator.py:generator_scan``; the
kernel is ``ecrad_torch/csrc/generator_scan.cu``.  Layout is the port's
classic one: random planes and the CDF ``(ncol, nlev, ng)``, the eight
packed per-level scalars ``(ncol, nlev, 8)`` in the order
(any_cloud, frac, frac_m1, cum, cum_m1, pair_m1, overhang_m1,
op_inhom_m1), the trigger ``(ncol, ng)``.
"""

from __future__ import annotations

import torch

from ecrad_torch import kernels

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


def _check(rc, ri, ri2, scalars, trigger):
    ncol, nlev, ng = rc.shape
    want = {"rc": (rc, (ncol, nlev, ng)), "ri": (ri, (ncol, nlev, ng)),
            "ri2": (ri2, (ncol, nlev, ng)),
            "scalars": (scalars, (ncol, nlev, 8)),
            "trigger": (trigger, (ncol, ng))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"generator_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != rc.device or t.dtype != rc.dtype:
            raise ValueError(f"generator_scan: {name} must be {rc.dtype} "
                             f"on {rc.device}")
        if not t.is_contiguous():
            raise ValueError(f"generator_scan: {name} is not contiguous")
    if rc.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"generator_scan: unsupported dtype {rc.dtype}")
    if ng > 1024:
        raise ValueError(f"generator_scan: ng={ng} exceeds 1024 threads")


def generator_scan(rc, ri, ri2, scalars, trigger, exp_exp):
    """Returns the CDF plane (ncol, nlev, ng).  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if rc.device.type == "cpu":
        return generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp)
    if rc.device.type != "cuda":
        raise ValueError(f"generator_scan: unsupported device {rc.device}")
    _check(rc, ri, ri2, scalars, trigger)
    ncol, nlev, ng = rc.shape
    cdf = torch.empty_like(rc)
    if ncol == 0:
        return cdf
    lib = kernels.library()
    fn = (lib.ecrad_generator_scan_f32 if rc.dtype == torch.float32
          else lib.ecrad_generator_scan_f64)
    with torch.cuda.device(rc.device):
        code = fn(rc.data_ptr(), ri.data_ptr(), ri2.data_ptr(),
                  scalars.data_ptr(), trigger.data_ptr(), cdf.data_ptr(),
                  ncol, nlev, ng, int(bool(exp_exp)), kernels.stream_of(rc))
    kernels.check(code, "generator_scan")
    generator_scan.launches += 1
    return cdf


generator_scan.launches = 0
