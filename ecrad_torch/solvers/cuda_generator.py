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
* ``generator_draw_scan``: the draw build: fed the per-column seeds and
  the total cloud cover, it draws the sample of ``draw_planes`` itself,
  element by element (``threefry.uniform_at``), so the planes never reach
  device memory.  With ``sample``, the sampled build, which the McICA
  paths run on the card: the same kernel with the generator's Chebyshev
  sampling epilogue (``cloud_generator.sample_od_scaling``) in its level
  walk, writing ``od_scaling`` instead of the CDF.
"""

from __future__ import annotations

import torch

from ecrad_torch import kernels
from ecrad_torch.solvers import threefry

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


def generator_scan(rc, ri, ri2, scalars, trigger, exp_exp):
    """Returns the CDF plane (ncol, nlev, ng).  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if rc.device.type == "cpu":
        return generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp)
    ncol, nlev, ng = rc.shape
    kernels.check_inputs("generator_scan", rc, {
        "ri": (ri, (ncol, nlev, ng)), "ri2": (ri2, (ncol, nlev, ng)),
        "scalars": (scalars, (ncol, nlev, 8)),
        "trigger": (trigger, (ncol, ng))})
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
                              exp_exp, sample=None):
    """The draws (``draw_planes``), the trigger scaled by the total cloud
    cover, and the level scan, in plain torch (the reference for the draw
    build); with ``sample``, then the Chebyshev sampler and the masks of
    ``cloud_generator.sample_od_scaling`` (the reference for the sampled
    build)."""
    trig, rc, ri, ri2 = draw_planes(iseed, scalars.shape[1], ng,
                                    scalars.dtype)
    trigger = trig * total_cloud_cover[:, None]
    cdf = generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp)
    if sample is None:
        return cdf
    # imported here: cloud_generator, which holds the sampler, imports this
    # module
    from ecrad_torch.solvers.cloud_generator import sample_pdf_cheb
    fsd, fit, threshold = sample
    tcc = total_cloud_cover
    on = ((cdf > 0.0) & (scalars[..., _ANY, None] != 0.0)
          & ((tcc >= threshold) & (tcc > 0.0))[:, None, None])
    return torch.where(on, sample_pdf_cheb(fit, fsd[..., None], cdf),
                       torch.zeros_like(cdf))


def generator_draw_scan(iseed, scalars, total_cloud_cover, ng, exp_exp,
                        sample=None):
    """The CDF plane (ncol, nlev, ng) of the sample keyed by the seeds
    iseed (ncol,) (any integer type; their low 32 bits), for the packed
    per-level scalars (ncol, nlev, 8) and the total cloud cover (ncol,).
    With ``sample`` = (fractional_std (ncol, nlev), the Chebyshev fit of
    ``cloud_generator.fit_pdf_cheb``, the cloud-fraction threshold), the
    optical-depth scaling (ncol, nlev, ng) sampled from that CDF instead:
    zero where the CDF is 0, the layer is clear or the column's total
    cover is under the threshold.  CPU tensors run the plain version;
    other tensors launch the draw build, or with ``sample`` the sampled
    build (``.launches`` counts both, ``.sampled_launches`` the
    sampled)."""
    if scalars.device.type == "cpu":
        return generator_draw_scan_plain(iseed, scalars, total_cloud_cover,
                                         ng, exp_exp, sample)
    ncol, nlev = scalars.shape[:2]
    kernels.check_inputs("generator_draw_scan", scalars, {
        "scalars": (scalars, (ncol, nlev, 8)),
        "total_cloud_cover": (total_cloud_cover, (ncol,))})
    if tuple(iseed.shape) != (ncol,) or iseed.device != scalars.device:
        raise ValueError(f"generator_draw_scan: iseed must be ({ncol},) on "
                         f"{scalars.device}")
    if ncol * ng >= 2**31:
        raise ValueError(f"generator_draw_scan: ncol * ng = {ncol * ng} "
                         f"threads exceed the flat int index")
    if sample is not None:
        fsd, fit, threshold = sample
        fsd = fsd.contiguous()
        cheb = fit["cheb"].to(scalars.dtype).contiguous()
        kernels.check_inputs("generator_draw_scan", scalars, {
            "fractional_std": (fsd, (ncol, nlev)),
            "cheb": (cheb, (fit["nfsd"], cheb.shape[-1]))})
    out = torch.empty((ncol, nlev, ng), dtype=scalars.dtype,
                      device=scalars.device)
    if ncol * ng == 0:
        return out
    words = threefry.seed_words(iseed)
    lib = kernels.library()
    f32 = scalars.dtype == torch.float32
    with torch.cuda.device(scalars.device):
        if sample is None:
            fn = (lib.ecrad_generator_draw_scan_f32 if f32
                  else lib.ecrad_generator_draw_scan_f64)
            code = fn(words.data_ptr(), scalars.data_ptr(),
                      total_cloud_cover.data_ptr(), out.data_ptr(), ncol,
                      nlev, ng, int(bool(exp_exp)), kernels.stream_of(scalars))
        else:
            fn = (lib.ecrad_generator_draw_sample_f32 if f32
                  else lib.ecrad_generator_draw_sample_f64)
            code = fn(words.data_ptr(), scalars.data_ptr(),
                      total_cloud_cover.data_ptr(), fsd.data_ptr(),
                      cheb.data_ptr(), out.data_ptr(), ncol, nlev, ng,
                      int(bool(exp_exp)), fit["nfsd"], cheb.shape[-1],
                      fit["z_lo"] + fit["z_hi"], fit["z_hi"] - fit["z_lo"],
                      fit["fsd1"], fit["inv_int"], threshold,
                      kernels.stream_of(scalars))
    kernels.check(code, "generator_draw_scan")
    generator_draw_scan.launches += 1
    if sample is not None:
        generator_draw_scan.sampled_launches += 1
    return out


generator_draw_scan.launches = 0
generator_draw_scan.sampled_launches = 0
