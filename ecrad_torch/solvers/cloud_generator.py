"""McICA stochastic cloud generator, on the device
(port of ``ecrad_tpu/solvers/cloud_generator.py``, device path).

Random fields come from the threefry port (solvers/threefry.py), keyed
per column exactly as the JAX package keys them, so the sample is the
JAX package's sample bit for bit (up to roundoff in the cumulators).
The Exponential-Random and Maximum-Random cumulators run in one kernel,
``generator_cumulate`` (solvers/cuda_generator.py), which writes the packed
per-level scalars; the Exp-Exp one is plain torch.  The draws, the
per-level overlap scan and the PDF sampling run in another,
``generator_draw_scan``, which makes the random numbers and the
optical-depth scaling in registers.  On the CPU both run their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch import profiling
from ecrad_torch.config import Config, Overlap
from ecrad_torch.solvers.cuda_generator import (
    MAX_CLOUD_FRAC, generator_cumulate, generator_draw_scan, pack_scalars)

MIN_FRAC = 1.0e-6          # radiation_cloud_cover.F90:380


def cum_cloud_cover_exp_exp_jnp(frac, overlap_param):
    """Object-based Exp-Exp overlap cumulative cloud cover
    (radiation_cloud_cover.F90:339-623 cum_cloud_cover_exp_exp), in the
    batched formulation of the JAX package: a phase machine finds the
    concave cloud objects, a sort compacts their slots, and a fixed-trip
    masked loop merges the most-correlated adjacent pairs.

    frac (ncol, nlev); overlap_param (ncol, nlev-1) alpha.
    Returns (cum_cloud_cover (ncol, nlev), pair_cloud_cover
    (ncol, nlev-1)).
    """
    ncol, nlev = frac.shape
    dtype, dev = frac.dtype, frac.device
    nmax = (nlev + 1) // 2
    levs = torch.arange(nlev, dtype=torch.int64, device=dev)

    cloudy = frac > MIN_FRAC
    f_prev = torch.cat([torch.zeros_like(frac[:, :1]), frac[:, :-1]], dim=1)

    # --- phase machine: 0 clear, 1 nondecreasing, 2 decreasing
    phase = torch.zeros(ncol, dtype=torch.int64, device=dev)
    new_tops, phases = [], []
    for j in range(nlev):
        f, fp, cl = frac[:, j], f_prev[:, j], cloudy[:, j]
        new_top = cl & ((phase == 0) | ((phase == 2) & (f > fp)))
        phase = torch.where(
            ~cl, torch.zeros_like(phase),
            torch.where(new_top, torch.ones_like(phase),
                        torch.where((phase == 1) & (f < fp),
                                    torch.full_like(phase, 2), phase)))
        new_tops.append(new_top)
        phases.append(phase)
    new_top = torch.stack(new_tops, dim=1)           # (ncol, nlev)
    phase = torch.stack(phases, dim=1)

    false_col = torch.zeros_like(new_top[:, :1])
    nt_next = torch.cat([new_top[:, 1:], false_col], dim=1)
    ph_next = torch.cat([phase[:, 1:], torch.zeros_like(phase[:, :1])],
                        dim=1)
    is_last = (levs == nlev - 1)[None, :]
    is_max = (phase == 1) & (is_last | (ph_next != 1) | nt_next)
    cl_next = torch.cat([cloudy[:, 1:], false_col], dim=1)
    is_base = cloudy & (is_last | nt_next | ~cl_next)

    nobj = new_top.sum(dim=1)                        # (ncol,)

    def compact(mask):
        """Levels where mask is true, in order, padded with nlev-1."""
        vals = torch.where(mask, levs[None, :],
                           torch.full_like(mask, nlev, dtype=torch.int64))
        vals = torch.sort(vals, dim=1).values[:, :nmax]
        return torch.clamp(vals, max=nlev - 1)

    top_lev = compact(new_top)
    max_lev = compact(is_max)
    base_lev = compact(is_base)

    # --- pair cloud cover (alpha form) + within-object cumulative cover
    alpha = overlap_param
    f0, f1 = frac[:, :-1], frac[:, 1:]
    pair = (alpha * torch.maximum(f0, f1)
            + (1.0 - alpha) * (f0 + f1 - f0 * f1))
    pair_m1 = torch.cat([torch.zeros_like(pair[:, :1]), pair], dim=1)

    cum_prev = torch.zeros(ncol, dtype=dtype, device=dev)
    cums = []
    for j in range(nlev):
        fp = f_prev[:, j]
        grow = torch.where(fp >= MAX_CLOUD_FRAC, torch.ones_like(fp),
                           1.0 - (1.0 - cum_prev) * (1.0 - pair_m1[:, j])
                           / torch.clamp(1.0 - fp, min=1e-12))
        cum_prev = torch.where(new_top[:, j], frac[:, j],
                               torch.where(cloudy[:, j], grow,
                                           torch.zeros_like(grow)))
        cums.append(cum_prev)
    cum = torch.stack(cums, dim=1)                   # (ncol, nlev)

    def take(arr, idx):
        return torch.gather(arr, 1, idx)

    cc_obj = take(cum, base_lev)                     # (ncol, nmax)

    # --- inter-object correlation: product of alpha over
    # [max_lev[k], max_lev[k+1]) (radiation_cloud_cover.F90:366-371)
    log_a = torch.log(torch.clamp(alpha, min=1e-30))
    zero_a = (alpha <= 0.0).to(torch.int64)
    cs_log = torch.cat([torch.zeros((ncol, 1), dtype=dtype, device=dev),
                        torch.cumsum(log_a, dim=1)], dim=1)
    cs_zero = torch.cat([torch.zeros((ncol, 1), dtype=torch.int64,
                                     device=dev),
                         torch.cumsum(zero_a, dim=1)], dim=1)
    max_next = torch.cat([max_lev[:, 1:], max_lev[:, -1:]], dim=1)
    prod = torch.exp(take(cs_log, max_next) - take(cs_log, max_lev))
    nzero = take(cs_zero, max_next) - take(cs_zero, max_lev)
    alpha_obj = torch.where(nzero > 0, torch.zeros_like(prod), prod)

    # --- fixed-trip greedy merge
    slots = torch.arange(nmax, dtype=torch.int64, device=dev)[None, :]

    def pick(arr, oh):
        return torch.where(oh, arr, torch.zeros_like(arr)).sum(dim=1)

    cc, base, alpha_o = cc_obj, base_lev, alpha_obj
    active = slots < nobj[:, None]
    n = nobj
    for _ in range(nmax - 1):
        do = n > 1
        visited = active & (slots < (n - 1)[:, None])
        masked = torch.where(visited, alpha_o,
                             torch.full_like(alpha_o, -float("inf")))
        amx = torch.argmax(masked, dim=1)            # first maximum
        i1 = torch.where(masked.amax(dim=1) > 0.0, amx,
                         torch.zeros_like(amx))
        after = active & (slots > i1[:, None])
        i2 = torch.argmax(after.to(torch.int64), dim=1)
        oh1 = slots == i1[:, None]
        oh2 = slots == i2[:, None]
        base1 = pick(base, oh1)
        top2 = pick(top_lev, oh2)
        base2 = pick(base, oh2)
        cc1 = pick(cc, oh1)
        cc2 = pick(cc, oh2)
        a1 = pick(alpha_o, oh1)
        a2 = pick(alpha_o, oh2)
        cum_base1 = torch.gather(cum, 1, base1[:, None])[:, 0]

        cc_pair = (a1 * torch.maximum(cc1, cc2)
                   + (1.0 - a1) * (cc1 + cc2 - cc1 * cc2))
        scaling = torch.clamp((cc_pair - cc1)
                              / torch.clamp(cc2, min=MIN_FRAC), 0.0, 1.0)

        gap = (levs[None, :] > base1[:, None]) & (levs[None, :]
                                                  < top2[:, None])
        lower = (levs[None, :] >= top2[:, None]) & (levs[None, :]
                                                    <= base2[:, None])
        cum_new = torch.where(gap, cum_base1[:, None], cum)
        cum_new = torch.where(lower, cum_base1[:, None]
                              + cum * scaling[:, None], cum_new)
        cum = torch.where(do[:, None], cum_new, cum)

        sel = do[:, None] & oh1
        cc = torch.where(sel, cc_pair[:, None], cc)
        base = torch.where(sel, base2[:, None], base)
        alpha_o = torch.where(sel, a2[:, None], alpha_o)
        active = torch.where(do[:, None] & oh2, torch.zeros_like(active),
                             active)
        n = torch.where(do, n - 1, n)

    # --- fill below the lowest cloud, enforce pair >= overhang, cap
    has_cloud = (nobj > 0)[:, None]
    i_fin = torch.argmax(active.to(torch.int64), dim=1)
    base_fin = torch.gather(base, 1, i_fin[:, None])[:, 0]
    cum_fin = torch.gather(cum, 1, base_fin[:, None])[:, 0]
    below = levs[None, :] > base_fin[:, None]
    cum = torch.where(has_cloud & below, cum_fin[:, None], cum)
    pair = torch.where(has_cloud,
                       torch.maximum(pair, frac[:, :-1] + cum[:, 1:]
                                     - cum[:, :-1]),
                       torch.zeros_like(pair))
    cum = torch.where(has_cloud, torch.clamp(cum, max=1.0),
                      torch.zeros_like(cum))
    return cum, pair


def fit_pdf_cheb(pdf_tables, degree: int = 14):
    """Fit log(od_scaling) per fsd column as a Chebyshev series in the
    normal quantile z = ndtri(cdf) (host-side numpy, at setup).

    Same fit as the JAX package (there because the TPU has no fast
    gather); the port keeps it so that both sample the same function."""
    from scipy.special import ndtri as ndtri_np

    val = np.asarray(pdf_tables["val"], np.float64)      # (ncdf, nfsd)
    ncdf, nfsd = val.shape
    cdf_grid = np.arange(ncdf) / (ncdf - 1)
    rows = np.arange(1, ncdf - 1)         # drop cdf=0 (sentinel), cdf=1
    z = ndtri_np(cdf_grid[rows])
    z_lo, z_hi = float(z[0]), float(z[-1])
    t = (2.0 * z - (z_lo + z_hi)) / (z_hi - z_lo)
    coeffs = np.zeros((nfsd, degree + 1))
    for j in range(nfsd):
        y = np.log(np.maximum(val[rows, j], 1e-300))
        coeffs[j] = np.polynomial.chebyshev.chebfit(t, y, degree)
    fsd_axis = np.asarray(pdf_tables["fsd"], np.float64)
    return {
        "cheb": coeffs, "z_lo": z_lo, "z_hi": z_hi,
        "fsd1": float(fsd_axis[0]),
        "inv_int": 1.0 / float(fsd_axis[1] - fsd_axis[0]),
        "nfsd": nfsd,
    }


def scan_scalars(config: Config, frac, overlap_param):
    """The generator scan's per-level inputs for a cloud-fraction profile:
    the packed per-level scalars (ncol, nlev, 8), the exp-exp flag and the
    total cloud cover (ncol,).  Exponential-Random and Maximum-Random
    overlap take the cumulator kernel's wrapper (one launch on the card);
    Exp-Exp cumulates in torch on every device."""
    with profiling.scope("ecrad.generator.cumulator"):
        exp_exp = config.overlap_scheme == Overlap.EXPONENTIAL
        decorr = config.cloud_inhom_decorr_scaling
        thr = config.cloud_fraction_threshold
        if exp_exp:
            cum, pair = cum_cloud_cover_exp_exp_jnp(frac, overlap_param)
            scalars, total_cloud_cover = pack_scalars(
                frac, overlap_param, cum, pair, decorr, thr)
        else:
            scalars, total_cloud_cover = generator_cumulate(
                frac, overlap_param,
                config.overlap_scheme == Overlap.MAXIMUM_RANDOM, decorr, thr)
        return scalars, exp_exp, total_cloud_cover


def cloud_generator_device(config: Config, pdf_tables, iseed, frac,
                           overlap_param, fractional_std, ng: int):
    """On-device stochastic cloud sample.

    Args:
      iseed: (ncol,) int — per-column RNG key seeds.
      frac: (ncol, nlev) cloud fraction (cropped).
      overlap_param: (ncol, nlev-1).
      fractional_std: (ncol, nlev).
    Returns (od_scaling (ncol, nlev, ng), total_cloud_cover (ncol,), set
    to 0 below the cloud-fraction threshold).

    ``scan_scalars`` (the cumulator), then one ``generator_draw_scan``
    with the Chebyshev fit that ``setup_radiation`` makes for McICA.
    """
    scalars, exp_exp, total_cloud_cover = scan_scalars(config, frac,
                                                       overlap_param)
    with profiling.scope("ecrad.generator.sampler"):
        thr = config.cloud_fraction_threshold
        od_scaling = generator_draw_scan(iseed, scalars, total_cloud_cover,
                                         ng, exp_exp, fractional_std,
                                         pdf_tables["cheb_fit"], thr)
        tcc = torch.where(total_cloud_cover >= thr, total_cloud_cover,
                          torch.zeros_like(total_cloud_cover))
        return od_scaling, tcc
