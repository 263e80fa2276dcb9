"""McICA stochastic cloud generator, on the device
(port of ``ecrad_tpu/solvers/cloud_generator.py``, device path).

Random fields come from the threefry port (solvers/threefry.py), keyed
per column exactly as the JAX package keys them, so the sample is the
JAX package's sample bit for bit (up to roundoff in the cumulators).
The per-level overlap scan runs in the ``generator_scan`` kernel
(solvers/cuda_generator.py); the PDF sampling epilogue is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ecrad_torch.config import Config, Overlap
from ecrad_torch.solvers import threefry
from ecrad_torch.solvers.cuda_generator import generator_scan

MAX_CLOUD_FRAC = 1.0 - 2.0e-6
MIN_FRAC = 1.0e-6          # radiation_cloud_cover.F90:380


def cum_cloud_cover_exp_ran_jnp(frac, overlap_param, max_ran=False):
    """Overlap cumulator (radiation_cloud_cover.F90:124-229).

    frac (ncol, nlev); overlap_param (ncol, nlev-1).
    Returns (cum_cloud_cover (ncol, nlev), pair_cloud_cover (ncol, nlev-1)).
    """
    f0, f1 = frac[:, :-1], frac[:, 1:]
    if max_ran:
        pair = torch.maximum(f0, f1)
    else:
        a = overlap_param
        pair = (a * torch.maximum(f0, f1)
                + (1.0 - a) * (f0 + f1 - f0 * f1))

    cum_product = 1.0 - frac[:, 0]
    levels = [frac[:, 0]]
    for j in range(frac.shape[1] - 1):
        f = frac[:, j]
        cum_product = torch.where(
            f >= MAX_CLOUD_FRAC, torch.zeros_like(cum_product),
            cum_product * (1.0 - pair[:, j])
            / torch.clamp(1.0 - f, min=1.0e-12))
        levels.append(1.0 - cum_product)
    return torch.stack(levels, dim=1), pair


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


def cheb_coeffs_for(fit, fsd, dtype):
    """Per-(col,lev) Chebyshev coefficients interpolated in fsd.

    fsd (ncol, nlev) -> (ncol, nlev, deg+1)."""
    cheb = fit["cheb"].to(dtype)                        # (nfsd, deg+1)
    nfsd = fit["nfsd"]
    wfsd = (fsd - fit["fsd1"]) * fit["inv_int"] + 1.0
    ifsd = torch.clamp(wfsd.to(torch.int64), 1, nfsd - 1)
    wfsd = torch.clamp(wfsd - ifsd, 0.0, 1.0)[..., None]
    c0 = cheb[torch.clamp(ifsd - 1, 0, nfsd - 1)]
    c1 = cheb[torch.clamp(ifsd, 0, nfsd - 1)]
    return (1.0 - wfsd) * c0 + wfsd * c1


# Cephes ndtri coefficients (the same rational approximations as scipy's)
_NDTRI_P0 = (-5.99633501014107895267e1, 9.80010754185999661536e1,
             -5.66762857469070293439e1, 1.39312609387279679503e1,
             -1.23916583867381258016e0)
_NDTRI_Q0 = (1.95448858338141759834e0, 4.67627912898881538453e0,
             8.63602421390890590575e1, -2.25462687854119370527e2,
             2.00260212380060660359e2, -8.20372256168538034268e1,
             1.59056225126211695515e1, -1.18331621121330003142e0)
_NDTRI_P1 = (4.05544892305962419923e0, 3.15251094599893866154e1,
             5.71628192246421288162e1, 4.40805073893200834700e1,
             1.46849561928858024014e1, 2.18663306850790267539e0,
             -1.40256079171354495875e-1, -3.50424626827848203418e-2,
             -8.57456785154685413611e-4)
_NDTRI_Q1 = (1.57799883256466749731e1, 4.53907635128879210584e1,
             4.13172038254672030440e1, 1.50425385692907503408e1,
             2.50464946208309415979e0, -1.42182922854787788574e-1,
             -3.80806407691578277194e-2, -9.33259480895457427372e-4)
_NDTRI_P2 = (3.23774891776946035970e0, 6.91522889068984211695e0,
             3.93881025292474443415e0, 1.33303460815807542389e0,
             2.01485389549179081538e-1, 1.23716634817820021358e-2,
             3.01581553508235416007e-4, 2.65806974686737550832e-6,
             6.23974539184983651783e-9)
_NDTRI_Q2 = (6.02427039364742014255e0, 3.67983563856160859403e0,
             1.37702099489081330271e0, 2.16236993594496635890e-1,
             1.34204006088543189037e-2, 3.28014464682127739104e-4,
             2.89247864745380683936e-6, 6.79019408009981274425e-9)


def _polevl(x, coeffs):
    y = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        y = x * y + c
    return y


def _p1evl(x, coeffs):
    y = torch.ones_like(x)
    for c in coeffs:
        y = x * y + c
    return y


def ndtri(p):
    """Inverse normal CDF (cephes rational approximations; the same
    evaluation order as ``ecrad_tpu/solvers/cloud_generator.ndtri``)."""
    s2pi = 2.50662827463100050242
    exp_m2 = 0.13533528323661269189

    flip = p > 1.0 - exp_m2
    y = torch.where(flip, 1.0 - p, p)

    # central region
    yc = y - 0.5
    y2 = yc * yc
    x_c = yc + yc * (y2 * _polevl(y2, _NDTRI_P0) / _p1evl(y2, _NDTRI_Q0))
    x_c = x_c * s2pi

    # tails (guard y for the central-path lanes)
    ysafe = torch.clamp(y, 1e-30, 1.0)
    x = torch.sqrt(-2.0 * torch.log(ysafe))
    x0 = x - torch.log(x) / x
    z = 1.0 / x
    x1 = torch.where(x < 8.0,
                     z * _polevl(z, _NDTRI_P1) / _p1evl(z, _NDTRI_Q1),
                     z * _polevl(z, _NDTRI_P2) / _p1evl(z, _NDTRI_Q2))
    x_t = x1 - x0                         # negative tail value

    central = y > exp_m2
    return torch.where(central, x_c, torch.where(flip, -x_t, x_t))


def cheb_eval(fit, coeff_at, ncoef, cdf):
    """exp(cheb(ndtri(cdf))) — the PDF sample evaluation.

    coeff_at(k): coefficient k broadcastable against cdf."""
    eps = 1e-7
    z = ndtri(torch.clamp(cdf, eps, 1.0 - eps))
    t = torch.clamp((2.0 * z - (fit["z_lo"] + fit["z_hi"]))
                    / (fit["z_hi"] - fit["z_lo"]), -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    two_t = 2.0 * t
    for k in range(ncoef - 1, 0, -1):
        b1, b2 = two_t * b1 - b2 + coeff_at(k), b1
    y = t * b1 - b2 + coeff_at(0)
    return torch.exp(y)


def sample_pdf_cheb(fit, fsd, cdf):
    """od_scaling = exp(cheb(z)) with coefficients interpolated in fsd.
    fsd (..., 1) broadcasting against cdf (..., ng)."""
    c = cheb_coeffs_for(fit, fsd[..., 0], cdf.dtype)    # (..., deg+1)
    cb = c[..., None, :]
    return cheb_eval(fit, lambda k: cb[..., k], c.shape[-1], cdf)


def sample_pdf_jnp(pdf_tables, fsd, cdf):
    """Bilinear PDF LUT lookup (radiation_pdf_sampler.F90:59-105)."""
    val = pdf_tables["val"].to(cdf.dtype)            # (ncdf, nfsd)
    ncdf, nfsd = val.shape
    fsd1 = float(pdf_tables["fsd"][0])
    inv_int = 1.0 / float(pdf_tables["fsd"][1] - pdf_tables["fsd"][0])

    wcdf = cdf * (ncdf - 1) + 1.0
    icdf = torch.clamp(wcdf.to(torch.int64), 1, ncdf - 1)
    wcdf = torch.clamp(wcdf - icdf, 0.0, 1.0)
    wfsd = (fsd - fsd1) * inv_int + 1.0
    ifsd = torch.clamp(wfsd.to(torch.int64), 1, nfsd - 1)
    wfsd = torch.clamp(wfsd - ifsd, 0.0, 1.0)
    flat = val.reshape(-1)

    def at(ic, ifs):
        return flat[torch.clamp(ic - 1, 0, ncdf - 1) * nfsd
                    + torch.clamp(ifs - 1, 0, nfsd - 1)]

    return ((1 - wcdf) * (1 - wfsd) * at(icdf, ifsd)
            + (1 - wcdf) * wfsd * at(icdf, ifsd + 1)
            + wcdf * (1 - wfsd) * at(icdf + 1, ifsd)
            + wcdf * wfsd * at(icdf + 1, ifsd + 1))


def _m1_fields(frac, cum, pair, overhang, op_inhom):
    """Per-level fields shifted to the jlev-1 position (dummy level -1
    prepended)."""
    z = lambda x: torch.zeros_like(x[:, :1])
    frac_m1 = torch.cat([z(frac), frac[:, :-1]], dim=1)
    cum_m1 = torch.cat([z(cum), cum[:, :-1]], dim=1)
    pair_m1 = torch.cat([z(pair), pair], dim=1)          # pair at jlev-1
    over_m1 = torch.cat([z(overhang), overhang], dim=1)
    op_m1 = torch.cat([z(op_inhom), op_inhom], dim=1)
    return frac_m1, cum_m1, pair_m1, over_m1, op_m1


def draw_planes(iseed, nlev, ng, dtype):
    """The per-column random planes of the JAX generator's ``draw``:
    key(seed) -> split(4) -> trigger (ncol, ng), rc/ri/ri2
    (ncol, nlev, ng)."""
    k1, k2, k3, k4 = threefry.split(threefry.seed_keys(iseed), 4)
    return (threefry.uniform(k1, (ng,), dtype),
            threefry.uniform(k2, (nlev, ng), dtype),
            threefry.uniform(k3, (nlev, ng), dtype),
            threefry.uniform(k4, (nlev, ng), dtype))


def scan_inputs(config: Config, iseed, frac, overlap_param, ng: int):
    """The generator scan's inputs for a cloud-fraction profile: random
    planes rc/ri/ri2 (ncol, nlev, ng), the packed per-level scalars
    (ncol, nlev, 8), the trigger (ncol, ng), the exp-exp flag, and the
    total cloud cover (ncol,)."""
    nlev = frac.shape[1]
    exp_exp = config.overlap_scheme == Overlap.EXPONENTIAL
    if exp_exp:
        cum, pair = cum_cloud_cover_exp_exp_jnp(frac, overlap_param)
    else:
        max_ran = config.overlap_scheme == Overlap.MAXIMUM_RANDOM
        cum, pair = cum_cloud_cover_exp_ran_jnp(frac, overlap_param,
                                                max_ran=max_ran)
    total_cloud_cover = cum[:, -1]
    overhang = cum[:, 1:] - cum[:, :-1]

    decorr = config.cloud_inhom_decorr_scaling
    op_inhom = torch.where(overlap_param > 0.0,
                           torch.clamp(overlap_param, min=1e-30)
                           ** (1.0 / decorr),
                           overlap_param)

    trig, rc, ri, ri2 = draw_planes(iseed, nlev, ng, frac.dtype)
    is_any_cloud = frac >= config.cloud_fraction_threshold
    frac_m1, cum_m1, pair_m1, over_m1, op_m1 = _m1_fields(
        frac, cum, pair, overhang, op_inhom)
    scalars = torch.stack(
        [is_any_cloud.to(frac.dtype), frac, frac_m1, cum, cum_m1,
         pair_m1, over_m1, op_m1], dim=-1).contiguous()
    trigger = trig * total_cloud_cover[:, None]
    return rc, ri, ri2, scalars, trigger, exp_exp, total_cloud_cover


def cloud_generator_device(config: Config, pdf_tables, iseed, frac,
                           overlap_param, fractional_std, ng: int):
    """On-device stochastic cloud sample.

    Args:
      iseed: (ncol,) int — per-column RNG key seeds.
      frac: (ncol, nlev) cloud fraction (cropped).
      overlap_param: (ncol, nlev-1).
      fractional_std: (ncol, nlev).
    Returns (od_scaling (ncol, nlev, ng), total_cloud_cover (ncol,)).
    """
    rc, ri, ri2, scalars, trigger, exp_exp, total_cloud_cover = \
        scan_inputs(config, iseed, frac, overlap_param, ng)
    cdf = generator_scan(rc, ri, ri2, scalars, trigger, exp_exp)

    thr = config.cloud_fraction_threshold
    tcc = torch.where(total_cloud_cover >= thr, total_cloud_cover,
                      torch.zeros_like(total_cloud_cover))
    if pdf_tables.get("cheb_fit") is not None:
        sampled = sample_pdf_cheb(pdf_tables["cheb_fit"],
                                  fractional_std[..., None], cdf)
    else:
        sampled = sample_pdf_jnp(pdf_tables, fractional_std[..., None], cdf)
    zero = torch.zeros_like(cdf)
    od_scaling = torch.where(cdf > 0.0, sampled, zero)
    od_scaling = torch.where((frac >= thr)[..., None], od_scaling, zero)
    od_scaling = torch.where(tcc[:, None, None] > 0.0, od_scaling, zero)
    return od_scaling, tcc
