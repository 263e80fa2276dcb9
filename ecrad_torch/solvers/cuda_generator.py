"""McICA cloud-generator kernels: the wrappers of their CUDA builds, their
plain torch versions and the Chebyshev sampler the draw kernel's shares.

``generator_cumulate`` turns a cloud-fraction profile into the generator's
packed per-level scalars and total cloud cover in one launch
(``ecrad_torch/csrc/generator_cumulate.cu``, Exponential-Random or
Maximum-Random overlap); its plain version is the overlap cumulator
``cum_cloud_cover_exp_ran_jnp`` followed by ``pack_scalars``.

The draw kernel (``ecrad_torch/csrc/generator_scan.cu``) replaces
``ecrad_tpu/solvers/pallas_generator.py:generator_scan``, the threefry
draws that feed it (``ecrad_tpu/solvers/cloud_generator.py`` draw) and the
generator's sampling epilogue.  Layout is the port's classic one:
random planes, the CDF and od_scaling ``(ncol, nlev, ng)``, the eight
packed per-level scalars ``(ncol, nlev, 8)`` in the order (any_cloud,
frac, frac_m1, cum, cum_m1, pair_m1, overhang_m1, op_inhom_m1), the
trigger ``(ncol, ng)``.

``generator_draw_scan``, fed the per-column seeds, the total cloud cover,
the fractional standard deviation and the Chebyshev fit, draws the sample
of ``draw_planes`` element by element (``threefry.uniform_at``), scans the
levels and turns each CDF entry into the optical-depth scaling in
registers, so neither the planes nor the CDF reach device memory.  Its
plain version is ``generator_cdf_plain`` (the draws, the trigger and the
scan) followed by ``sample_pdf_cheb`` and the masks.
"""

from __future__ import annotations

import torch

from ecrad_torch import kernels
from ecrad_torch.solvers import threefry

_ANY, _F, _FM1, _C, _CM1, _PM1, _OM1, _OPIM1 = range(8)
MAX_CLOUD_FRAC = 1.0 - 2.0e-6


# --- the cumulator's plain version and its wrapper ---------------------------

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


def pack_scalars(frac, overlap_param, cum, pair, decorr, threshold):
    """The generator's packed per-level scalars (ncol, nlev, 8) and the
    total cloud cover (ncol,) of a cumulator's cover cum (ncol, nlev) and
    pair cover (ncol, nlev-1), with the inhomogeneity decorrelation
    scaling decorr and the cloud-fraction threshold."""
    total_cloud_cover = cum[:, -1].contiguous()
    overhang = cum[:, 1:] - cum[:, :-1]
    op_inhom = torch.where(overlap_param > 0.0,
                           torch.clamp(overlap_param, min=1e-30)
                           ** (1.0 / decorr),
                           overlap_param)
    is_any_cloud = frac >= threshold
    frac_m1, cum_m1, pair_m1, over_m1, op_m1 = _m1_fields(
        frac, cum, pair, overhang, op_inhom)
    scalars = torch.stack(
        [is_any_cloud.to(frac.dtype), frac, frac_m1, cum, cum_m1,
         pair_m1, over_m1, op_m1], dim=-1).contiguous()
    return scalars, total_cloud_cover


def generator_cumulate_plain(frac, overlap_param, max_ran, decorr,
                             threshold):
    """The cumulator kernel in plain torch: ``cum_cloud_cover_exp_ran_jnp``,
    then ``pack_scalars``."""
    cum, pair = cum_cloud_cover_exp_ran_jnp(frac, overlap_param,
                                            max_ran=max_ran)
    return pack_scalars(frac, overlap_param, cum, pair, decorr, threshold)


def generator_cumulate(frac, overlap_param, max_ran, decorr, threshold):
    """The generator's packed per-level scalars (ncol, nlev, 8) and total
    cloud cover (ncol,) for the cloud fraction frac (ncol, nlev) and the
    overlap parameter (ncol, nlev-1), in Maximum-Random overlap where
    max_ran, else Exponential-Random, with the inhomogeneity decorrelation
    scaling decorr and the cloud-fraction threshold.  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if frac.device.type == "cpu":
        return generator_cumulate_plain(frac, overlap_param, max_ran, decorr,
                                        threshold)
    if frac.dim() != 2 or frac.shape[1] < 1:
        raise ValueError(f"generator_cumulate: frac has shape "
                         f"{tuple(frac.shape)}, expected (ncol, nlev >= 1)")
    ncol, nlev = frac.shape
    frac, overlap_param = frac.contiguous(), overlap_param.contiguous()
    kernels.check_inputs("generator_cumulate", frac, {
        "frac": (frac, (ncol, nlev)),
        "overlap_param": (overlap_param, (ncol, nlev - 1))})
    scalars = torch.empty((ncol, nlev, 8), dtype=frac.dtype,
                          device=frac.device)
    total_cloud_cover = torch.empty((ncol,), dtype=frac.dtype,
                                    device=frac.device)
    if ncol == 0:
        return scalars, total_cloud_cover
    lib = kernels.library()
    fn = (lib.ecrad_generator_cumulate_f32 if frac.dtype == torch.float32
          else lib.ecrad_generator_cumulate_f64)
    with torch.cuda.device(frac.device):
        code = fn(frac.data_ptr(), overlap_param.data_ptr(),
                  scalars.data_ptr(), total_cloud_cover.data_ptr(), ncol,
                  nlev, int(bool(max_ran)), 1.0 / decorr, threshold,
                  kernels.stream_of(frac))
    kernels.check(code, "generator_cumulate")
    generator_cumulate.launches += 1
    return scalars, total_cloud_cover


generator_cumulate.launches = 0


# --- the draw kernel's plain version, its sampler and its wrapper ------------

def generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp):
    """The level scan as a torch loop over levels (the scan of the
    kernel's plain version; radiation_cloud_generator.F90:587-720)."""
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


def generator_cdf_plain(iseed, scalars, total_cloud_cover, ng, exp_exp):
    """The CDF plane (ncol, nlev, ng) of the sample keyed by the seeds: the
    draws (``draw_planes``), the trigger scaled by the total cloud cover,
    and the level scan, in plain torch."""
    trig, rc, ri, ri2 = draw_planes(iseed, scalars.shape[1], ng,
                                    scalars.dtype)
    trigger = trig * total_cloud_cover[:, None]
    return generator_scan_plain(rc, ri, ri2, scalars, trigger, exp_exp)


# --- the Chebyshev sampler (fit: cloud_generator.fit_pdf_cheb) -------------

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


# --- the kernel's plain version and its wrapper ------------------------------

def generator_draw_scan_plain(iseed, scalars, total_cloud_cover, ng, exp_exp,
                              fractional_std, fit, threshold):
    """The kernel in plain torch: the CDF of ``generator_cdf_plain``, then
    the Chebyshev sampler, zero where the CDF is 0, the layer is clear or
    the column's total cover is under the threshold."""
    cdf = generator_cdf_plain(iseed, scalars, total_cloud_cover, ng,
                              exp_exp)
    tcc = total_cloud_cover
    on = ((cdf > 0.0) & (scalars[..., _ANY, None] != 0.0)
          & ((tcc >= threshold) & (tcc > 0.0))[:, None, None])
    return torch.where(on, sample_pdf_cheb(fit, fractional_std[..., None],
                                           cdf),
                       torch.zeros_like(cdf))


def generator_draw_scan(iseed, scalars, total_cloud_cover, ng, exp_exp,
                        fractional_std, fit, threshold):
    """The optical-depth scaling (ncol, nlev, ng) of the sample keyed by
    the seeds iseed (ncol,) (any integer type; their low 32 bits), for the
    packed per-level scalars (ncol, nlev, 8), the total cloud cover
    (ncol,), the fractional standard deviation (ncol, nlev), the Chebyshev
    fit of ``cloud_generator.fit_pdf_cheb`` and the cloud-fraction
    threshold: zero where the CDF is 0, the layer is clear or the column's
    total cover is under the threshold.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if scalars.device.type == "cpu":
        return generator_draw_scan_plain(iseed, scalars, total_cloud_cover,
                                         ng, exp_exp, fractional_std, fit,
                                         threshold)
    ncol, nlev = scalars.shape[:2]
    fsd = fractional_std.contiguous()
    cheb = fit["cheb"].to(scalars.dtype).contiguous()
    kernels.check_inputs("generator_draw_scan", scalars, {
        "scalars": (scalars, (ncol, nlev, 8)),
        "total_cloud_cover": (total_cloud_cover, (ncol,)),
        "fractional_std": (fsd, (ncol, nlev)),
        "cheb": (cheb, (fit["nfsd"], cheb.shape[-1]))})
    if tuple(iseed.shape) != (ncol,) or iseed.device != scalars.device:
        raise ValueError(f"generator_draw_scan: iseed must be ({ncol},) on "
                         f"{scalars.device}")
    if ncol * ng >= 2**31:
        raise ValueError(f"generator_draw_scan: ncol * ng = {ncol * ng} "
                         f"threads exceed the flat int index")
    out = torch.empty((ncol, nlev, ng), dtype=scalars.dtype,
                      device=scalars.device)
    if ncol * ng == 0:
        return out
    words = threefry.seed_words(iseed)
    lib = kernels.library()
    fn = (lib.ecrad_generator_draw_sample_f32
          if scalars.dtype == torch.float32
          else lib.ecrad_generator_draw_sample_f64)
    with torch.cuda.device(scalars.device):
        code = fn(words.data_ptr(), scalars.data_ptr(),
                  total_cloud_cover.data_ptr(), fsd.data_ptr(),
                  cheb.data_ptr(), out.data_ptr(), ncol, nlev, ng,
                  int(bool(exp_exp)), fit["nfsd"], cheb.shape[-1],
                  fit["z_lo"] + fit["z_hi"], fit["z_hi"] - fit["z_lo"],
                  fit["fsd1"], fit["inv_int"], threshold,
                  kernels.stream_of(scalars))
    kernels.check(code, "generator_draw_scan")
    generator_draw_scan.launches += 1
    return out


generator_draw_scan.launches = 0
