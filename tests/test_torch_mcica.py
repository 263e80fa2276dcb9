"""The port's McICA solvers and fused-sweep plain versions against the
JAX package, on the same random inputs (CPU, f64).

* ``lw_fused_plain``/``sw_fused_plain`` against the Pallas kernels
  ``pallas_mcica.lw_fused``/``sw_fused`` in interpret mode, on the same
  kernel-layout planes (transposed to the port's layout).
* The orders in which ``csrc/sw_fused.cu`` (two passes with direct
  albedos, ``test_torch_adding.direct_albedo_sweeps``) and
  ``csrc/lw_fused.cu`` (three passes, the derivatives a chain and a sum
  over g) compute, in plain torch, against the plain versions.
* ``solver_mcica_lw``/``sw`` against the JAX package's scan path, with
  derivatives on and off, night columns and an odd column count; the
  port runs its fused path (plain version on the CPU) and, for a g axis
  that is not band-contiguous, its unfused adding path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ecrad_tpu.solvers import mcica as jmcica
from ecrad_tpu.solvers import pallas_mcica
from ecrad_torch.solvers import cuda_mcica
from ecrad_torch.solvers import mcica as tmcica
from tests.test_torch_adding import direct_albedo_sweeps

torch.set_num_threads(2)

NCOL, NLEV = 19, 17
NBAND = 5
GCOUNTS = (3, 2, 4, 2, 3)          # ng = 14, band-contiguous
NG = sum(GCOUNTS)
BAND_FROM_G = np.repeat(np.arange(NBAND), GCOUNTS)
# a g axis that is not band-contiguous: both packages take the unfused path
BAND_SHUFFLED = np.random.default_rng(7).permutation(BAND_FROM_G)

# f64 roundoff through ~20-level recurrences: the fused sweeps and the
# scan path sum the same terms in another order
RTOL_LW, ATOL = 1e-11, 1e-10
# the Pallas SW kernel uses a cubic series for 1 - exp(-2 k od) below
# x = 0.01 (two_stream.py pallas_safe, rel. error < x^3/24 ~ 5e-8); the
# port uses expm1, as does the JAX scan path
RTOL_SW_PALLAS, ATOL_SW_PALLAS = 5e-8, 1e-8
# port vs JAX scan path: same formulas, f64 roundoff only
RTOL_SOLVER = 1e-10


def _props(ncol, seed=42):
    rng = np.random.default_rng(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    frac = u(ncol, NLEV) * (u(ncol, NLEV) > 0.5)
    return dict(
        od=u(ncol, NLEV, NG, lo=1e-4, hi=2.0),
        ssa=u(ncol, NLEV, NG, lo=0.1, hi=0.999),
        g=u(ncol, NLEV, NG, lo=0.0, hi=0.8),
        od_cloud_b=u(ncol, NLEV, NBAND, lo=0.0, hi=5.0),
        ssa_cloud_b=u(ncol, NLEV, NBAND, lo=0.3, hi=0.999),
        g_cloud_b=u(ncol, NLEV, NBAND, lo=0.0, hi=0.9),
        od_scaling=u(ncol, NLEV, NG, lo=0.0, hi=2.0),
        tcc=u(ncol, lo=0.0, hi=1.0),
        cloud_fraction=frac,
        planck_hl=u(ncol, NLEV + 1, NG, lo=0.5, hi=30.0),
        emission=u(ncol, NG, hi=10.0),
        albedo=u(ncol, NG, hi=0.3),
        incoming=u(ncol, NG, hi=100.0),
        cos_sza=u(ncol, lo=-0.2, hi=1.0),        # includes night columns
        albedo_direct=u(ncol, NG, hi=0.4),
    )


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _compare(got, ref, rtol, atol):
    """Every field of the port's output against the JAX one; the JAX
    fields the port does not carry (spectral profiles) must be unset."""
    named = hasattr(ref, "_fields")
    if named:
        extra = set(ref._fields) - set(got._fields)
        assert all(getattr(ref, f) is None for f in extra), extra
    for name in (got._fields if named else list(ref)):
        b = getattr(ref, name) if named else ref[name]
        a = getattr(got, name) if named else got[name]
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=name)


def _knl(x):
    """(ncol, nlev, n) -> kernel layout (nlev, n, ncol)."""
    return jnp.transpose(jnp.asarray(x), (1, 2, 0))


@pytest.mark.parametrize("derivs", [False, True])
def test_lw_fused_plain_matches_pallas(derivs):
    p = _props(NCOL)
    mask = p["cloud_fraction"] >= 1e-6
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_mcica.lw_fused(
            _knl(p["od"]), _knl(p["od_cloud_b"]), _knl(p["ssa_cloud_b"]),
            _knl(p["g_cloud_b"]), _knl(p["od_scaling"]),
            _knl(mask[:, :, None].astype(np.float64)), _knl(p["planck_hl"]),
            jnp.asarray(p["emission"].T), jnp.asarray(p["albedo"].T),
            GCOUNTS, derivs)
    t = _t(p)
    got = cuda_mcica.lw_fused_plain(
        t["od"], t["od_cloud_b"], t["ssa_cloud_b"], t["g_cloud_b"],
        t["od_scaling"], torch.as_tensor(mask), t["planck_hl"],
        t["emission"], t["albedo"], torch.as_tensor(BAND_FROM_G), derivs)
    assert set(got) == set(ref)
    # JAX planes are (nlev|ng, ncol); the port's (ncol, nlev|ng)
    _compare(got, {k: np.asarray(v).T for k, v in ref.items()},
             RTOL_LW, ATOL)


@pytest.mark.parametrize("delta", [False, True])
def test_sw_fused_plain_matches_pallas(delta):
    p = _props(NCOL)
    mask = p["cloud_fraction"] >= 1e-6
    mu0 = np.maximum(p["cos_sza"], 1e-10)
    alb_dir_mu0 = p["albedo_direct"] * mu0[:, None]
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_mcica.sw_fused(
            _knl(p["od"]), _knl(p["ssa"]), _knl(p["g"]),
            _knl(p["od_cloud_b"]), _knl(p["ssa_cloud_b"]),
            _knl(p["g_cloud_b"]), _knl(p["od_scaling"]),
            _knl(mask[:, :, None].astype(np.float64)),
            jnp.asarray(mu0[None, :]), jnp.asarray(p["incoming"].T),
            jnp.asarray(p["albedo"].T), jnp.asarray(alb_dir_mu0.T),
            GCOUNTS, delta)
    t = _t(p)
    got = cuda_mcica.sw_fused_plain(
        t["od"], t["ssa"], t["g"], t["od_cloud_b"], t["ssa_cloud_b"],
        t["g_cloud_b"], t["od_scaling"], torch.as_tensor(mask),
        torch.as_tensor(mu0), t["incoming"], t["albedo"],
        torch.as_tensor(alb_dir_mu0), torch.as_tensor(BAND_FROM_G), delta)
    assert set(got) == set(ref)
    _compare(got, {k: np.asarray(v).T for k, v in ref.items()},
             RTOL_SW_PALLAS, ATOL_SW_PALLAS)


# The direct-albedo form is the three sweeps' function in another rounding
# order: f64 roundoff through ~20 levels, of each entry and (for entries
# that are zero to roundoff, as at night) of the field's largest value
RTOL_REORDERED = 1e-12


@pytest.mark.parametrize("delta", [False, True])
def test_sw_direct_albedo_form_matches_plain(delta):
    """The two-pass form of the kernel, on _sw_layers' coefficients,
    gives sw_fused_plain's outputs, night columns included."""
    p = _props(NCOL)
    t = _t(p)
    mask = torch.as_tensor(p["cloud_fraction"] >= 1e-6)
    mu0 = torch.clamp(t["cos_sza"], min=1e-10)
    alb_dir_mu0 = t["albedo_direct"] * mu0[:, None]
    band = torch.as_tensor(BAND_FROM_G)
    ref = cuda_mcica.sw_fused_plain(
        t["od"], t["ssa"], t["g"], t["od_cloud_b"], t["ssa_cloud_b"],
        t["g_cloud_b"], t["od_scaling"], mask, mu0, t["incoming"],
        t["albedo"], alb_dir_mu0, band, delta)
    scenes = cuda_mcica._sw_layers(
        t["od"], t["ssa"], t["g"], t["od_cloud_b"], t["ssa_cloud_b"],
        t["g_cloud_b"], t["od_scaling"], mask, mu0, band, delta)
    assert (p["cos_sza"] <= 0).any() and mask.any() and not mask.all()
    for tag, coeffs in zip(("c", "t"), scenes):
        # csrc/sw_fused.cu hands the albedos below every layer over: k=1
        got, _ = direct_albedo_sweeps(coeffs, t["incoming"], t["albedo"],
                                      alb_dir_mu0, k=1)
        for k, v in got.items():
            r = ref[f"{k}_{tag}"]
            np.testing.assert_allclose(
                v.numpy(), r.numpy(), rtol=RTOL_REORDERED,
                atol=RTOL_REORDERED * float(r.abs().max()), err_msg=k)


def _three_pass_lw(od, odc_b, ssac_b, gc_b, od_scaling, mask, planck_hl,
                   emission, albedo, band_of_g, do_derivatives):
    """The three passes of csrc/lw_fused.cu in its order, on
    _lw_layers' coefficients: clear down; up with the clear up flux, the
    total-sky Moebius sweep, the clear derivative chain from d0_c and the
    total-sky weights w from 1; total-sky down; deriv_t = sum_g d0_t w."""
    (trans_c, s_up_c, s_dn_c), (refl, trans, s_up, s_dn) = \
        cuda_mcica._lw_layers(od, odc_b, ssac_b, gc_b, od_scaling, mask,
                              planck_hl, band_of_g)
    nlev = od.shape[1]
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    d0 = lambda f: f / torch.clamp(f.sum(-1, keepdim=True),  # noqa: E731
                                   min=1e-30)
    fdn, dn_bb_c = torch.zeros_like(emission), []
    for l in range(nlev):
        fdn = trans_c[:, l] * fdn + s_dn_c[:, l]
        dn_bb_c.append(fdn.sum(-1))
    fdn_surf_c, fup_surf_c = fdn, emission + albedo * fdn
    fup, alb, src = fup_surf_c, albedo, emission
    dc, w = d0(fup_surf_c), torch.ones_like(emission)
    below, up_bb_c, deriv_c, weights = ([None] * nlev for _ in range(4))
    for l in range(nlev - 1, -1, -1):
        fup = trans_c[:, l] * fup + s_up_c[:, l]
        up_bb_c[l] = fup.sum(-1)
        below[l] = alb, src
        inv = 1.0 / (1.0 - alb * refl[:, l])
        alb, src = (refl[:, l] + trans[:, l] * trans[:, l] * alb * inv,
                    s_up[:, l] + trans[:, l] * (src + alb * s_dn[:, l])
                    * inv)
        dc, w = dc * trans_c[:, l], w * trans[:, l]
        deriv_c[l], weights[l] = dc.sum(-1), w
    fdn, dn_bb_t, up_bb_t = torch.zeros_like(emission), [], []
    for l in range(nlev):
        alb_b, src_b = below[l]
        fdn = (trans[:, l] * fdn + refl[:, l] * src_b + s_dn[:, l]) \
            / (1.0 - alb_b * refl[:, l])
        dn_bb_t.append(fdn.sum(-1))
        up_bb_t.append((alb_b * fdn + src_b).sum(-1))
    fup_surf_t = albedo * fdn + emission
    out = dict(dn_bb_c=stack(dn_bb_c), fdn_surf_c=fdn_surf_c,
               up_bb_c=stack(up_bb_c), fup_toa_c=fup, fup_surf_c=fup_surf_c,
               src_top_t=src, dn_bb_t=stack(dn_bb_t), up_bb_t=stack(up_bb_t),
               fdn_surf_t=fdn, fup_surf_t=fup_surf_t)
    if do_derivatives:
        out.update(deriv_c=stack(deriv_c),
                   deriv_t=(d0(fup_surf_t)[:, None, :]
                            * stack(weights)).sum(-1))
    return out


@pytest.mark.parametrize("derivs", [False, True])
@pytest.mark.parametrize("ncol", [1, NCOL])
def test_lw_three_pass_form_matches_plain(ncol, derivs):
    """The three-pass form of the kernel (the clear derivative carried in
    the up pass, deriv_t a sum over g of d0_t w) gives lw_fused_plain's
    outputs; column 0 has no cloudy layer."""
    p = _props(ncol)
    p["cloud_fraction"][0] = 0.0
    t = _t(p)
    mask = torch.as_tensor(p["cloud_fraction"] >= 1e-6)
    assert not mask[0].any() and (ncol == 1 or mask.any())
    args = (t["od"], t["od_cloud_b"], t["ssa_cloud_b"], t["g_cloud_b"],
            t["od_scaling"], mask, t["planck_hl"], t["emission"],
            t["albedo"], torch.as_tensor(BAND_FROM_G), derivs)
    ref = cuda_mcica.lw_fused_plain(*args)
    got = _three_pass_lw(*args)
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                   rtol=RTOL_REORDERED, atol=0, err_msg=k)


def _lw_args(p, band):
    return (p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band, p["od_scaling"], p["tcc"],
            p["cloud_fraction"], p["planck_hl"], p["emission"], p["albedo"])


@pytest.mark.parametrize("derivs", [False, True])
@pytest.mark.parametrize("ncol", [1, NCOL])
@pytest.mark.parametrize("aer_scat", [False, True])
def test_solver_mcica_lw_matches_jax(derivs, ncol, aer_scat):
    p = _props(ncol, seed=3)
    kw = dict(do_lw_cloud_scattering=True,
              do_lw_aerosol_scattering=aer_scat, do_lw_derivatives=derivs)
    ref = jmcica.solver_mcica_lw(*_lw_args(_j(p), BAND_FROM_G), **kw)
    got = tmcica.solver_mcica_lw(
        *_lw_args(_t(p), torch.as_tensor(BAND_FROM_G)), **kw)
    _compare(got, ref, RTOL_SOLVER, ATOL)


def _sw_args(p, band):
    return (p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band, p["od_scaling"], p["tcc"],
            p["cloud_fraction"], p["incoming"], p["cos_sza"], p["albedo"],
            p["albedo_direct"])


@pytest.mark.parametrize("band", ["contiguous", "shuffled"])
@pytest.mark.parametrize("delta", [False, True])
def test_solver_mcica_sw_matches_jax(band, delta):
    p = _props(NCOL, seed=5)
    bfg = BAND_FROM_G if band == "contiguous" else BAND_SHUFFLED
    kw = dict(do_sw_delta_scaling_with_gases=delta)
    ref = jmcica.solver_mcica_sw(*_sw_args(_j(p), bfg), **kw)
    got = tmcica.solver_mcica_sw(*_sw_args(_t(p), torch.as_tensor(bfg)),
                                 **kw)
    assert (p["cos_sza"] <= 0).any()
    _compare(got, ref, RTOL_SOLVER, ATOL)
