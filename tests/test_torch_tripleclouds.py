"""The port's Tripleclouds slice against the JAX package, on the same
inputs (CPU, f64).

* ``calc_region_properties``/``calc_overlap_matrices`` against JAX.
* ``lw_fused_plain``/``sw_fused_plain`` against the Pallas kernels
  ``pallas_tripleclouds.lw_fused``/``sw_fused`` in interpret mode, on the
  same planes (the port's layout transposed to the kernel layout).
* ``solver_tripleclouds_lw``/``sw`` against the JAX package's scan path:
  the fused gate taken (plain version on the CPU) and the scan form
  (two regions, a g axis that is not band-contiguous, LW aerosol
  scattering, LW without cloud scattering), gamma and lognormal PDFs, night
  columns, odd column counts, and columns with cloud only in the top
  layer, only in the bottom layer, and none.
* The whole ``tripleclouds_rrtmg`` step on the 32 meridian columns against
  ``__graft_entry__._build`` with the same overrides; blocking; the
  committed reference that chip_smoke.py holds the GPU to; no stochastic
  sample drawn; Tripleclouds mixed with McICA.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__
from ecrad_tpu import config as jconfig
from ecrad_tpu.solvers import pallas_tripleclouds
from ecrad_tpu.solvers import tripleclouds as jtc
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, pipeline
from ecrad_torch.solvers import cuda_tripleclouds
from ecrad_torch.solvers import tripleclouds as ttc

torch.set_num_threads(2)

NCOL, NLEV = 19, 11
NBAND = 5
GCOUNTS = (3, 2, 4, 2, 3)          # ng = 14, band-contiguous
NG = sum(GCOUNTS)
BAND_FROM_G = np.repeat(np.arange(NBAND), GCOUNTS)
# a g axis that is not band-contiguous: both packages take the scan form
BAND_SHUFFLED = np.random.default_rng(7).permutation(BAND_FROM_G)

# f64 roundoff through ~10-level recurrences, the same terms summed in
# another order: the plain LW version against the interpret-mode kernel
RTOL_LW, ATOL = 1e-11, 1e-10
# the Pallas SW kernel uses a cubic series for 1 - exp(-2 k od) below
# x = 0.01 (rel. error < x^3/24 ~ 5e-8); the port uses expm1, as does the
# JAX scan path
RTOL_SW_PALLAS, ATOL_SW_PALLAS = 5e-8, 1e-8
# port against the JAX scan path: same formulas, f64 roundoff only
RTOL_SOLVER = 1e-10
# region properties and overlap matrices: elementwise, f64 roundoff
RTOL_PREP = 1e-13

REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_tripleclouds_meridian32.npz")
# The slice: same algorithm in f64 (measured ~1e-10 W m-2 apart); a gap
# above 1e-7 W m-2 would be a bug.  Dimensionless fields: 1e-10.
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# Blocking: the same per-column arithmetic on other batch sizes; only
# small matrix products may pick another summation order
RTOL_BLOCKED = 1e-12
# the committed file, written by the same JAX code (possibly compiled for
# another CPU)
RTOL_FILE, ATOL_FILE = 1e-12, 1e-9
TC_OVERRIDES = dict(sw_solver_name="Tripleclouds",
                    lw_solver_name="Tripleclouds")


def _props(ncol, seed=42):
    """Random inputs, with the edge columns first: cloud only in the top
    layer, only in the bottom layer, none, and a layer with a cloud
    fraction above 0 but below the threshold."""
    rng = np.random.default_rng(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    frac = u(ncol, NLEV) * (u(ncol, NLEV) > 0.4)
    edges = np.zeros((4, NLEV))
    edges[0, 0] = 0.6
    edges[1, -1] = 0.7
    edges[3, 2], edges[3, 5] = 1e-9, 0.3
    n = min(4, ncol)
    frac[:n] = edges[:n]
    cos_sza = u(ncol, lo=-0.2, hi=1.0)              # night columns
    cos_sza[0] = -0.1
    return dict(
        od=u(ncol, NLEV, NG, lo=1e-4, hi=2.0),
        ssa=u(ncol, NLEV, NG, lo=0.1, hi=0.999),
        g=u(ncol, NLEV, NG, lo=0.0, hi=0.8),
        od_cloud_b=u(ncol, NLEV, NBAND, lo=0.0, hi=5.0),
        ssa_cloud_b=u(ncol, NLEV, NBAND, lo=0.3, hi=0.999),
        g_cloud_b=u(ncol, NLEV, NBAND, lo=0.0, hi=0.9),
        cloud_fraction=frac,
        fractional_std=u(ncol, NLEV, lo=0.0, hi=2.5),
        overlap_param=u(ncol, NLEV - 1, lo=-0.1, hi=1.0),
        planck_hl=u(ncol, NLEV + 1, NG, lo=0.5, hi=30.0),
        emission=u(ncol, NG, hi=10.0),
        albedo=u(ncol, NG, hi=0.3),
        incoming=u(ncol, NG, hi=100.0),
        cos_sza=cos_sza,
        albedo_direct=u(ncol, NG, hi=0.4),
    )


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _configs(pdf="GAMMA", **kw):
    """The same settings as a port Config and a JAX Config."""
    port = tconfig.Config(cloud_pdf_shape=tconfig.PdfShape[pdf], **kw)
    jax_cfg = jconfig.Config(cloud_pdf_shape=jconfig.PdfShape[pdf], **kw)
    return port, jax_cfg


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


# --- region properties and overlap matrices ---------------------------------

@pytest.mark.parametrize("pdf,n_regions", [("GAMMA", 3), ("LOGNORMAL", 3),
                                           ("GAMMA", 2)])
def test_regions_and_overlap_match_jax(pdf, n_regions):
    p = _props(NCOL, seed=11)
    gamma = pdf == "GAMMA"
    ref = jtc.calc_region_properties(
        jnp.asarray(p["cloud_fraction"]), jnp.asarray(p["fractional_std"]),
        gamma, 1e-6, n_regions=n_regions)
    got = ttc.calc_region_properties(
        torch.as_tensor(p["cloud_fraction"]),
        torch.as_tensor(p["fractional_std"]), gamma, 1e-6,
        n_regions=n_regions)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL_PREP, atol=0)
    ref_m = jtc.calc_overlap_matrices(ref[0], jnp.asarray(p["overlap_param"]),
                                      0.5, 1e-6)
    got_m = ttc.calc_overlap_matrices(
        got[0], torch.as_tensor(p["overlap_param"]), 0.5, 1e-6)
    assert got_m[0].shape == (NCOL, NLEV + 1, 3, 3)
    for a, b in zip(got_m, ref_m):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL_PREP, atol=1e-15)


# --- plain kernel versions against the interpret-mode Pallas kernels ------

def _knl(x):
    """The port's (ncol, ...) layout -> the kernel layout (..., ncol)."""
    return jnp.asarray(np.moveaxis(np.asarray(x), 0, -1))


def _knl_mask(clear):
    """(ncol, nlev) bool -> (nlev, 1, ncol) 0/1 and the padded clear flags
    (nlev+2, 1, ncol) with virtual clear layers at TOA and the surface."""
    c = np.asarray(clear)
    pad = np.pad(c, ((0, 0), (1, 1)), constant_values=True)
    return (_knl(c[..., None].astype(np.float64)),
            _knl(pad[..., None].astype(np.float64)))


def _from_knl(ref):
    return {k: np.moveaxis(np.asarray(v), -1, 0) for k, v in ref.items()}


@pytest.mark.parametrize("derivs", [False, True])
def test_lw_fused_plain_matches_pallas(derivs):
    p = _t(_props(NCOL))
    cfg, _ = _configs(do_lw_derivatives=derivs,
                      do_lw_aerosol_scattering=False)
    args, _ = ttc.lw_fused_args(
        cfg, p["od"], p["od_cloud_b"], p["ssa_cloud_b"], p["g_cloud_b"],
        torch.as_tensor(BAND_FROM_G), p["cloud_fraction"],
        p["fractional_std"], p["overlap_param"], p["planck_hl"],
        p["emission"], p["albedo"])
    (od, odc, ssac, gc, scal2, clear, rf3, u9, v9, planck, emission, albedo,
     src0, band, d) = args
    clear_m, cc_pad = _knl_mask(clear)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_tripleclouds.lw_fused(
            _knl(od), _knl(odc), _knl(ssac), _knl(gc), _knl(scal2), clear_m,
            _knl(rf3), _knl(u9), _knl(v9), cc_pad, _knl(planck),
            _knl(emission), _knl(albedo), _knl(src0), GCOUNTS, derivs)
    got = cuda_tripleclouds.lw_fused_plain(*args)
    assert set(got) == set(ref)
    _compare(got, _from_knl(ref), RTOL_LW, ATOL)


@pytest.mark.parametrize("delta", [False, True])
def test_sw_fused_plain_matches_pallas(delta):
    p = _t(_props(NCOL))
    cfg, _ = _configs(do_sw_delta_scaling_with_gases=delta)
    args, _ = ttc.sw_fused_args(
        cfg, p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
        p["g_cloud_b"], torch.as_tensor(BAND_FROM_G), p["cloud_fraction"],
        p["fractional_std"], p["overlap_param"], p["incoming"],
        p["cos_sza"], p["albedo"], p["albedo_direct"])
    (od, ssa, g, odc, ssac, gc, scal2, clear, v9, mu0, incoming, fdir0,
     alb0_c, albd0_c, alb0_t, albd0_t, band, dl) = args
    clear_m, cc_pad = _knl_mask(clear)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_tripleclouds.sw_fused(
            _knl(od), _knl(ssa), _knl(g), _knl(odc), _knl(ssac), _knl(gc),
            _knl(scal2), clear_m, _knl(v9), cc_pad,
            jnp.asarray(mu0.numpy()[None, :]), _knl(incoming), _knl(fdir0),
            _knl(alb0_c), _knl(albd0_c), _knl(alb0_t), _knl(albd0_t),
            GCOUNTS, delta)
    got = cuda_tripleclouds.sw_fused_plain(*args)
    assert set(got) == set(ref)
    _compare(got, _from_knl(ref), RTOL_SW_PALLAS, ATOL_SW_PALLAS)


# --- solvers against the JAX scan path --------------------------------------

# (config settings, band order, whether the port takes its fused path)
LW_CASES = {
    "fused": (dict(do_lw_derivatives=True), "contiguous", True),
    "fused_no_derivs": (dict(), "contiguous", True),
    "lognormal": (dict(pdf="LOGNORMAL", do_lw_derivatives=True),
                  "contiguous", True),
    "nregions2": (dict(nregions=2, do_lw_derivatives=True), "contiguous",
                  False),
    "shuffled": (dict(do_lw_derivatives=True), "shuffled", False),
    "aerosol_scattering": (dict(do_lw_aerosol_scattering=True,
                                do_lw_derivatives=True), "contiguous",
                           False),
    "no_cloud_scattering": (dict(do_lw_cloud_scattering=False),
                            "contiguous", False),
}


def _lw_args(p, band):
    return (p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band, p["cloud_fraction"], p["fractional_std"],
            p["overlap_param"], p["planck_hl"], p["emission"], p["albedo"])


@pytest.mark.parametrize("ncol", [1, NCOL])
@pytest.mark.parametrize("case", list(LW_CASES))
def test_solver_tripleclouds_lw_matches_jax(case, ncol):
    kw, band, fused = LW_CASES[case]
    kw = dict(kw)
    kw.setdefault("do_lw_aerosol_scattering", False)
    cfg, jcfg = _configs(**kw)
    bfg = BAND_FROM_G if band == "contiguous" else BAND_SHUFFLED
    assert ttc._use_fused_lw(cfg, torch.as_tensor(bfg)) == fused
    p = _props(ncol, seed=3)
    ref = jtc.solver_tripleclouds_lw(jcfg, *_lw_args(_j(p), bfg))
    got = ttc.solver_tripleclouds_lw(cfg, *_lw_args(_t(p),
                                                    torch.as_tensor(bfg)))
    _compare(got, ref, RTOL_SOLVER, ATOL)


SW_CASES = {
    "fused": (dict(), "contiguous", True),
    "delta": (dict(do_sw_delta_scaling_with_gases=True), "contiguous",
              True),
    "lognormal": (dict(pdf="LOGNORMAL"), "contiguous", True),
    "nregions2": (dict(nregions=2), "contiguous", False),
    "shuffled": (dict(do_sw_delta_scaling_with_gases=True), "shuffled",
                 False),
}


def _sw_args(p, band):
    return (p["od"], p["ssa"], p["g"], p["od_cloud_b"], p["ssa_cloud_b"],
            p["g_cloud_b"], band, p["cloud_fraction"], p["fractional_std"],
            p["overlap_param"], p["incoming"], p["cos_sza"], p["albedo"],
            p["albedo_direct"])


@pytest.mark.parametrize("ncol", [1, NCOL])
@pytest.mark.parametrize("case", list(SW_CASES))
def test_solver_tripleclouds_sw_matches_jax(case, ncol):
    kw, band, fused = SW_CASES[case]
    cfg, jcfg = _configs(**kw)
    bfg = BAND_FROM_G if band == "contiguous" else BAND_SHUFFLED
    assert ttc._use_fused(cfg, torch.as_tensor(bfg)) == fused
    p = _props(ncol, seed=5)
    ref = jtc.solver_tripleclouds_sw(jcfg, *_sw_args(_j(p), bfg))
    got = ttc.solver_tripleclouds_sw(cfg, *_sw_args(_t(p),
                                                    torch.as_tensor(bfg)))
    assert (p["cos_sza"] <= 0).any()
    _compare(got, ref, RTOL_SOLVER, ATOL)


# --- the slice ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f64():
    from tools.bench_matrix import _resolve
    step, args = __graft_entry__._build(
        ncol=32, dtype="float64", nam_overrides=_resolve(TC_OVERRIDES))
    flux = jax.jit(step)(*args)
    return {k: np.asarray(getattr(flux, k))
            for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def port_f64():
    step, args = flagship.build(ncol=32, dtype=torch.float64,
                                config_name="tripleclouds_rrtmg")
    return {k: v.numpy() for k, v in step(*args).fields().items()}


def test_tripleclouds_config_matches_jax():
    from tools.bench_matrix import _resolve
    port = flagship.flagship_config("float64", "tripleclouds_rrtmg")
    assert port.sw_solver == port.lw_solver == tconfig.Solver.TRIPLECLOUDS
    assert flagship.flagship_config("float64").sw_solver \
        == tconfig.Solver.MCICA
    over = _resolve(TC_OVERRIDES)
    for f in dataclasses.fields(port):
        a = getattr(port, f.name)
        b = over.get(f.name, getattr(flagship.flagship_config("float64"),
                                     f.name))
        if hasattr(b, "name"):
            a, b = a.name, b.name
        assert a == b, f.name


def test_tripleclouds_slice_matches_jax(jax_f64, port_f64):
    assert set(port_f64) == set(jax_f64)
    assert len(port_f64) == 20
    for name, ref in jax_f64.items():
        got = port_f64[name]
        assert got.shape == ref.shape, name
        atol = ATOL_DIMLESS if name in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)


def test_tripleclouds_blocked_equals_unblocked(port_f64):
    step, args = flagship.build(ncol=32, dtype=torch.float64, block_size=12,
                                config_name="tripleclouds_rrtmg")
    blocked = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(blocked) == set(port_f64)
    for name, ref in port_f64.items():
        np.testing.assert_allclose(blocked[name], ref, rtol=RTOL_BLOCKED,
                                   atol=0, err_msg=name)


def test_tripleclouds_reference_file_matches_jax(jax_f64):
    with np.load(REFERENCE) as z:
        files = set(z.files)
        assert {f"f64/{k}" for k in jax_f64} <= files
        assert {f"f32/{k}" for k in jax_f64} <= files
        for name, ref in jax_f64.items():
            np.testing.assert_allclose(z[f"f64/{name}"], ref, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=name)
            assert z[f"f32/{name}"].dtype == np.float32, name


def test_tripleclouds_draws_no_sample():
    step, args = flagship.build(ncol=4, dtype=torch.float64,
                                config_name="tripleclouds_rrtmg")
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    out = pipeline.add_cloud_sample(step.config, step.tables, cloud)
    assert set(out) == set(cloud)
    assert all(out[k] is cloud[k] for k in cloud)


def test_tripleclouds_mixed_with_mcica():
    """Tripleclouds SW with McICA LW gives each solver's own fields."""
    ncol = 8

    def run(**over):
        step, args = flagship.build(ncol=ncol, dtype=torch.float64,
                                    config_name="tripleclouds_rrtmg")
        cfg = step.config.replace(**over)
        kw = dict(zip(flagship.ARG_ORDER, args))
        return pipeline.radiation_step(cfg, step.tables,
                                       solar_irradiance=step.solar,
                                       **kw).fields()

    mixed = run(lw_solver=tconfig.Solver.MCICA)
    tc = run()
    mc = run(sw_solver=tconfig.Solver.MCICA, lw_solver=tconfig.Solver.MCICA)
    for name, v in mixed.items():
        ref = tc[name] if name.startswith(("sw_", "cloud_cover_sw")) \
            else mc[name]
        assert torch.equal(v, ref), name
