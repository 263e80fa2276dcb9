"""The port's Cloudless and Homogeneous slices against the JAX package, on
the same inputs (CPU, f64).

* ``solver_cloudless_lw`` (aerosol scattering on and off, derivatives on
  and off) and ``solver_cloudless_sw`` (delta scaling on and off, night
  columns included) against ``ecrad_tpu.solvers.cloudless``.
* The ``cloudless_rrtmg`` and ``homogeneous_rrtmg`` steps on the 32
  meridian columns against ``__graft_entry__._build`` with the same
  overrides; blocking; the committed references that chip_smoke.py holds
  the GPU to; no stochastic sample drawn.
* Setup: ``do_clouds``, ``is_homogeneous``, the cloud tables and the McICA
  PDF table as the JAX package's setup gives them, for every named
  configuration; ``radiation()`` without clouds takes the Cloudless
  solvers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from ecrad_tpu.config import Solver as JSolver
from ecrad_tpu.solvers import cloudless as jcloudless
from ecrad_torch import flagship, pipeline
from ecrad_torch.interface import radiation
from ecrad_torch.solvers import cloudless as tcloudless

torch.set_num_threads(2)

NCOL, NLEV, NG = 37, 13, 11
# port against the JAX scan path: same formulas, f64 roundoff only
RTOL_SOLVER, ATOL = 1e-10, 1e-10
# The slices: same algorithm in f64 (measured ~1.2e-10 W m-2 apart);
# dimensionless fields (derivatives, cloud cover): 1e-10
ATOL_FLUX, ATOL_DIMLESS = 1e-9, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# Blocking: the same per-column arithmetic on other batch sizes; only
# small matrix products may pick another summation order
RTOL_BLOCKED = 1e-12
# the committed files, written by the same JAX code (possibly compiled for
# another CPU)
RTOL_FILE, ATOL_FILE = 1e-12, 1e-9
DATA = os.path.join(os.path.dirname(__file__), "data")
# configuration -> (JAX nam_overrides, committed reference)
SLICES = {
    "cloudless_rrtmg": (dict(sw_solver=JSolver.CLOUDLESS,
                             lw_solver=JSolver.CLOUDLESS),
                        "torch_cloudless_meridian32.npz"),
    "homogeneous_rrtmg": (dict(sw_solver=JSolver.HOMOGENEOUS,
                               lw_solver=JSolver.HOMOGENEOUS,
                               do_lw_aerosol_scattering=True),
                          "torch_homogeneous_meridian32.npz"),
}


def _props(ncol, seed):
    rng = np.random.default_rng(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    od = u(ncol, NLEV, NG, lo=1e-5, hi=2.0)
    od[:, :2] = u(ncol, 2, NG, lo=1e-5, hi=1e-3)       # the thin branch
    cos_sza = u(ncol, lo=-0.2, hi=1.0)                  # night columns
    cos_sza[0] = -0.1
    return dict(
        od=od, ssa=u(ncol, NLEV, NG, lo=0.0, hi=0.999),
        g=u(ncol, NLEV, NG, lo=0.0, hi=0.8),
        planck_hl=u(ncol, NLEV + 1, NG, lo=0.5, hi=30.0),
        emission=u(ncol, NG, hi=10.0), albedo=u(ncol, NG, hi=0.3),
        incoming=u(ncol, NG, hi=100.0), cos_sza=cos_sza,
        albedo_direct=u(ncol, NG, hi=0.4))


def _compare(got, ref, rtol, atol):
    """Every field of the port's output against the JAX one; the JAX
    fields the port does not carry (spectral profiles) must be unset."""
    extra = set(ref._fields) - set(got._fields)
    assert all(getattr(ref, f) is None for f in extra), extra
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


# --- solvers -----------------------------------------------------------------

@pytest.mark.parametrize("derivs", [False, True])
@pytest.mark.parametrize("aer_scat", [False, True])
def test_solver_cloudless_lw_matches_jax(aer_scat, derivs):
    p = _props(NCOL, seed=3)
    names = ("od", "ssa", "g", "planck_hl", "emission", "albedo")
    kw = dict(do_lw_aerosol_scattering=aer_scat, do_lw_derivatives=derivs)
    ref = jcloudless.solver_cloudless_lw(
        *[jnp.asarray(p[n]) for n in names], **kw)
    got = tcloudless.solver_cloudless_lw(
        *[torch.as_tensor(p[n]) for n in names], **kw)
    assert (got.lw_derivatives is None) == (not derivs)
    _compare(got, ref, RTOL_SOLVER, ATOL)


@pytest.mark.parametrize("delta", [False, True])
def test_solver_cloudless_sw_matches_jax(delta):
    p = _props(NCOL, seed=5)
    names = ("od", "ssa", "g", "incoming", "cos_sza", "albedo",
             "albedo_direct")
    kw = dict(do_sw_delta_scaling_with_gases=delta)
    ref = jcloudless.solver_cloudless_sw(
        *[jnp.asarray(p[n]) for n in names], **kw)
    got = tcloudless.solver_cloudless_sw(
        *[torch.as_tensor(p[n]) for n in names], **kw)
    night = p["cos_sza"] <= 0
    assert night.any() and not bool(got.flux_up[night].any())
    _compare(got, ref, RTOL_SOLVER, ATOL)


# --- the slices ----------------------------------------------------------------

def _fields(flux):
    return {k: np.asarray(v) for k, v in flux.fields().items()}


@pytest.fixture(scope="module", params=list(SLICES))
def slice_pair(request):
    """(configuration, JAX f64 fluxes, port f64 fluxes) on the 32 meridian
    columns."""
    name = request.param
    step, args = __graft_entry__._build(ncol=32, dtype="float64",
                                        nam_overrides=SLICES[name][0])
    flux = jax.jit(step)(*args)
    ref = {k: np.asarray(getattr(flux, k))
           for k in flux.__dataclass_fields__
           if getattr(flux, k) is not None}
    tstep, targs = flagship.build(ncol=32, dtype=torch.float64,
                                  device="cpu", config_name=name)
    return name, ref, _fields(tstep(*targs))


def test_slice_matches_jax(slice_pair):
    name, ref, got = slice_pair
    assert set(got) == set(ref)
    assert len(got) == 20
    for field, r in ref.items():
        assert got[field].shape == r.shape, field
        atol = ATOL_DIMLESS if field in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got[field], r, rtol=0, atol=atol,
                                   err_msg=field)
    cover = -1.0 if name == "homogeneous_rrtmg" else 0.0
    for field in ("cloud_cover_lw", "cloud_cover_sw"):
        assert (got[field] == cover).all(), field


def test_slice_blocked_equals_unblocked(slice_pair):
    name, _, unblocked = slice_pair
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                block_size=12, config_name=name)
    blocked = _fields(step(*args))
    assert set(blocked) == set(unblocked)
    for field, ref in unblocked.items():
        np.testing.assert_allclose(blocked[field], ref, rtol=RTOL_BLOCKED,
                                   atol=0, err_msg=field)


def test_slice_reference_file_matches_jax(slice_pair):
    name, ref, _ = slice_pair
    with np.load(os.path.join(DATA, SLICES[name][1])) as z:
        files = set(z.files)
        assert {f"f64/{k}" for k in ref} <= files
        assert {f"f32/{k}" for k in ref} <= files
        for field, r in ref.items():
            np.testing.assert_allclose(z[f"f64/{field}"], r, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=field)
            assert z[f"f32/{field}"].dtype == np.float32, field


@pytest.mark.parametrize("name", list(SLICES))
def test_draws_no_sample(name):
    step, args = flagship.build(ncol=4, dtype=torch.float64, device="cpu",
                                config_name=name)
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    out = pipeline.add_cloud_sample(step.config, step.tables, cloud)
    assert set(out) == set(cloud)
    assert all(out[k] is cloud[k] for k in cloud)


# --- setup and dispatch --------------------------------------------------------

@pytest.mark.parametrize("name", list(flagship.CONFIGS))
def test_setup_flags_match_jax(name):
    """do_clouds, is_homogeneous and which cloud tables load follow the
    solvers, as in the JAX package's setup."""
    from ecrad_tpu.interface import setup_radiation as jax_setup
    from ecrad_tpu.config import Config as JConfig
    from ecrad_tpu.data import DATA_DIR
    port = flagship.flagship_config("float64", name)
    # the same Config as the JAX package's (its enums for the port's)
    kw = {f.name: getattr(port, f.name)
          for f in dataclasses.fields(JConfig)}
    kw = {k: (getattr(type(getattr(JConfig(), k)), v.name)
              if hasattr(v, "name") and hasattr(v, "value") else v)
          for k, v in kw.items()}
    jconfig, jtables = jax_setup(JConfig(**kw), data_dir=DATA_DIR)
    step, _ = flagship.build(ncol=1, dtype=torch.float64, device="cpu",
                             config_name=name)
    assert step.config.do_clouds == jconfig.do_clouds
    assert step.config.is_homogeneous == jconfig.is_homogeneous
    assert (step.tables.cloud is None) == (jtables.cloud is None)
    assert (step.tables.pdf_sampler is None) == (jtables.pdf_sampler is None)
    assert step.config.do_clouds == (
        name not in ("cloudless_rrtmg", "cloudless_rrtmg_spectral"))
    assert step.config.is_homogeneous == (
        name in ("homogeneous_rrtmg", "homogeneous_rrtmg_spectral",
                 "monochromatic_homogeneous"))
    assert (step.tables.pdf_sampler is None) == (
        name not in ("mcica_rrtmg", "ecckd_mcica", "mcica_rrtmg_spectral"))


def test_radiation_without_clouds_runs_cloudless():
    """A configuration with cloudy solvers given no cloud dict takes the
    Cloudless solvers, as the JAX package does."""
    ncol = 6
    step, args = flagship.build(ncol=ncol, dtype=torch.float64, device="cpu")
    kw = dict(zip(flagship.ARG_ORDER, args))
    kw["cloud"] = None
    got = _fields(radiation(step.config, step.tables,
                            solar_irradiance=step.solar, **kw))
    cl_step, cl_args = flagship.build(ncol=ncol, dtype=torch.float64,
                                      device="cpu",
                                      config_name="cloudless_rrtmg")
    ref = _fields(cl_step(*cl_args))
    assert set(got) == set(ref)
    for field, r in ref.items():
        np.testing.assert_allclose(got[field], r, rtol=1e-12, atol=0,
                                   err_msg=field)
