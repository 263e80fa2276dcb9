"""The port's ``spartacus_3d`` step against the JAX package (CPU): the
``tools/bench_matrix.py`` configuration (SPARTACUS SW and LW, 3D effects,
Explicit entrapment, LW side emissivity, no SW delta scaling with gases)
on the 32 bundled meridian columns, 137 levels.

* The port's Config against the JAX overrides.
* The float64 step against ``__graft_entry__._build`` with the same
  overrides, compiled once for the module: within 1e-8 W m-2 for fluxes,
  1e-10 for the LW derivatives and cloud cover (the dimensionless fields).
* Blocking changes nothing; the committed reference that chip_smoke.py
  holds the GPU to still matches the JAX package.
* The float32 step against the JAX float64 fluxes.
* With 3D effects off, Zero entrapment and no optical-depth cap,
  SPARTACUS gives the port's Tripleclouds fluxes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, pipeline

torch.set_num_threads(2)

OVERRIDES = dict(sw_solver_name="SPARTACUS", lw_solver_name="SPARTACUS",
                 do_3d_effects=True, do_sw_delta_scaling_with_gases=False)
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_spartacus_meridian32.npz")
# Same algorithm in f64.  The LW sources come from two solves with the 6x6
# generator, near singular in optically thin regions, so roundoff grows to
# a few 1e-9 W m-2 (6.9e-9 in lw_dn on the CPU): 1e-8 W m-2.
# Dimensionless fields: 1e-10.
ATOL_FLUX, ATOL_DIMLESS = 1e-8, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
RTOL_BLOCKED = 1e-12
# The committed file, written by the same JAX code (possibly compiled for
# another CPU): f64 roundoff on top of the slice's own
RTOL_FILE, ATOL_FILE = 1e-12, 1e-8
# float32 against the JAX float64 fluxes: ecRad's single-precision bar,
# 0.5 W m-2 (0.056 W m-2 in sw_dn on the CPU).  The LW 3D layer matrices
# are computed in float64 in a float32 run too, so LW fluxes are held to
# 0.01 W m-2 (5e-4 on the CPU; the JAX float32 run on the CPU is 8 W m-2
# from its float64 run in lw_dn).
ATOL_F32, ATOL_F32_LW = 0.5, 0.01
# SPARTACUS without 3D effects against Tripleclouds, as
# tests/test_spartacus.py holds the JAX pair: SW to roundoff where the two
# share every formula (clear sky), to ~1e-3 W m-2 with clouds; LW to 5e-3
# W m-2 (SPARTACUS takes the scattering-form clear-sky transmittance,
# Tripleclouds the no-scattering one).
TC_ATOL = {"lw_": 5e-3, "sw_up_clear": 1e-5, "sw_dn_clear": 1e-5,
           "sw_dn_direct_clear": 1e-5, "sw_": 2e-3, "cloud_cover": 1e-12}


def _resolved():
    from tools.bench_matrix import _resolve
    return _resolve(OVERRIDES)


@pytest.fixture(scope="module")
def jax_f64():
    step, args = __graft_entry__._build(ncol=32, dtype="float64",
                                        nam_overrides=_resolved())
    flux = jax.jit(step)(*args)
    return {k: np.asarray(getattr(flux, k))
            for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def port_f64():
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name="spartacus_3d")
    return {k: v.numpy() for k, v in step(*args).fields().items()}


def test_spartacus_config_matches_jax():
    port = flagship.flagship_config("float64", "spartacus_3d")
    assert port.sw_solver == port.lw_solver == tconfig.Solver.SPARTACUS
    assert port.sw_entrapment == tconfig.Entrapment.EXPLICIT
    assert port.do_lw_side_emissivity and port.nregions == 3
    over = _resolved()
    for f in dataclasses.fields(port):
        a = getattr(port, f.name)
        b = over.get(f.name, getattr(flagship.flagship_config("float64"),
                                     f.name))
        if hasattr(b, "name"):
            a, b = a.name, b.name
        assert a == b, f.name


def test_spartacus_slice_matches_jax(jax_f64, port_f64):
    assert set(port_f64) == set(jax_f64)
    assert len(port_f64) == 20
    for name, ref in jax_f64.items():
        got = port_f64[name]
        assert got.shape == ref.shape, name
        atol = ATOL_DIMLESS if name in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)


def test_spartacus_reference_file_matches_jax(jax_f64):
    with np.load(REFERENCE) as z:
        files = set(z.files)
        assert {f"f64/{k}" for k in jax_f64} <= files
        assert {f"f32/{k}" for k in jax_f64} <= files
        for name, ref in jax_f64.items():
            np.testing.assert_allclose(z[f"f64/{name}"], ref, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=name)
            assert z[f"f32/{name}"].dtype == np.float32, name


def test_spartacus_blocked_equals_unblocked(port_f64):
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                block_size=12, config_name="spartacus_3d")
    blocked = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(blocked) == set(port_f64)
    for name, ref in port_f64.items():
        np.testing.assert_allclose(blocked[name], ref, rtol=RTOL_BLOCKED,
                                   atol=1e-12, err_msg=name)


def test_spartacus_f32_slice_near_f64():
    step, args = flagship.build(ncol=32, dtype=torch.float32, device="cpu",
                                config_name="spartacus_3d")
    got = step(*args).fields()
    with np.load(REFERENCE) as z:
        for name, v in got.items():
            assert v.dtype == torch.float32, name
            ref = z[f"f64/{name}"]
            atol = (1e-4 if name in DIMLESS else
                    ATOL_F32_LW if name.startswith("lw_") else ATOL_F32)
            np.testing.assert_allclose(v.double().numpy(), ref, rtol=0,
                                       atol=atol, err_msg=name)


def test_spartacus_no_3d_zero_entrapment_is_tripleclouds():
    ncol = 8
    step, args = flagship.build(ncol=ncol, dtype=torch.float64,
                                device="cpu", config_name="spartacus_3d")
    kw = dict(zip(flagship.ARG_ORDER, args))
    sp = step.config.replace(do_3d_effects=False,
                             sw_entrapment=tconfig.Entrapment.ZERO,
                             max_cloud_od=1.0e6)
    tc = step.config.replace(sw_solver=tconfig.Solver.TRIPLECLOUDS,
                             lw_solver=tconfig.Solver.TRIPLECLOUDS)

    def run(cfg):
        return pipeline.radiation_step(cfg, step.tables,
                                       solar_irradiance=step.solar,
                                       **kw).fields()

    got, ref = run(sp), run(tc)
    for name in ("lw_up", "lw_dn", "lw_up_clear", "lw_dn_clear", "sw_up",
                 "sw_dn", "sw_dn_direct", "sw_up_clear", "sw_dn_clear",
                 "sw_dn_direct_clear", "cloud_cover_sw", "cloud_cover_lw"):
        atol = next(v for k, v in TC_ATOL.items() if name.startswith(k))
        err = float((got[name] - ref[name]).abs().max())
        assert err < atol, (name, err)
