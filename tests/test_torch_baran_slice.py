"""The port's ``tripleclouds_baran2016`` configuration end to end against
the JAX package (CPU, f64): the flagship with Tripleclouds SW and LW,
Slingo liquid (Slingo SW, Lindner-Li LW) and Baran2016 ice, on the 32
bundled meridian columns, 137 levels.

* The port's Config against the overrides of
  ``tools/make_torch_reference.py`` OUTPUTS.
* The step against ``__graft_entry__._build`` with those overrides: within
  1e-7 W m-2 for fluxes (measured ~1.2e-10), 1e-10 for the LW derivatives
  and cloud cover.
* Blocking changes nothing; the committed reference that chip_smoke.py
  holds the GPU to still matches the JAX package; no stochastic sample is
  drawn; the cloud optics differ from SOCRATES/Fu's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from ecrad_tpu import config as jconfig
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, pipeline
from tools.make_torch_reference import ENUM_FIELDS, OUTPUTS

torch.set_num_threads(2)

NAME = "tripleclouds_baran2016"
DATA = os.path.join(os.path.dirname(__file__), "data")
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
RTOL_BLOCKED = 1e-12
# the committed file, written by the same JAX code (possibly compiled for
# another CPU)
RTOL_FILE, ATOL_FILE = 1e-12, 1e-9


def _jax_overrides():
    """The reference's overrides as JAX Config fields."""
    from tools.bench_matrix import _resolve
    return _resolve({k: getattr(jconfig, ENUM_FIELDS[k])[v]
                     if k in ENUM_FIELDS else v
                     for k, v in OUTPUTS[NAME][0].items()})


@pytest.fixture(scope="module")
def jax_f64():
    step, args = __graft_entry__._build(ncol=32, dtype="float64",
                                        nam_overrides=_jax_overrides())
    flux = jax.jit(step)(*args)
    return {k: np.asarray(getattr(flux, k)) for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def port_f64():
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name=NAME)
    return {k: v.numpy() for k, v in step(*args).fields().items()}


def test_config_matches_reference_overrides():
    port = flagship.flagship_config("float64", NAME)
    assert port.liquid_model == tconfig.LiquidModel.SLINGO
    assert port.ice_model == tconfig.IceModel.BARAN2016
    over = _jax_overrides()
    base = flagship.flagship_config("float64")
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), over.get(f.name,
                                               getattr(base, f.name))
        if hasattr(b, "name"):
            a, b = a.name, b.name
        assert a == b, f.name


def test_slice_matches_jax(jax_f64, port_f64):
    assert set(port_f64) == set(jax_f64) and len(port_f64) == 20
    for k, ref in jax_f64.items():
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(port_f64[k], ref, rtol=0, atol=atol,
                                   err_msg=k)


def test_blocked_equals_unblocked(port_f64):
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                block_size=12, config_name=NAME)
    blocked = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(blocked) == set(port_f64)
    for k, ref in port_f64.items():
        np.testing.assert_allclose(blocked[k], ref, rtol=RTOL_BLOCKED,
                                   atol=0, err_msg=k)


def test_reference_file_matches_jax(jax_f64):
    with np.load(os.path.join(DATA, OUTPUTS[NAME][1])) as z:
        files = set(z.files)
        assert {f"f64/{k}" for k in jax_f64} <= files
        assert {f"f32/{k}" for k in jax_f64} <= files
        assert not any(k.startswith("f32_sample/") for k in files)
        for k, ref in jax_f64.items():
            np.testing.assert_allclose(z[f"f64/{k}"], ref, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32, k


def test_draws_no_sample_and_differs_from_socrates_fu(port_f64):
    step, args = flagship.build(ncol=4, dtype=torch.float64, device="cpu",
                                config_name=NAME)
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    out = pipeline.add_cloud_sample(step.config, step.tables, cloud)
    assert set(out) == set(cloud)
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name="tripleclouds_rrtmg")
    fu = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert np.abs(port_f64["sw_up"] - fu["sw_up"]).max() > 1.0
    np.testing.assert_allclose(port_f64["sw_up_clear"], fu["sw_up_clear"],
                               rtol=1e-12)
