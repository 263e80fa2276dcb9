"""The port's main path end to end against the JAX package: the flagship
step (cloud generator + radiation) on the 32 bundled meridian columns,
137 levels, f64 on the CPU (where each kernel wrapper runs its plain
torch version).  Also checks that column blocking changes nothing and
that the committed JAX reference, which chip_smoke.py holds the GPU run
to, still matches what the JAX package computes."""

import os

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from ecrad_torch import flagship

torch.set_num_threads(2)

REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_flagship_meridian32.npz")
# Same algorithm in f64 (measured ~1e-10 W m-2 apart): a gap above 1e-7
# W m-2 would be a bug.  Dimensionless fields (derivatives, cloud cover):
# 1e-10.
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# Blocking runs the same per-column arithmetic on other batch sizes; only
# the small matrix products (band sums, aerosol table) may pick another
# BLAS kernel and summation order: rtol 1e-12.
RTOL_BLOCKED = 1e-12
# The committed file was written by tools/make_torch_reference.py with
# the same JAX code; XLA may compile for another CPU (vector width), so
# allow f64 roundoff: rtol 1e-12, atol 1e-9 W m-2.
RTOL_FILE, ATOL_FILE = 1e-12, 1e-9


@pytest.fixture(scope="module")
def jax_f64():
    step, args = __graft_entry__._build(ncol=32, dtype="float64")
    flux = jax.jit(step)(*args)
    return {k: np.asarray(getattr(flux, k))
            for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def port_f64():
    step, args = flagship.build(ncol=32, dtype=torch.float64)
    return {k: v.numpy() for k, v in step(*args).fields().items()}


def test_flagship_matches_jax(jax_f64, port_f64):
    assert set(port_f64) == set(jax_f64)
    assert len(port_f64) == 20
    for name, ref in jax_f64.items():
        got = port_f64[name]
        assert got.shape == ref.shape, name
        atol = ATOL_DIMLESS if name in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                   err_msg=name)


def test_blocked_equals_unblocked(port_f64):
    step, args = flagship.build(ncol=32, dtype=torch.float64, block_size=12)
    blocked = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(blocked) == set(port_f64)
    for name, ref in port_f64.items():
        np.testing.assert_allclose(blocked[name], ref, rtol=RTOL_BLOCKED,
                                   atol=0, err_msg=name)


def test_reference_file_matches_jax(jax_f64):
    with np.load(REFERENCE) as z:
        files = set(z.files)
        assert {f"f64/{k}" for k in jax_f64} <= files
        assert {f"f32/{k}" for k in jax_f64} <= files
        for name, ref in jax_f64.items():
            np.testing.assert_allclose(z[f"f64/{name}"], ref, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=name)
        for k in ("od_scaling_sw", "od_scaling_lw"):
            sample = z[f"f32_sample/{k}"]
            assert sample.dtype == np.float32 and sample.shape[:2] == (32, 137)
