"""The port's bounds checks (ecrad_torch/check.py) against the JAX
package's (ecrad_tpu/check.py) on the same corrupted inputs: the same
flags, the same repaired arrays and the same messages."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from ecrad_tpu import check as jcheck
from ecrad_tpu.io.input import read_input as jax_read_input
from ecrad_torch import check as pcheck
from ecrad_torch.containers import Flux
from ecrad_torch.data import MERIDIAN_INPUT
from ecrad_torch.io.input import read_input

# field -> (row, column) of the corrupted value and the value
CORRUPTIONS = {
    "temperature_hl": ((0, 5), 450.0),
    "cos_sza": ((1,), 1.5),
    "skin_temperature": ((2,), np.nan),
    "sw_albedo": ((0, 1), -0.2),
    "gas_mmr": ((1, 3, 0), 1.5),
    "cloud_fraction": ((2, 60), 1.2),
    "cloud_effective_radius": ((0, 70, 1), 0.5),
    "overlap_param": ((3, 10), -0.9),
    "aerosol_mmr": ((1, 100, 2), np.inf),
    "fractional_std": ((0, 0), -1.0),
}


def _corrupt(inp, fields):
    rep = {}
    for field in fields:
        idx, value = CORRUPTIONS[field]
        if field == "temperature_hl":
            t = inp.thermodynamics.temperature_hl.copy()
            t[idx] = value
            rep["thermodynamics"] = dataclasses.replace(
                inp.thermodynamics, temperature_hl=t)
            continue
        a = getattr(inp, field).copy()
        a[idx] = value
        rep[field] = a
    return dataclasses.replace(inp, **rep)


def _inputs(fields):
    return (_corrupt(read_input(MERIDIAN_INPUT), fields),
            _corrupt(jax_read_input(MERIDIAN_INPUT), fields))


@pytest.mark.parametrize("do_fix", [False, True])
@pytest.mark.parametrize("fields", [(), tuple(CORRUPTIONS)[:5],
                                    tuple(CORRUPTIONS)[5:]],
                         ids=["clean", "first", "second"])
def test_check_inputs(do_fix, fields):
    port_inp, jax_inp = _inputs(fields)
    out_p, out_j = io.StringIO(), io.StringIO()
    bad_p, fixed_p = pcheck.check_inputs(port_inp, do_fix, out_p)
    bad_j, fixed_j = jcheck.check_inputs(jax_inp, do_fix, out_j)
    assert bad_p == bad_j == bool(fields)
    assert out_p.getvalue() == out_j.getvalue()
    for f in dataclasses.fields(fixed_j):
        a, b = getattr(fixed_p, f.name), getattr(fixed_j, f.name)
        if f.name == "thermodynamics":
            a, b = a.temperature_hl, b.temperature_hl
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    if do_fix and fields:
        assert np.isfinite(fixed_p.aerosol_mmr).all()
    # the input is left as it was
    if "cos_sza" in fields:
        assert port_inp.cos_sza[1] == 1.5


@pytest.mark.parametrize("do_fix", [False, True])
def test_out_of_bounds(do_fix):
    a = np.array([[0.5, -2.0], [np.nan, 3.0]])
    out_p, out_j = io.StringIO(), io.StringIO()
    bad_p, fixed_p = pcheck.out_of_bounds(a, "x", 0.0, 1.0, do_fix, out_p)
    bad_j, fixed_j = jcheck.out_of_bounds(a, "x", 0.0, 1.0, do_fix, out_j)
    assert bad_p and bad_j
    np.testing.assert_array_equal(fixed_p, fixed_j)
    assert out_p.getvalue() == out_j.getvalue() != ""


@pytest.mark.parametrize("case", ["good", "non_finite", "heating",
                                  "surface_first"])
def test_check_fluxes(case):
    rng = np.random.default_rng(4)
    ncol, nhl = 3, 9
    phl = np.linspace(100.0, 1.0e5, nhl)[None, :] * np.ones((ncol, 1))
    base = np.linspace(200.0, 300.0, nhl)[None, :] * np.ones((ncol, 1))
    # SW absorbed on the way down, LW net flux constant: heating in bounds
    fields = {"sw_up": 0.2 * base, "sw_dn": base[:, ::-1] + 0.0,
              "lw_up": base + 50.0,
              "lw_dn": base - 100.0 + rng.uniform(0, 1, (ncol, nhl))}
    if case == "non_finite":
        fields["lw_up"][1, 4] = np.nan
    elif case == "heating":
        fields["sw_dn"][0, 3] += 400.0
    elif case == "surface_first":
        fields = {k: v[:, ::-1].copy() for k, v in fields.items()}
        phl = phl[:, ::-1].copy()
    out_p, out_j = io.StringIO(), io.StringIO()
    port = Flux(**{k: torch.as_tensor(v) for k, v in fields.items()})
    bad_p = pcheck.check_fluxes(port, torch.as_tensor(phl), out_p)

    class JaxFlux:
        pass

    jax_flux = JaxFlux()
    for k, v in fields.items():
        setattr(jax_flux, k, v)
    bad_j = jcheck.check_fluxes(jax_flux, phl, out_j)
    assert bad_p == bad_j == (case in ("non_finite", "heating"))
    assert out_p.getvalue() == out_j.getvalue()
