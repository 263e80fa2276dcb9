"""The port's gas container (ecrad_torch/gas.py) against the JAX
package's (ecrad_tpu/gas.py) on the same seeded mixing ratios: every unit
pair, well-mixed gases, scaling, reversal and the bounds check give the
same values (rtol 1e-14, float64) and the same errors."""

import numpy as np
import pytest
import torch

from ecrad_tpu import gas as jgas
from ecrad_torch import constants
from ecrad_torch import gas as pgas

NCOL, NLEV = 3, 7
RTOL = 1e-14
GASES = ("h2o", "co2", "o3", "ch4")


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return {g: rng.uniform(1e-7, 1e-2, (NCOL, NLEV)) for g in GASES}


def _both(units, scale_factor=1.0, seed=0):
    """The same gases put into both containers."""
    j = jgas.Gas.allocate(NCOL, NLEV, np.float64)
    p = pgas.Gas.allocate(NCOL, NLEV, torch.float64)
    for g, v in _fields(seed).items():
        j = j.put(g, units, v, scale_factor)
        p = p.put(g, units, torch.as_tensor(v), scale_factor)
    return j, p


def _same(p_arr, j_arr):
    np.testing.assert_allclose(p_arr.numpy(), np.asarray(j_arr), rtol=RTOL,
                               atol=0.0)


def _same_gas(p, j):
    _same(p.mixing_ratio, j.mixing_ratio)
    assert p.units == j.units
    assert p.scale_factor == pytest.approx(j.scale_factor, rel=RTOL)
    assert p.well_mixed == j.well_mixed


@pytest.mark.parametrize("from_units", ["mmr", "vmr"])
@pytest.mark.parametrize("to_units", ["mmr", "vmr"])
def test_unit_pairs(from_units, to_units):
    j, p = _both(from_units)
    _same_gas(p.set_units(to_units), j.set_units(to_units))
    for g in GASES:
        _same(p.get(g, to_units), j.get(g, to_units))
        _same(p.get(g, to_units, 1e-6), j.get(g, to_units, 1e-6))
    _same(p.to_mmr(), j.to_mmr())


def test_scale_factor_and_scale():
    j, p = _both("vmr", scale_factor=1e-6)       # stored in ppmv
    j, p = j.scale("co2", 2.0), p.scale("co2", 2.0)
    assert j.scale("n2o", 3.0) is j and p.scale("n2o", 3.0) is p
    _same_gas(p, j)
    _same_gas(p.set_units("mmr", ["co2", "o3"], 1e-3),
              j.set_units("mmr", ["co2", "o3"], 1e-3))
    _same(p.to_mmr(), j.to_mmr())


def test_put_well_mixed_and_reverse():
    j, p = _both("mmr")
    j = j.put_well_mixed("o2", "vmr", 0.20944)
    p = p.put_well_mixed("o2", "vmr", 0.20944)
    _same_gas(p, j)
    _same_gas(p.reverse(), j.reverse())
    # a field put over a well-mixed gas is no longer well mixed
    v = _fields(3)["h2o"]
    _same_gas(p.put("o2", "mmr", torch.as_tensor(v)), j.put("o2", "mmr", v))
    assert p.is_present("o2") and not p.is_present("n2o")
    _same(p.get("n2o", "vmr"), j.get("n2o", "vmr"))     # absent: zeros


def test_assert_units():
    j, p = _both("vmr", scale_factor=1e-6)
    for g in (j, p):
        g.assert_units("vmr", scale_factor=1e-6)
        with pytest.raises(AssertionError):
            g.assert_units("mmr")
    p.set_units("mmr").assert_units("mmr")


@pytest.mark.parametrize("correct", [False, True])
def test_out_of_physical_bounds(correct):
    fields = _fields(1)
    fields["h2o"][0, 2] = -1e-3
    fields["o3"][1, 4] = 2.0
    j = jgas.Gas.allocate(NCOL, NLEV, np.float64)
    p = pgas.Gas.allocate(NCOL, NLEV, torch.float64)
    for g, v in fields.items():
        units = "vmr" if g == "co2" else "mmr"
        j = j.put(g, units, v)
        p = p.put(g, units, torch.as_tensor(v))
    bad_j, fixed_j = j.out_of_physical_bounds(correct)
    bad_p, fixed_p = p.out_of_physical_bounds(correct)
    assert bool(bad_p) and bool(bad_j)
    _same_gas(fixed_p, fixed_j)
    if correct:
        mmr = fixed_p.to_mmr()
        assert float(mmr.min()) >= 0.0 and float(mmr.max()) <= 1.0
    assert not bool(_both("mmr")[1].out_of_physical_bounds()[0])


@pytest.mark.parametrize("call", ["bad_units", "bad_gas", "bad_shape"])
def test_errors(call):
    j, p = _both("mmr")
    v = np.zeros((NCOL, NLEV))
    args = {"bad_units": ("h2o", "ppmv", v), "bad_gas": ("xe", "mmr", v),
            "bad_shape": ("h2o", "mmr", np.zeros((NCOL, NLEV + 1)))}[call]
    with pytest.raises(ValueError) as ej:
        j.put(*args)
    with pytest.raises(ValueError) as ep:
        p.put(args[0], args[1], torch.as_tensor(args[2]))
    assert str(ep.value) == str(ej.value)


def test_put_leaves_its_inputs():
    p = pgas.Gas.allocate(NCOL, NLEV, torch.float64)
    q = p.put("h2o", "mmr", torch.ones(NCOL, NLEV))
    assert float(p.mixing_ratio.abs().sum()) == 0.0
    assert float(q.mixing_ratio[..., constants.GAS_INDEX["h2o"]].min()) == 1.0
