"""The port's SPARTACUS solvers against the JAX package's (its
``lax.scan`` path), CPU, f64, on the same seeded inputs.

7 columns x 9 layers x 14 g-points, with a cloud-free column, a night
column (cos_sza 0) and a column with the sun below MIN_MU0_3D (0.003),
clouds in the top layer and in the others at random.  Every entrapment
mode with 3D effects on, 3D off, and the options: LW multilayer effects,
LW side emissivity off, ``use_expm_everywhere``, ``clear_to_thick_fraction
> 0``, and no ``inv_inhom_effective_size``.  Every output field is
compared, LW derivatives included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecrad_tpu import config as jconfig
from ecrad_tpu.solvers import spartacus as jsp
from ecrad_torch import config as tconfig
from ecrad_torch.solvers import spartacus as tsp

torch.set_num_threads(2)

NCOL, NLEV, NBAND = 7, 9, 5
GCOUNTS = (3, 2, 4, 2, 3)
NG = sum(GCOUNTS)
BAND_FROM_G = np.repeat(np.arange(NBAND), GCOUNTS)
# Same algorithm in f64; the 3D exponentials, their solves and ~9-level
# recurrences: f64 roundoff, relative to each field's largest value (the
# fluxes reach ~600 W m-2 here, so this is ~1e-8 W m-2, the bar of the
# spartacus_3d slice; derivatives and cloud cover are at most 1).
RTOL = 1e-11


@pytest.fixture(scope="module")
def props():
    rng = np.random.default_rng(1)

    def u(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape)

    frac = u(NCOL, NLEV) * (u(NCOL, NLEV) > 0.4)
    frac[0] = 0.0
    frac[1, 0] = 0.6
    cos_sza = u(NCOL, lo=-0.2, hi=1.0)
    cos_sza[0], cos_sza[2] = 0.0, 0.003
    cos_sza[3] = 0.7
    p_hl = 30000.0 + 1500.0 * np.arange(NLEV + 1)[None, :] \
        + u(NCOL, NLEV + 1, hi=300.0)
    return dict(
        optics=(u(NCOL, NLEV, NG, lo=1e-4, hi=3.0),
                u(NCOL, NLEV, NG, lo=0.1, hi=0.999),
                u(NCOL, NLEV, NG, hi=0.8),
                u(NCOL, NLEV, NBAND, hi=4.0),
                u(NCOL, NLEV, NBAND, lo=0.3, hi=0.999),
                u(NCOL, NLEV, NBAND, hi=0.9)),
        clouds=(frac, u(NCOL, NLEV, hi=2.5), u(NCOL, NLEV - 1, lo=-0.1),
                u(NCOL, NLEV, lo=1e-4, hi=2e-3),
                u(NCOL, NLEV, lo=1e-4, hi=3e-3)),
        levels=(p_hl, u(NCOL, NLEV + 1, lo=200.0, hi=300.0)),
        sw=(u(NCOL, NG, hi=100.0), cos_sza, u(NCOL, NG, hi=0.3),
            u(NCOL, NG, hi=0.4)),
        lw=(u(NCOL, NLEV + 1, NG, lo=0.5, hi=30.0), u(NCOL, NG, hi=10.0),
            u(NCOL, NG, hi=0.3)))


def _args(p, band, conv, inhom=True):
    """solver_spartacus_* arguments after the config, converted by conv;
    band-specific tail appended by the caller."""
    clouds = [conv(x) for x in p["clouds"]]
    if not inhom:
        clouds[-1] = None
    return ([conv(x) for x in p["optics"]] + [band] + clouds
            + [conv(x) for x in p["levels"]])


def _configs(mode="EXPLICIT", **kw):
    return (tconfig.Config(sw_entrapment=tconfig.Entrapment[mode], **kw),
            jconfig.Config(sw_entrapment=jconfig.Entrapment[mode], **kw))


def _compare(got, ref):
    extra = set(ref._fields) - set(got._fields)
    assert all(getattr(ref, f) is None for f in extra), extra
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=RTOL * max(1.0, np.abs(b).max()),
                                   err_msg=name)


def _run(solver, cfgs, p, tail, inhom=True):
    tcfg, jcfg = cfgs
    t = _args(p, torch.as_tensor(BAND_FROM_G), torch.as_tensor, inhom)
    j = _args(p, BAND_FROM_G, jnp.asarray, inhom)
    got = getattr(tsp, solver)(tcfg, *t, *map(torch.as_tensor, tail))
    ref = getattr(jsp, solver)(jcfg, *j, *map(jnp.asarray, tail))
    _compare(got, ref)
    return got


SW_CASES = {
    **{m.lower(): dict(mode=m, do_3d_effects=True)
       for m in ("EXPLICIT", "EXPLICIT_NON_FRACTAL", "EDGE_ONLY", "ZERO",
                 "MAXIMUM")},
    "no_3d": dict(do_3d_effects=False),
    # every element refined, edges between clear and thick cloud, and the
    # inhomogeneity size taken from the cloud size
    "options": dict(do_3d_effects=True, use_expm_everywhere=True,
                    clear_to_thick_fraction=0.3, inhom=False),
}


@pytest.mark.parametrize("case", list(SW_CASES))
def test_solver_spartacus_sw_matches_jax(props, case):
    kw = dict(SW_CASES[case])
    inhom = kw.pop("inhom", True)
    got = _run("solver_spartacus_sw", _configs(**kw), props, props["sw"],
               inhom)
    # night columns give zero fluxes, the low-sun column does not
    assert float(got.flux_dn[0].abs().max()) == 0.0
    assert float(got.flux_dn[2].abs().max()) > 0.0


LW_CASES = {
    "explicit": dict(do_3d_effects=True, do_lw_derivatives=True),
    "no_3d": dict(do_3d_effects=False, do_lw_derivatives=True),
    "multilayer": dict(do_3d_effects=True, do_3d_lw_multilayer_effects=True,
                       use_expm_everywhere=True, clear_to_thick_fraction=0.3),
    "no_side_emissivity": dict(do_3d_effects=True,
                               do_lw_side_emissivity=False, inhom=False,
                               do_lw_derivatives=True),
}


@pytest.mark.parametrize("case", list(LW_CASES))
def test_solver_spartacus_lw_matches_jax(props, case):
    kw = dict(LW_CASES[case])
    inhom = kw.pop("inhom", True)
    got = _run("solver_spartacus_lw", _configs(**kw), props, props["lw"],
               inhom)
    assert (got.lw_derivatives is None) != kw.get("do_lw_derivatives",
                                                   False)
