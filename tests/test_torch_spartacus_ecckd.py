"""``spartacus_ecckd`` (SPARTACUS SW and LW with 3D effects on ecCKD gas
optics at 32 g-points, general cloud optics, no aerosols) against the JAX
package on the CPU in float64, at 137 levels.

* The whole step against the JAX step on 8 meridian columns, and the
  port's step on the 32 columns against the committed reference
  (tests/data/torch_spartacus_ecckd_meridian32.npz) that chip_smoke.py
  holds the card to: within 1e-6 W m-2.
* Where the two packages part, stage by stage on the same inputs: the
  SPARTACUS preparation and region optics agree to roundoff, the sweeps
  fed the JAX layer matrices give the JAX fluxes, and the LW layer
  matrices of the 3D refinement differ by what their exponential's growth
  makes of f64 roundoff (``test_lw_layer_matrices_part_by_growth``).
* The namelist ``flagship.namelist_text("spartacus_ecckd")`` through both
  offline drivers on a 4-column cut.

Why the slice sits further from JAX than RRTMG SPARTACUS (~3e-7 against
~7e-9 W m-2): the LW layer matrices come from exp(G) of the 6x6 two-stream
generator G of each 3D-active element, and R, T and the sources are
differences of entries of size max|exp(G)|, which grows as e^(|G|) with
the regions' optical depths (cloud od clamped at max_cloud_od = 16).  Any
two evaluations that round differently part by about eps * max|exp(G)|:
measured up to 0.72 eps max|exp(G)| in R and T over every refined element,
both packages equally far from a 50-digit evaluation.  On the 32 meridian
columns max|exp(G)| reaches 1.28e11 on ecCKD against 7.88e9 on RRTMG.
The squaring cap of the LW exponential (6) is not reached: the generator's
1-norm stays below 28, three squarings.
"""

import dataclasses
import os

import mpmath
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from ecrad_tpu import config as jconfig
from ecrad_tpu import interface as jint
from ecrad_tpu.solvers import spartacus as jsp
from ecrad_torch import driver, flagship
from ecrad_torch.constants import LW_DIFFUSIVITY
from ecrad_torch.interface import _spartacus_perm
from ecrad_torch.solvers import matrix as tmatrix
from ecrad_torch.solvers import spartacus as tsp
from ecrad_torch.solvers.two_stream import lw_gammas
from ecrad_tpu import driver as jdriver
from tests.torch_files import (assert_same_files, write_meridian_cut,
                               write_namelist)
from tests.torch_steps import enums
from tools.make_torch_reference import OUTPUTS

torch.set_num_threads(2)

NAME = "spartacus_ecckd"
DATA = os.path.join(os.path.dirname(__file__), "data")
# 8 meridian columns; 14 and 15 hold the elements where the two packages
# part most
COLS = slice(8, 16)
# Same algorithm in f64: the slice's bar (chip_smoke.py SLICE_F64_ATOL);
# the dimensionless fields to 1e-10.  Measured: 2.98e-7 W m-2 in lw_dn.
ATOL_FLUX, ATOL_DIMLESS = 1e-6, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# float32 against the JAX float64 fluxes: ecRad's single-precision bar
# (chip_smoke.py SLICE_F32_ATOL); the dimensionless fields to 1e-4
ATOL_F32, ATOL_F32_DIMLESS = 0.5, 1e-4
# Stages that compute the same function in the same order: roundoff
RTOL_STAGE = 1e-12
# The diagonal two-stream layer matrices outside the refined elements: the
# sources of thin layers cancel (measured 1.4e-12 rel in SU)
RTOL_TWO_STREAM = 1e-11
# The port's sweeps fed the JAX layer matrices against the JAX fluxes
# (measured ~3e-13 W m-2 at fluxes of ~400)
ATOL_SWEEPS = 1e-10
EPS = float(np.finfo(np.float64).eps)
# The LW layer matrices of a refined element differ by about eps times
# the largest entry of exp(G) (R and T measured up to 0.72 eps max|exp(G)|,
# where max|exp(G)| ~ 1; 0.01 where it exceeds 100): bar 4 eps max|exp(G)|.
# The sources, of tens of W m-2, measured up to 0.0115 eps max|exp(G)|
# times the element's largest source where max|exp(G)| > 1e8, and within
# 2.3e-13 W m-2 where it stays below 1e4: bar 0.1 eps max|exp(G)| |S| plus
# 1e-12 W m-2.
K_MATS, K_SOURCES, ATOL_SOURCES = 4.0, 0.1, 1e-12
# the LW exponential's squaring cap (spartacus._lw_refine)
LW_MAX_SQUARINGS = 6


def _resolved():
    from tools.bench_matrix import _resolve
    return _resolve(enums(jconfig, OUTPUTS[NAME][0]))


def _cut(tree, to):
    """Every (16, ...) array of a tree cut to the columns COLS."""
    if isinstance(tree, dict):
        return {k: _cut(v, to) for k, v in tree.items()}
    x = np.asarray(tree)
    return to(x[COLS]) if x.ndim and x.shape[0] == 16 else tree


def _fields(flux):
    return {k: np.asarray(getattr(flux, k))
            for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def jax_build():
    jstep, jargs = __graft_entry__._build(ncol=16, dtype="float64",
                                          nam_overrides=_resolved())
    return jstep, [_cut(a, jnp.asarray) for a in jargs]


@pytest.fixture(scope="module")
def port_build():
    step, args = flagship.build(ncol=16, dtype=torch.float64, device="cpu",
                                config_name=NAME)
    return step, [_cut(a, torch.as_tensor) for a in args]


def test_config_is_spartacus_3d_on_ecckd():
    port = flagship.flagship_config("float64", NAME)
    over = _resolved()
    flagship_fields = flagship.flagship_config("float64")
    for f in dataclasses.fields(port):
        a = getattr(port, f.name)
        b = over.get(f.name, getattr(flagship_fields, f.name))
        if hasattr(b, "name"):
            a, b = a.name, b.name
        assert a == b, f.name
    assert flagship.CONFIGS[NAME] == {**flagship.CONFIGS["spartacus_3d"],
                                      **flagship.ECCKD}
    step, _ = flagship.build(ncol=2, dtype=torch.float64, device="cpu",
                             config_name=NAME)
    assert step.config.n_g_sw == step.config.n_g_lw == 32
    for is_sw in (True, False):     # natural g order
        np.testing.assert_array_equal(_spartacus_perm(step.config, is_sw),
                                      np.arange(32))


def test_step_matches_jax(jax_build, port_build):
    jstep, jargs = jax_build
    ref = _fields(jax.jit(jstep)(*jargs))
    step, args = port_build
    got = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(got) == set(ref) and len(got) == 20
    for k, r in ref.items():
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got[k], r, rtol=0, atol=atol, err_msg=k)


def test_reference_file():
    """The port's step on the 32 meridian columns against the committed
    JAX fluxes, f64 within the slice's bar; the file holds the f32 run
    too (chip_smoke.py holds the f32 slice to the f64 fluxes, F32_HELD_TO:
    JAX's own f32 run is thousands of W m-2 off in the LW)."""
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name=NAME)
    got = step(*args).fields()
    with np.load(os.path.join(DATA, OUTPUTS[NAME][1])) as z:
        assert {f"f64/{k}" for k in got} == {
            k for k in z.files if k.startswith("f64/")}
        assert not any(k.startswith("f32_sample/") for k in z.files)
        for k, v in got.items():
            atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
            np.testing.assert_allclose(v.numpy(), z[f"f64/{k}"], rtol=0,
                                       atol=atol, err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32
            assert z[f"f32/{k}"].shape == v.shape


def test_float32_within_the_single_precision_bar():
    """The port's float32 step on the 32 meridian columns within ecRad's
    0.5 W m-2 of the JAX float64 fluxes (measured 0.043 on this CPU; its
    LW 3D refinement runs in float64, spartacus._lw_layer_mats)."""
    step, args = flagship.build(ncol=32, dtype=torch.float32, device="cpu",
                                config_name=NAME)
    got = step(*args).fields()
    with np.load(os.path.join(DATA, OUTPUTS[NAME][1])) as z:
        for k, v in got.items():
            atol = ATOL_F32_DIMLESS if k in DIMLESS else ATOL_F32
            np.testing.assert_allclose(v.double().numpy(), z[f"f64/{k}"],
                                       rtol=0, atol=atol, err_msg=k)


# --- the stages -------------------------------------------------------

@pytest.fixture(scope="module")
def stages(jax_build, port_build):
    """The LW solver's inputs of the JAX step, and what each package makes
    of them: the JAX layer matrices (R, T, SU, SD, captured from its level
    map) and fluxes; the port's prep, region optics and layer matrices,
    with the inputs, 1-norm and largest |exp(G)| of every refined element
    (captured from spartacus._lw_refine and pl_expm)."""
    jstep, jargs = jax_build
    jc, jt = jstep.config, jstep.tables
    jkw = dict(zip(flagship.ARG_ORDER, jargs))
    op = jax.jit(lambda kw: jint._optical_properties(
        jc, jt, solar_irradiance=jstep.solar, **kw))(jkw)
    perm = jint._spartacus_perm(jc, is_sw=False)
    take = lambda a: jnp.take(a, jnp.asarray(perm), axis=-1)  # noqa: E731
    cloud = jkw["cloud"]
    emission = op["go"].lw_emission * (1.0 - op["lw_albedo_g"])
    args = [take(op["od_lw"]), take(op["ssa_lw"]), take(op["g_lw_arr"]),
            op["cl"]["od_lw"], op["cl"]["ssa_lw"], op["cl"]["g_lw"],
            np.asarray(jt.band_from_g_lw)[perm], op["frac"],
            cloud["fractional_std"], cloud["overlap_param"],
            cloud["inv_cloud_effective_size"],
            cloud["inv_inhom_effective_size"], jkw["pressure_hl"],
            jkw["temperature_hl"], take(op["go"].planck_hl),
            take(emission), take(op["lw_albedo_g"])]
    band = args.pop(6)
    captured = []

    def spy(fn, xs, nlev, chunk=None):
        out = level_map(fn, xs, nlev, chunk)
        captured.append(out)
        return out

    def run(*dyn):
        a = list(dyn)
        a.insert(6, band)
        lw = jsp.solver_spartacus_lw(jc, *a)
        return lw, captured[-1]

    level_map = jsp._map_levels
    jsp._map_levels = spy
    try:
        lw, mats = jax.jit(run)(*args)
    finally:
        jsp._map_levels = level_map
    args.insert(6, band)
    step, _ = port_build
    targs = (step.config,) + tuple(torch.as_tensor(np.array(a))
                                   for a in args)

    refine, expm = tsp._lw_refine, tsp.pl_expm
    elements, growth = [], []

    def refine_spy(*a):
        elements.append(a)
        return refine(*a)

    def expm_spy(G, max_squarings):
        E = expm(G, max_squarings)
        growth.append((G.abs().sum(0).amax(0), E.abs().amax(dim=(0, 1))))
        return E

    tsp._lw_refine, tsp.pl_expm = refine_spy, expm_spy
    try:
        _, sweep_args, P = tsp.lw_sweep_args(*targs)
    finally:
        tsp._lw_refine, tsp.pl_expm = refine, expm
    return dict(
        jax_config=jc, jax_args=args, jax_lw=lw,
        jax_mats=[np.asarray(m) for m in mats],
        args=targs, mats=[m.numpy() for m in sweep_args[:4]], P=P,
        elements=[torch.cat([e[i] for e in elements], -1)
                  for i in range(8)],
        norm1=torch.cat([g[0] for g in growth]).numpy(),
        growth=torch.cat([g[1] for g in growth]).numpy(),
        use=tsp._use_expm_mask(step.config, targs[1], P["active_3d"]))


def test_prep_and_region_optics_agree(stages):
    """The SPARTACUS preparation (region fractions, overlap matrices,
    od scaling, 3D geometry) and the per-region optics of the two packages
    on the same inputs: roundoff."""
    ja, a, jc = stages["jax_args"], stages["args"], stages["jax_config"]
    # the solver's (fraction, std, overlap, sizes, p, T) in _prep's order
    prep_args = [ja[i] for i in (7, 8, 9, 12, 13, 10, 11)]
    jP = jax.jit(lambda *x: jsp._prep(jc, *x))(*prep_args)
    P = stages["P"]
    for k in ("reg_fracs", "u_mat", "v_mat", "od_scaling", "layer_depth",
              "edge_length", "inv_size", "cloud_cover"):
        np.testing.assert_allclose(P[k].numpy(), np.asarray(jP[k]),
                                   rtol=RTOL_STAGE, atol=0, err_msg=k)
    for k in ("clear_layer", "active_3d"):
        np.testing.assert_array_equal(P[k].numpy(), np.asarray(jP[k]))
    jreg = jax.jit(lambda *x: jsp._region_optics(
        jc, *x[:6], ja[6], x[6]))(*ja[:6], jP["od_scaling"])
    reg = tsp._region_optics(a[0].max_cloud_od, *a[1:8], P["od_scaling"])
    for name, got, ref in zip(("od3", "ssa3", "g3"), reg, jreg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=RTOL_STAGE, atol=0, err_msg=name)


def test_sweeps_on_the_jax_matrices_give_the_jax_fluxes(stages,
                                                         monkeypatch):
    """The port's solver with its layer matrices replaced by the JAX ones:
    the sweeps, derivatives and outputs then agree to roundoff, so the
    packages part before the sweeps."""
    mats = tuple(torch.as_tensor(m) for m in stages["jax_mats"])
    # the JAX matrices beside the port's own clear-sky planes
    build = tsp._lw_layer_mats
    monkeypatch.setattr(tsp, "_lw_layer_mats",
                        lambda *a, **k: (*mats, build(*a, **k)[-1]))
    got = tsp.solver_spartacus_lw(*stages["args"])
    ref = stages["jax_lw"]
    for k in ("flux_up", "flux_dn", "flux_up_clear", "flux_dn_clear"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=ATOL_SWEEPS, err_msg=k)
    np.testing.assert_allclose(got.lw_derivatives.numpy(),
                               np.asarray(ref.lw_derivatives), rtol=0,
                               atol=ATOL_DIMLESS)


def _per_element(stages, m):
    """A layer-matrix stack (nlev, k, ncol, ng) at the refined elements,
    in their order: (n, k)."""
    c, l, g = stages["use"].nonzero(as_tuple=True)
    return m[l.numpy(), :, c.numpy(), g.numpy()]


def test_lw_layer_matrices_part_by_growth(stages):
    """The stage where the two packages part: the LW layer matrices of
    the 3D refinement.  Outside the refined elements they agree to
    roundoff (RTOL_TWO_STREAM); at each refined element R and T within 4
    eps max|exp(G)| and the sources within 0.1 eps max|exp(G)| |S| +
    1e-12 W m-2 (the module's docstring and K_MATS say why).  The LW
    exponential never reaches its squaring cap."""
    growth = stages["growth"]
    use = stages["use"].numpy()
    assert growth.shape == (use.sum(),) and growth.max() > 1e10
    assert stages["norm1"].max() <= 2.0 ** (LW_MAX_SQUARINGS - 1) \
        * tmatrix._THETA3
    jR, jT, jSU, jSD = stages["jax_mats"]
    R, T, SU, SD = stages["mats"]
    outside = ~use.transpose(1, 0, 2)[:, None]     # (nlev, 1, ncol, ng)
    for name, got, ref in (("R", R, jR), ("T", T, jT), ("SU", SU, jSU),
                           ("SD", SD, jSD)):
        err = np.abs(got - ref) * outside
        assert (err <= RTOL_TWO_STREAM * np.abs(ref) + 1e-14).all(), name
    for name, got, ref in (("R", R, jR), ("T", T, jT)):
        err = np.abs(_per_element(stages, got - ref)).max(-1)
        assert (err <= K_MATS * EPS * growth).all(), \
            (name, float((err / (EPS * growth)).max()))
    scale = np.maximum(np.abs(_per_element(stages, jSU)).max(-1),
                       np.abs(_per_element(stages, jSD)).max(-1))
    for name, got, ref in (("SU", SU, jSU), ("SD", SD, jSD)):
        err = np.abs(_per_element(stages, got - ref)).max(-1)
        assert (err <= K_SOURCES * EPS * growth * scale
                + ATOL_SOURCES).all(), name
    # the growth the tolerance allows for is what separates the packages
    big = growth > 1e8
    err_t = np.abs(_per_element(stages, T - jT)).max(-1)
    assert err_t[big].max() > 100 * err_t[~big].max()


def _exact_refine(odr, ssar, gr, trl, sidel, rfr, plt, plb):
    """T and SD of one element (spartacus._lw_refine's formulas,
    radiation_spartacus_lw.F90:311-424) at 50 digits."""
    mpmath.mp.dps = 50
    f = lambda x: mpmath.mpf(float(x))  # noqa: E731
    g1, g2 = (x.numpy() for x in lw_gammas(torch.as_tensor(ssar),
                                           torch.as_tensor(gr)))
    trs = [[f(trl[i, j]) for j in range(3)] for i in range(3)]
    trs[1][0] *= f(sidel)
    trs[2][0] *= f(sidel)
    G = mpmath.zeros(6, 6)
    for i in range(3):
        for j in range(3):
            d = f(odr[i]) * f(g1[i]) + sum(trs[i]) if i == j else -trs[j][i]
            G[i, j], G[3 + i, 3 + j] = d, -d
        G[i, 3 + i] = -f(odr[i]) * f(g2[i])
        G[3 + i, i] = f(odr[i]) * f(g2[i])
    E = mpmath.expm(G)
    E11, E12, E21, E22 = (E[0:3, 0:3], E[0:3, 3:6], E[3:6, 0:3],
                          E[3:6, 3:6])
    T = E21 * (-(E11 ** -1) * E12) + E22
    emis = [f(odr[r]) * (1 - f(ssar[r])) * f(rfr[r]) * f(LW_DIFFUSIVITY)
            for r in range(3)]
    dpl = f(plb) - f(plt)
    pt = mpmath.matrix([-e * f(plt) for e in emis] + [e * f(plt)
                                                      for e in emis])
    pd = mpmath.matrix([-e * dpl for e in emis] + [e * dpl for e in emis])
    sol_d = -(G ** -1) * pd
    sol0 = (G ** -1) * (sol_d - pt)
    su = sol0[0:3, 0] - (E11 ** -1) * (sol0[0:3, 0] + sol_d[0:3, 0]
                                       - E12 * sol0[3:6, 0])
    sd = E21 * (su - sol0[0:3, 0]) + sol0[3:6, 0] - E22 * sol0[3:6, 0] \
        + sol_d[3:6, 0]
    return (np.array([float(T[i, j]) for i in range(3) for j in range(3)]),
            np.array([float(sd[i]) for i in range(3)]))


def test_both_packages_as_far_from_50_digits(stages):
    """At the three elements where T and SD part most, the port and the JAX
    package are each within the growth bar of a 50-digit evaluation of the
    same formulas: neither is at fault."""
    growth = stages["growth"]
    part = [np.abs(_per_element(stages, p - j)).max(-1) for p, j in
            ((stages["mats"][1], stages["jax_mats"][1]),
             (stages["mats"][3], stages["jax_mats"][3]))]
    worst = np.argsort(-(part[0] / part[0].max() + part[1] / part[1].max()))
    for k in worst[:3]:
        exact_t, exact_sd = _exact_refine(*(
            x[..., k].numpy() for x in stages["elements"]))
        bar_t = K_MATS * EPS * growth[k]
        bar_sd = K_SOURCES * EPS * growth[k] * np.abs(exact_sd).max() \
            + ATOL_SOURCES
        for mats in (stages["mats"], stages["jax_mats"]):
            t = _per_element(stages, mats[1])[k]
            sd = _per_element(stages, mats[3])[k]
            assert np.abs(t - exact_t).max() <= bar_t
            assert np.abs(sd - exact_sd).max() <= bar_sd


# --- the offline drivers ----------------------------------------------

def test_namelist_through_both_drivers(tmp_path):
    """flagship.namelist_text("spartacus_ecckd") read by both offline
    drivers on the 4-column cut: the same output file, within the slice's
    bar."""
    cut = write_meridian_cut(tmp_path)["cut"]
    nam = write_namelist(str(tmp_path / "config.nam"), NAME)
    port, ref = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    driver.main([nam, cut, port, "--device", "cpu"])
    jdriver.run(nam, cut, ref)
    worst = assert_same_files(port, ref, ATOL_FLUX, ATOL_DIMLESS)
    assert "flux_dn_lw" in worst and "cloud_cover_sw" in worst
