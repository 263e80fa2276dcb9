"""The port's band-wise cloud optics models against the JAX package's, on
the same inputs (CPU, f64).

* Each fit (Slingo SW, Lindner-Li LW, Baran, Baran2016, Baran2017, Yi) on
  the bundled coefficient files, at seeded water paths, mixing ratios,
  temperatures and effective radii with the edge values added: each fit's
  clamps, Yi's effective diameters of 10 and 119.99 um, its exact
  multiples of 5 um (where ``floor`` picks the interval) and either side of
  them, Baran2016's ice mixing ratio either side of 1e-3, Baran2017's
  zero ice (its 1e-30 floor).  rtol 1e-12: the same operations in the same
  order.
* ``cloud_optics`` of every ice model with each liquid model, with SW delta
  scaling with gases, LW cloud scattering and the Fu LW bug flag each on
  and off; the bug flag changes Fu only.
* A Tripleclouds step of each pair that ``tests/test_cloud_optics_models.py``
  names, and SOCRATES with Yi, against the JAX step on four meridian
  columns (night and day) x 137 levels, within 1e-7 W m-2 (1e-10 for the
  dimensionless fields).
* Jahangir and Nielsen liquid: setup and the run raise as in the JAX
  package (no run dispatch in the reference).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecrad_tpu import config as jconfig
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.io.netcdf import NcFile
from ecrad_tpu.optics import cloud as jcloud
from ecrad_torch import config as tconfig
from ecrad_torch.interface import _to_tensors
from ecrad_torch.optics import cloud as tcloud
from tests.torch_steps import assert_fluxes, jax_step, port_step

torch.set_num_threads(2)

RTOL = 1e-12
NCOL, NLEV = 6, 30


def _coeffs(name):
    with NcFile(f"{DATA_DIR}/{name}") as f:
        return {k: f.get(k) for k in ("coeff_lw", "coeff_sw", "coeff_gen")
                if f.exists(k)}


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.isfinite(ref).all(), what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def _state(seed=0):
    """Water paths, mixing ratios, temperatures and effective radii of
    shape (NCOL, NLEV) with each fit's edge values in the first columns."""
    rng = np.random.default_rng(seed)
    shape = (NCOL, NLEV)
    wp = rng.uniform(0.0, 0.3, shape)
    q = 10.0 ** rng.uniform(-8.0, -2.5, shape)
    temp = rng.uniform(180.0, 300.0, shape)
    re = rng.uniform(1.0e-6, 80.0e-6, shape)
    # Yi: de = 2 re um at the clamps, on multiples of 5 um and beside them
    de = np.concatenate([[5.0, 9.0, 10.0, 119.99, 120.0, 150.0],
                         np.arange(15.0, 120.0, 5.0),
                         np.arange(15.0, 120.0, 5.0) - 1e-9,
                         np.arange(15.0, 120.0, 5.0) + 1e-9])
    re[:2].flat[:de.size] = de * 0.5e-6
    # Slingo (4.2-16.6 um) and Lindner-Li (2-40 um) clamps
    re[2, :8] = np.array([4.2, 16.6, 2.0, 40.0, 4.1, 16.7, 1.9, 40.1]) * 1e-6
    # Baran2016's min(qi, 1e-3); Baran2017's floor of zero ice
    q[3, :4] = (1e-3 - 1e-9, 1e-3, 1e-3 + 1e-9, 5e-3)
    q[4, :3] = 0.0
    wp[4, :3] = 0.0
    return wp, q, temp, re


# fit -> (coefficient file, the inputs after the coefficients)
FITS = {
    "liq_slingo": ("slingo_droplet_scattering_rrtm.nc", "re"),
    "liq_lindner_li": ("slingo_droplet_scattering_rrtm.nc", "re"),
    "ice_baran": ("baran_ice_scattering_rrtm.nc", "q"),
    "ice_baran2016": ("baran2016_ice_scattering_rrtm.nc", "q_t"),
    "ice_baran2017": ("baran2017_ice_scattering_rrtm.nc", "gen"),
    "ice_yi": ("yi_ice_scattering_rrtm.nc", "re"),
}
# Slingo is the SW liquid fit, Lindner-Li the LW one; the ice fits take
# either band's coefficients
FIT_BANDS = [("liq_slingo", "sw"), ("liq_lindner_li", "lw")] + [
    (name, band) for name in FITS if name.startswith("ice")
    for band in ("sw", "lw")]


@pytest.mark.parametrize("name,band", FIT_BANDS)
def test_fit_matches_jax(name, band):
    fname, inputs = FITS[name]
    c = _coeffs(fname)
    coeff = c[f"coeff_{band}"]
    wp, q, temp, re = _state()
    args = {"re": (wp, re), "q": (wp, q), "q_t": (wp, q, temp),
            "gen": (wp, q, temp)}[inputs]
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    pre_t = (t(c["coeff_gen"]), t(coeff)) if inputs == "gen" else (t(coeff),)
    pre_j = (c["coeff_gen"], coeff) if inputs == "gen" else (coeff,)
    got = getattr(tcloud, name)(*pre_t, *map(t, args))
    ref = getattr(jcloud, name)(*pre_j, *map(jnp.asarray, args))
    for what, a, b in zip(("od", "scat_od", "g"), got, ref):
        assert a.shape == (NCOL, NLEV, coeff.shape[0])
        _close(a, b, what=f"{name} {band} {what}")


def test_yi_on_grid_points_gives_the_table():
    """The Yi LUT columns lie at effective diameters 10, 15, ..., 120 um:
    on a multiple of 5 um the fit returns that column (an off-by-one in the
    1-based index would return a neighbour)."""
    coeff = _coeffs("yi_ice_scattering_rrtm.nc")["coeff_sw"]
    de = np.arange(15.0, 120.0, 5.0)
    iwp = np.full_like(de, 1e-3)
    _, _, g = tcloud.ice_yi(torch.as_tensor(coeff), torch.as_tensor(iwp),
                            torch.as_tensor(de * 0.5e-6))
    col = (de / 5.0 - 1.0).astype(int) - 1          # 0-based LUT column
    np.testing.assert_allclose(g.numpy(), coeff[:, 46 + col].T, rtol=1e-12)


# --- cloud_optics ---------------------------------------------------------------

LIQUID = ("SOCRATES", "SLINGO")
ICE = ("FU", "BARAN", "BARAN2016", "BARAN2017", "YI")
FLAGS = {"default": {},
         "delta_with_gases": dict(do_sw_delta_scaling_with_gases=True),
         "lw_no_scattering": dict(do_lw_cloud_scattering=False),
         "fu_lw_bug": dict(do_fu_lw_ice_optics_bug=True)}


def _configs(liquid, ice, **kw):
    return tuple(mod.Config(liquid_model=mod.LiquidModel[liquid],
                            ice_model=mod.IceModel[ice], **kw)
                 for mod in (tconfig, jconfig))


def _cloud_state(seed=5):
    """Half-level pressures and temperatures, cloud fractions with clear
    layers, condensate with zeros, radii beyond the fits' ranges."""
    rng = np.random.default_rng(seed)
    p_hl = np.sort(rng.uniform(100.0, 1e5, (NCOL, NLEV + 1)), axis=1)
    t_hl = rng.uniform(190.0, 300.0, (NCOL, NLEV + 1))
    frac = rng.uniform(0.0, 1.0, (NCOL, NLEV)) \
        * (rng.uniform(size=(NCOL, NLEV)) > 0.3)
    ql, qi = (rng.uniform(0.0, 1e-3, (NCOL, NLEV))
              * (rng.uniform(size=(NCOL, NLEV)) > 0.2) for _ in range(2))
    rl = rng.uniform(1e-6, 45e-6, (NCOL, NLEV))
    ri = rng.uniform(3e-6, 90e-6, (NCOL, NLEV))
    return p_hl, t_hl, frac, ql, qi, rl, ri


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("ice", ICE)
@pytest.mark.parametrize("liquid", LIQUID)
def test_cloud_optics_matches_jax(liquid, ice, flags):
    cfg, jcfg = _configs(liquid, ice, **FLAGS[flags])
    tables = tcloud.setup_cloud_optics(cfg, DATA_DIR)
    state = _cloud_state()
    got = tcloud.cloud_optics(cfg, _to_tensors(tables, "cpu", torch.float64),
                              *map(torch.as_tensor, state))
    ref = jcloud.cloud_optics(jcfg, jcloud.setup_cloud_optics(jcfg, DATA_DIR),
                              *map(jnp.asarray, state))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == (NCOL, NLEV, 14 if k.endswith("sw") else 16)
        _close(got[k], ref[k], what=k)
    assert float(got["od_sw"].max()) > 0.0
    if flags == "fu_lw_bug":
        plain = tcloud.cloud_optics(
            cfg.replace(do_fu_lw_ice_optics_bug=False),
            _to_tensors(tables, "cpu", torch.float64),
            *map(torch.as_tensor, state))
        same = all(torch.equal(got[k], plain[k]) for k in got)
        assert same == (ice != "FU")


@pytest.mark.parametrize("liquid", ["JAHANGIR", "NIELSEN"])
def test_unported_liquid_models_raise_as_jax(liquid):
    """Their coefficient files are not bundled, so setup fails on the file
    in both packages; with SOCRATES tables the run raises
    NotImplementedError in both."""
    cfg, jcfg = _configs(liquid, "FU")
    with pytest.raises(Exception) as port_err:
        tcloud.setup_cloud_optics(cfg, DATA_DIR)
    with pytest.raises(Exception) as jax_err:
        jcloud.setup_cloud_optics(jcfg, DATA_DIR)
    assert port_err.type is jax_err.type
    soc, jsoc = _configs("SOCRATES", "FU")
    state = _cloud_state()
    with pytest.raises(NotImplementedError):
        tcloud.cloud_optics(
            cfg, _to_tensors(tcloud.setup_cloud_optics(soc, DATA_DIR), "cpu",
                             torch.float64), *map(torch.as_tensor, state))
    with pytest.raises(NotImplementedError):
        jcloud.cloud_optics(jcfg, jcloud.setup_cloud_optics(jsoc, DATA_DIR),
                            *map(jnp.asarray, state))


# --- Tripleclouds steps -------------------------------------------------------

PAIRS = [("SLINGO", "FU"), ("SOCRATES", "BARAN"), ("SOCRATES", "BARAN2016"),
         ("SOCRATES", "BARAN2017"), ("SOCRATES", "YI")]


@pytest.mark.parametrize("liquid,ice", PAIRS)
def test_tripleclouds_step_matches_jax(liquid, ice):
    over = dict(sw_solver="TRIPLECLOUDS", lw_solver="TRIPLECLOUDS",
                liquid_model=liquid, ice_model=ice)
    ref = jax_step(over)
    assert_fluxes(port_step(over), ref)
    assert float(np.abs(ref["sw_up"]).max()) > 10.0


def test_setup_tables_match_jax():
    """Each model's tables, Baran2017's coeff_gen included, equal the JAX
    package's setup."""
    for liquid in LIQUID:
        for ice in ICE:
            cfg, jcfg = _configs(liquid, ice)
            got = tcloud.setup_cloud_optics(cfg, DATA_DIR)
            ref = jcloud.setup_cloud_optics(jcfg, DATA_DIR)
            assert set(got) == set(ref)
            assert ("ice_coeff_gen" in got) == (ice == "BARAN2017")
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

