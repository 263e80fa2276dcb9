"""The port's ecCKD modules against the JAX package's, on the same inputs
(CPU, f64).

* ``optics/ecckd.py``: the tables and metadata ``load_ckd_model`` reads
  from both bundled definition files; ``calc_optical_depth`` (SW and LW)
  on pressures, temperatures and h2o concentrations below and above the
  LUT grids; ``calc_planck`` below, inside and above its table;
  ``read_spectral_solar_cycle`` with and without the updated solar
  spectrum; ``calc_incoming_sw`` along the solar cycle.
* ``optics/general_cloud.py``: the setup per g-point and per band, with
  and without thick averaging, and the run-time optics with LW cloud
  scattering on and off, SW delta scaling with gases on and off, and the
  Homogeneous water path.
* The optical properties of the ecCKD configurations against the JAX
  package's ``compute_radiative_properties``, also with the flagship's
  aerosols on (per-g-point aerosol setup and merge), and along the
  solar cycle.
* The kernels of the SW layer coefficients compile without FMA
  contraction.
* Mixed gas models (RRTMG in one band set, ecCKD in the other) on McICA:
  each against the JAX package, each band set's fluxes equal to the run
  that shares its gas model, and the two gas models differ.

The module-level comparisons hold to rtol 1e-10: the corner gathers sum
the same four (or eight) weighted rows in another order than the JAX
package's weighted one-hot matrix products, which moves only the last
bits.  Entries that cancel to near zero (an optical depth whose
relative-linear gases subtract) are held to 1e-10 of the largest value.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from ecrad_tpu import config as jconfig
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.interface import compute_radiative_properties
from ecrad_tpu.optics import ecckd as jecckd
from ecrad_tpu.optics import general_cloud as jgc
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, kernels, pipeline
from ecrad_torch.interface import (ECCKD_LW_FILE, ECCKD_SW_FILE,
                                   _optical_properties, _to_tensors,
                                   setup_radiation)
from ecrad_torch.optics import ecckd as tecckd
from ecrad_torch.optics import general_cloud as tgc

torch.set_num_threads(2)

RTOL = 1e-10
FILES = {"sw": os.path.join(DATA_DIR, ECCKD_SW_FILE),
         "lw": os.path.join(DATA_DIR, ECCKD_LW_FILE)}
SSI_FILE = os.path.join(DATA_DIR, "ssi_nrl2.nc")
ECCKD = dict(gas_model_sw="ECCKD", gas_model_lw="ECCKD",
             use_general_cloud_optics=True,
             do_nearest_spectral_lw_emiss=False, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=())
ARGS = flagship.ARG_ORDER


def _close(got, ref, rtol=RTOL, what=""):
    """got (tensor or array) against ref within rtol, with a floor of rtol
    times ref's largest value."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def _tensors(tables):
    return _to_tensors(tables, "cpu", torch.float64)


ENUMS = {"gas_model_sw": "GasModel", "gas_model_lw": "GasModel",
         "sw_solver": "Solver", "lw_solver": "Solver"}


def _enums(mod, kw):
    """Config fields with the enum fields given by member name resolved
    in the config module mod."""
    return {k: getattr(getattr(mod, ENUMS[k]), v) if k in ENUMS else v
            for k, v in kw.items()}


def _configs(**kw):
    """The same settings as a port Config and a JAX Config."""
    return (tconfig.Config(**_enums(tconfig, kw)),
            jconfig.Config(**_enums(jconfig, kw)))


# --- ecCKD gas optics --------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """{band: (port tables as tensors, JAX tables, meta)}."""
    out = {}
    for band, path in FILES.items():
        t, _, meta = tecckd.load_ckd_model(path)
        jt, _, _ = jecckd.load_ckd_model(path)
        out[band] = (_tensors(t), jt, meta)
    return out


@pytest.mark.parametrize("band", ["sw", "lw"])
def test_load_ckd_model_matches_jax(band):
    t, specdef, meta = tecckd.load_ckd_model(FILES[band])
    jt, jspecdef, jmeta = jecckd.load_ckd_model(FILES[band])
    assert meta == jmeta
    assert meta["ng"] == 32 and meta["is_sw"] == (band == "sw")
    assert set(t) == set(jt)
    for k in jt:
        np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
    for attr in ("wavenumber1", "wavenumber2", "gpoint_fraction",
                 "wavenumber1_band", "wavenumber2_band", "band_number"):
        np.testing.assert_array_equal(getattr(specdef, attr),
                                      getattr(jspecdef, attr), err_msg=attr)
    assert (specdef.solar_spectral_irradiance is None) \
        == (jspecdef.solar_spectral_irradiance is None)


def _state(meta, ncol=7, nlev=12, seed=0):
    """Half-level pressures from below the LUT's first pressure to above
    its last, full-level temperatures beyond both ends of the (offset)
    temperature grid, and volume mixing ratios of every gas, h2o from
    below its concentration grid to above it."""
    rng = np.random.default_rng(seed)
    p1 = np.exp(meta["log_pressure1"])
    pn = np.exp(meta["log_pressure1"]
                + (meta["npress"] - 1) * meta["d_log_pressure"])
    log_p = np.sort(rng.uniform(np.log(0.2 * p1), np.log(1.3 * pn),
                                (ncol, nlev + 1)), axis=1)
    log_p[:, 0], log_p[:, -1] = np.log(0.2 * p1), np.log(1.3 * pn)
    t_fl = rng.uniform(100.0, 390.0, (ncol, nlev))
    vmr = {"h2o": np.exp(rng.uniform(np.log(1e-9), np.log(0.2),
                                     (ncol, nlev))),
           "o3": rng.uniform(1e-8, 1e-5, (ncol, nlev)),
           "co2": rng.uniform(2e-4, 8e-4, (ncol, nlev)),
           # either side of their reference concentrations
           "ch4": rng.uniform(0.5e-6, 3e-6, (ncol, nlev)),
           "n2o": rng.uniform(1e-7, 5e-7, (ncol, nlev)),
           "cfc11": rng.uniform(0.0, 1e-9, (ncol, nlev)),
           "cfc12": rng.uniform(0.0, 1e-9, (ncol, nlev))}
    h2o = next(g for g in meta["gases"] if g["name"] == "h2o")
    assert h2o["conc_dependence"] == tecckd.CONC_LUT
    lo = np.exp(h2o["log_mole_frac1"])
    hi = np.exp(h2o["log_mole_frac1"]
                + (h2o["n_mole_frac"] - 1) * h2o["d_log_mole_frac"])
    assert (vmr["h2o"] < lo).any() and (vmr["h2o"] > hi).any()
    return np.exp(log_p), t_fl, vmr


@pytest.mark.parametrize("band", ["sw", "lw"])
def test_calc_optical_depth_matches_jax(models, band):
    t, jt, meta = models[band]
    p_hl, t_fl, vmr = _state(meta)
    od, ray = tecckd.calc_optical_depth(
        t, meta, torch.as_tensor(p_hl), torch.as_tensor(t_fl),
        {k: torch.as_tensor(v) for k, v in vmr.items()})
    jod, jray = jecckd.calc_optical_depth(
        jt, meta, jnp.asarray(p_hl), jnp.asarray(t_fl),
        {k: jnp.asarray(v) for k, v in vmr.items()})
    assert od.shape == (7, 12, 32)
    _close(od, jod, what="od")
    if band == "sw":
        _close(ray, jray, what="rayleigh")
    else:
        assert ray is None and jray is None


def test_calc_planck_matches_jax(models):
    t, jt, meta = models["lw"]
    t1 = meta["temperature1_planck"]
    tn = t1 + (meta["nplanck"] - 1) * meta["d_temperature_planck"]
    temps = np.array([[40.0, t1 - 1.5, t1 - 0.3, t1, t1 + 0.4, 255.55],
                      [288.2, tn - 0.5, tn, tn + 0.25, tn + 7.5, 420.0]])
    got = tecckd.calc_planck(t, meta, torch.as_tensor(temps))
    ref = jecckd.calc_planck(jt, meta, jnp.asarray(temps))
    assert got.shape == (2, 6, 32)
    _close(got, ref, what="planck")
    # one value per column too (the skin temperature)
    _close(tecckd.calc_planck(t, meta, torch.as_tensor(temps[:, 1])),
           jecckd.calc_planck(jt, meta, jnp.asarray(temps[:, 1])),
           what="planck (ncol,)")


@pytest.mark.parametrize("updated", [False, True])
def test_read_spectral_solar_cycle_matches_jax(updated):
    t, specdef, _ = tecckd.load_ckd_model(FILES["sw"])
    jt, jspecdef, _ = jecckd.load_ckd_model(FILES["sw"])
    before = t["norm_solar_irradiance"].copy()
    tecckd.read_spectral_solar_cycle(t, specdef, SSI_FILE, updated)
    jecckd.read_spectral_solar_cycle(jt, jspecdef, SSI_FILE, updated)
    assert set(t) == set(jt)
    for k in ("norm_solar_irradiance", "norm_amplitude_solar_irradiance"):
        np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(specdef.solar_spectral_irradiance,
                                  jspecdef.solar_spectral_irradiance)
    assert np.array_equal(t["norm_solar_irradiance"], before) != updated
    assert abs(t["norm_amplitude_solar_irradiance"].sum()) < 1e-15


@pytest.mark.parametrize("multiplier", [0.0, 0.7, -1.3])
def test_calc_incoming_sw_matches_jax(multiplier):
    t, specdef, meta = tecckd.load_ckd_model(FILES["sw"])
    tecckd.read_spectral_solar_cycle(t, specdef, SSI_FILE)
    got = tecckd.calc_incoming_sw(_tensors(t), 1361.0, 5, multiplier)
    ref = jecckd.calc_incoming_sw(t, meta, 1361.0, 5, multiplier)
    assert got.shape == (5, 32)
    _close(got, ref, what="incoming_sw")


def test_calc_incoming_sw_needs_the_solar_cycle():
    t, _, _ = tecckd.load_ckd_model(FILES["sw"])
    with pytest.raises(ValueError, match="solar cycle"):
        tecckd.calc_incoming_sw(_tensors(t), 1361.0, 5, 0.5)


# --- general cloud optics ----------------------------------------------------

def _assert_same_tree(a, b, path="cloud"):
    """A port table tree (numpy leaves) equal to the JAX one."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("per_g", [True, False])
@pytest.mark.parametrize("thick", [True, False])
def test_general_cloud_setup_matches_jax(per_g, thick):
    cfg, jcfg = _configs(do_cloud_aerosol_per_sw_g_point=per_g,
                         do_cloud_aerosol_per_lw_g_point=per_g,
                         use_thick_cloud_spectral_averaging=(thick, thick))
    sd = {b: tecckd.load_ckd_model(f)[1] for b, f in FILES.items()}
    jsd = {b: jecckd.load_ckd_model(f)[1] for b, f in FILES.items()}
    got = tgc.setup_general_cloud_optics(cfg, DATA_DIR, sd["sw"], sd["lw"])
    ref = jgc.setup_general_cloud_optics(jcfg, DATA_DIR, jsd["sw"],
                                         jsd["lw"])
    _assert_same_tree(got, ref)
    nspec = 32 if per_g else None
    assert got["sw"][0]["mass_ext"].shape[0] == (nspec or 5)
    assert got["lw"][1]["mass_ext"].shape[0] == (nspec or 1)


@pytest.fixture(scope="module")
def cloud_tables():
    cfg, _ = _configs()
    sd = {b: tecckd.load_ckd_model(f)[1] for b, f in FILES.items()}
    return tgc.setup_general_cloud_optics(cfg, DATA_DIR, sd["sw"], sd["lw"])


def _cloud_state(ncol=6, nlev=10, seed=3):
    """Cloud fractions with clear layers and layers below the threshold,
    condensate with zeros, effective radii beyond both ends of each type's
    table."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.0, 1.0, (ncol, nlev)) \
        * (rng.uniform(size=(ncol, nlev)) > 0.3)
    frac[0, :3] = (1e-9, 0.0, 1.0)
    mr = rng.uniform(0.0, 1e-3, (ncol, nlev, 2)) \
        * (rng.uniform(size=(ncol, nlev, 2)) > 0.2)
    re = np.stack([rng.uniform(0.5e-6, 60e-6, (ncol, nlev)),
                   rng.uniform(2e-6, 80e-6, (ncol, nlev))], axis=-1)
    p_hl = np.sort(rng.uniform(100.0, 1e5, (ncol, nlev + 1)), axis=1)
    return p_hl, frac, mr, re


CLOUD_CASES = {
    "scattering": dict(),
    "lw_absorption_only": dict(do_lw_cloud_scattering=False),
    "sw_delta_with_gases": dict(do_sw_delta_scaling_with_gases=True),
    "homogeneous": dict(is_homogeneous=True),
}


@pytest.mark.parametrize("case", list(CLOUD_CASES))
def test_general_cloud_optics_matches_jax(cloud_tables, case):
    cfg, jcfg = _configs(**CLOUD_CASES[case])
    p_hl, frac, mr, re = _cloud_state()
    got = tgc.general_cloud_optics(cfg, _tensors(cloud_tables),
                                   *map(torch.as_tensor, (p_hl, frac, mr,
                                                          re)))
    ref = jgc.general_cloud_optics(jcfg, cloud_tables,
                                   *map(jnp.asarray, (p_hl, frac, mr, re)))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == (6, 10, 32), k
        _close(got[k], ref[k], what=k)
    assert float(got["od_sw"].max()) > 0.0


# --- optical properties of the ecCKD configurations ---------------------------

# name -> (Config fields over the flagship's, as names of enum members)
OPTICS_CASES = {
    "ecckd": ECCKD,
    # the flagship's aerosols on: per-g-point aerosol setup and merge
    "ecckd_aerosols": {k: v for k, v in ECCKD.items()
                       if k not in ("use_aerosols", "n_aerosol_types",
                                    "i_aerosol_type_map")},
    # the solar spectrum along the solar cycle (updated spectrum)
    "ecckd_solar_cycle": dict(ECCKD, use_spectral_solar_cycle=True,
                              use_updated_solar_spectrum=True),
}
SOLAR_CYCLE_MULTIPLIER = 0.8


def _port_step(ncol, **over):
    """(config, tables, inputs as keywords, solar irradiance) of the
    flagship's Config with fields replaced, on its meridian inputs."""
    step, args = flagship.build(ncol=ncol, dtype=torch.float64, device="cpu")
    config, tables = setup_radiation(
        flagship.flagship_config("float64").replace(**_enums(tconfig, over)),
        "cpu", torch.float64, data_dir=DATA_DIR)
    return config, tables, dict(zip(ARGS, args)), step.solar


@pytest.mark.parametrize("case", list(OPTICS_CASES))
def test_optical_properties_match_jax(case):
    over = OPTICS_CASES[case]
    jstep, jargs = __graft_entry__._build(
        ncol=8, dtype="float64", nam_overrides=_enums(jconfig, over))
    cycle = SOLAR_CYCLE_MULTIPLIER if case == "ecckd_solar_cycle" else 0.0
    ref = jax.jit(lambda kw: compute_radiative_properties(
        jstep.config, jstep.tables, spectral_solar_cycle_multiplier=cycle,
        **kw))(dict(zip(ARGS, jargs), solar_irradiance=jstep.solar))
    config, tables, kw, solar = _port_step(8, **over)
    assert config.use_aerosols == (case == "ecckd_aerosols")
    assert config.n_bands_sw == config.n_bands_lw == 32
    op = _optical_properties(config, tables, solar_irradiance=solar,
                             spectral_solar_cycle_multiplier=cycle, **kw)
    go, cl = op["go"], op["cl"]
    got = dict(
        od_sw=op["od_sw"], ssa_sw=op["ssa_sw"], asymmetry_sw=op["g_sw_arr"],
        incoming_sw=go.incoming_sw, sw_albedo=op["sw_albedo_diffuse_g"],
        sw_albedo_direct=op["sw_albedo_direct_g"],
        od_lw=op["od_lw"], ssa_lw=op["ssa_lw"], asymmetry_lw=op["g_lw_arr"],
        planck_hl=go.planck_hl,
        lw_emission=go.lw_emission * (1.0 - op["lw_albedo_g"]),
        lw_emissivity=1.0 - op["lw_albedo_g"], cloud_fraction=op["frac"])
    for band in ("sw", "lw"):
        got[f"od_{band}_cloud"] = cl[f"od_{band}"]
        got[f"ssa_{band}_cloud"] = cl[f"ssa_{band}"]
        got[f"asymmetry_{band}_cloud"] = cl[f"g_{band}"]
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], what=k)
    if case == "ecckd_aerosols":     # the aerosols moved the gas optics
        assert float(got["asymmetry_sw"].abs().max()) > 0.1


def test_sw_coefficient_kernels_compile_without_fma():
    """The SW layer coefficients (common.cuh sw_ref_trans) lose up to ~10
    digits near k mu0 = 1, so every source that computes them must round
    as the plain torch version does, without FMA contraction."""
    users = sorted(
        name for name in os.listdir(kernels.CSRC_DIR)
        if name.endswith(".cu") and re.search(
            r"\bsw_ref_trans\s*\(",
            open(os.path.join(kernels.CSRC_DIR, name)).read()))
    assert users == ["spartacus_layer_mats.cu", "sw_fused.cu",
                     "tripleclouds_sw.cu"]
    for name in users:
        assert "-fmad=false" in kernels.SOURCE_FLAGS.get(name, ()), name


# --- mixed gas models ---------------------------------------------------------

NCOL_MIXED = 8
GENERAL_CLOUDS = dict(use_general_cloud_optics=True,
                      do_nearest_spectral_lw_emiss=False)
MIXED = {
    "rrtmg_sw_ecckd_lw": dict(gas_model_lw="ECCKD", **GENERAL_CLOUDS),
    "ecckd_sw_rrtmg_lw": dict(gas_model_sw="ECCKD", **GENERAL_CLOUDS),
    "rrtmg": GENERAL_CLOUDS,
    "ecckd": dict(gas_model_sw="ECCKD", gas_model_lw="ECCKD",
                  **GENERAL_CLOUDS),
}


@pytest.fixture(scope="module")
def mixed_port():
    """Each MIXED configuration's McICA step (flagship aerosols on)."""
    out = {}
    for name, over in MIXED.items():
        config, tables, kw, solar = _port_step(NCOL_MIXED, **over)
        flux = pipeline.radiation_step(config, tables,
                                       solar_irradiance=solar, **kw)
        out[name] = {k: v.numpy() for k, v in flux.fields().items()}
    return out


@pytest.mark.parametrize("name", ["rrtmg_sw_ecckd_lw", "ecckd_sw_rrtmg_lw"])
def test_mixed_gas_models_match_jax(mixed_port, name):
    step, args = __graft_entry__._build(
        ncol=NCOL_MIXED, dtype="float64",
        nam_overrides=_enums(jconfig, MIXED[name]))
    flux = jax.jit(step)(*args)
    got = mixed_port[name]
    assert len(got) == 20
    for k, v in got.items():
        ref = np.asarray(getattr(flux, k))
        assert v.shape == ref.shape, k
        atol = 1e-10 if k in ("lw_derivatives", "cloud_cover_lw",
                              "cloud_cover_sw") else 1e-7
        np.testing.assert_allclose(v, ref, rtol=0, atol=atol, err_msg=k)


def test_mixed_gas_band_sets_independent(mixed_port):
    """Each band set's fluxes equal those of the run that shares its gas
    model (test/ifs test_mixed_gas): SW with SW, LW with LW."""
    for name, sw_from, lw_from in (("rrtmg_sw_ecckd_lw", "rrtmg", "ecckd"),
                                   ("ecckd_sw_rrtmg_lw", "ecckd", "rrtmg")):
        for k, v in mixed_port[name].items():
            ref = mixed_port[sw_from if k.startswith(("sw_", "cloud_cover_sw"))
                             else lw_from][k]
            np.testing.assert_array_equal(v, ref, err_msg=f"{name} {k}")


def test_mixed_gas_models_differ_and_are_sane(mixed_port):
    rr, ck = mixed_port["rrtmg"], mixed_port["ecckd"]
    d_lw = np.abs(rr["lw_up"] - ck["lw_up"]).max()
    d_sw = np.abs(rr["sw_up"] - ck["sw_up"]).max()
    assert 0.05 < d_lw < 20.0, d_lw
    assert 0.05 < d_sw < 30.0, d_sw
    for flux in mixed_port.values():
        for k in ("lw_up", "lw_dn", "sw_up", "sw_dn"):
            assert np.isfinite(flux[k]).all(), k
        olr = flux["lw_up"][:, 0]
        assert (olr > 80.0).all() and (olr < 400.0).all()


def test_ecckd_with_band_wise_cloud_optics():
    """ecCKD gas optics with the band-wise cloud optics (RRTMG bands): the
    port raises at setup; the JAX package runs, indexing the RRTMG-band
    tables with ecCKD's band numbers, and gives non-finite fluxes."""
    from ecrad_torch.interface import setup_radiation as tsetup
    from tests.torch_steps import jax_step
    over = dict(gas_model_sw="ECCKD", gas_model_lw="ECCKD",
                use_general_cloud_optics=False,
                do_nearest_spectral_lw_emiss=False, use_aerosols=False,
                n_aerosol_types=0, i_aerosol_type_map=(),
                sw_solver="TRIPLECLOUDS", lw_solver="TRIPLECLOUDS")
    config = flagship.flagship_config("float64").replace(
        gas_model_sw=tconfig.GasModel.ECCKD,
        gas_model_lw=tconfig.GasModel.ECCKD, use_general_cloud_optics=False,
        use_aerosols=False, n_aerosol_types=0, i_aerosol_type_map=())
    with pytest.raises(NotImplementedError, match="general cloud optics"):
        tsetup(config, "cpu", torch.float64, data_dir=DATA_DIR)
    ref = jax_step(over)
    assert not np.isfinite(ref["sw_up"]).all()
    assert not np.isfinite(ref["lw_up"]).all()
