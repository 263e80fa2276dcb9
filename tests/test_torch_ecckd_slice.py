"""The port's ecCKD configurations end to end against the JAX package
(CPU, f64): ``tripleclouds_ecckd`` and ``ecckd_mcica`` (the overrides of
``tools/bench_matrix.py`` CONFIGS: ecCKD gas optics at 32 g-points in
both band sets, general cloud optics per g-point, no aerosols) on the 32
bundled meridian columns, 137 levels.

* The port's Configs against the JAX overrides.
* Each step against ``__graft_entry__._build`` with the same overrides:
  within 1e-7 W m-2 for fluxes (measured ~2e-10), 1e-10 for the LW
  derivatives and cloud cover.
* Blocking changes nothing; the committed references that chip_smoke.py
  holds the GPU to still match the JAX package (the McICA one with its
  float32 stochastic sample at 32 g-points); Tripleclouds draws no sample.
* SPARTACUS on ecCKD takes the natural g order: one step on a window of
  levels of a few columns against the JAX package.
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
from ecrad_torch.data import DATA_DIR
from ecrad_torch.interface import _spartacus_perm, setup_radiation
from tests.torch_steps import window

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
ECCKD = dict(gas_model_sw_name="ECCKD", gas_model_lw_name="ECCKD",
             use_general_cloud_optics=True,
             do_nearest_spectral_lw_emiss=False, use_aerosols=False,
             n_aerosol_types=0, i_aerosol_type_map=())
# configuration -> (overrides as tools/bench_matrix.py gives them,
# reference file)
CASES = {
    "tripleclouds_ecckd": (dict(sw_solver_name="Tripleclouds",
                                lw_solver_name="Tripleclouds", **ECCKD),
                           "torch_tripleclouds_ecckd_meridian32.npz"),
    "ecckd_mcica": (ECCKD, "torch_ecckd_mcica_meridian32.npz"),
}
# Same algorithm in f64 (measured ~2e-10 W m-2 apart); a gap above 1e-7
# W m-2 would be a bug.  Dimensionless fields: 1e-10.
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
RTOL_BLOCKED = 1e-12
# the committed files, written by the same JAX code (possibly compiled for
# another CPU)
RTOL_FILE, ATOL_FILE = 1e-12, 1e-9


def _resolved(overrides):
    from tools.bench_matrix import _resolve
    return _resolve(overrides)


def _fields(flux):
    return {k: np.asarray(getattr(flux, k))
            for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


@pytest.fixture(scope="module")
def jax_f64():
    out = {}
    for name, (over, _) in CASES.items():
        step, args = __graft_entry__._build(
            ncol=32, dtype="float64", nam_overrides=_resolved(over))
        out[name] = _fields(jax.jit(step)(*args))
    return out


@pytest.fixture(scope="module")
def port_f64():
    out = {}
    for name in CASES:
        step, args = flagship.build(ncol=32, dtype=torch.float64,
                                    device="cpu", config_name=name)
        out[name] = {k: v.numpy() for k, v in step(*args).fields().items()}
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_ecckd_config_matches_jax(name):
    port = flagship.flagship_config("float64", name)
    assert port.gas_model_sw == port.gas_model_lw == tconfig.GasModel.ECCKD
    over = _resolved(CASES[name][0])
    for f in dataclasses.fields(port):
        a = getattr(port, f.name)
        b = over.get(f.name, getattr(flagship.flagship_config("float64"),
                                     f.name))
        if hasattr(b, "name"):
            a, b = a.name, b.name
        assert a == b, f.name


@pytest.mark.parametrize("name", list(CASES))
def test_ecckd_setup_per_g_point(name):
    """32 g-points and, per g-point, 32 bands in both band sets; the
    fused kernels' gate holds (band-contiguous g axis)."""
    step, _ = flagship.build(ncol=2, dtype=torch.float64, device="cpu",
                             config_name=name)
    cfg, tab = step.config, step.tables
    assert cfg.n_g_sw == cfg.n_g_lw == cfg.n_bands_sw == cfg.n_bands_lw == 32
    for bfg in (tab.band_from_g_sw, tab.band_from_g_lw):
        assert torch.equal(bfg, torch.arange(32))
    assert tab.cloud["type_names"] == ["mie_droplet",
                                       "baum-general-habit-mixture_ice"]
    assert tab.aerosol is None and tab.gas_meta["sw"]["ng"] == 32


@pytest.mark.parametrize("name", list(CASES))
def test_ecckd_slice_matches_jax(jax_f64, port_f64, name):
    got_all, ref_all = port_f64[name], jax_f64[name]
    assert set(got_all) == set(ref_all)
    assert len(got_all) == 20
    for k, ref in ref_all.items():
        got = got_all[k]
        assert got.shape == ref.shape, k
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ecckd_blocked_equals_unblocked(port_f64, name):
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                block_size=12, config_name=name)
    blocked = {k: v.numpy() for k, v in step(*args).fields().items()}
    assert set(blocked) == set(port_f64[name])
    for k, ref in port_f64[name].items():
        np.testing.assert_allclose(blocked[k], ref, rtol=RTOL_BLOCKED,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ecckd_reference_file_matches_jax(jax_f64, name):
    with np.load(os.path.join(DATA, CASES[name][1])) as z:
        files = set(z.files)
        ref_all = jax_f64[name]
        assert {f"f64/{k}" for k in ref_all} <= files
        assert {f"f32/{k}" for k in ref_all} <= files
        for k, ref in ref_all.items():
            np.testing.assert_allclose(z[f"f64/{k}"], ref, rtol=RTOL_FILE,
                                       atol=ATOL_FILE, err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32, k
        sample = {k for k in files if k.startswith("f32_sample/")}
        if name == "ecckd_mcica":
            for k in ("od_scaling_sw", "od_scaling_lw"):
                a = z[f"f32_sample/{k}"]
                assert a.dtype == np.float32 and a.shape == (32, 137, 32)
            assert len(sample) == 4
        else:
            assert not sample


def test_tripleclouds_ecckd_draws_no_sample():
    step, args = flagship.build(ncol=4, dtype=torch.float64, device="cpu",
                                config_name="tripleclouds_ecckd")
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    out = pipeline.add_cloud_sample(step.config, step.tables, cloud)
    assert set(out) == set(cloud)


# --- SPARTACUS on ecCKD --------------------------------------------------------

NCOL_SP, LEVELS_SP = 4, slice(88, 100)      # a window with cloudy layers
SPARTACUS = dict(sw_solver_name="SPARTACUS", lw_solver_name="SPARTACUS",
                 do_3d_effects=True, do_sw_delta_scaling_with_gases=False,
                 **ECCKD)


def test_spartacus_ecckd_step_matches_jax():
    over = _resolved(SPARTACUS)
    jstep, jargs = __graft_entry__._build(ncol=NCOL_SP, dtype="float64",
                                          nam_overrides=over)
    jw = window(jargs, LEVELS_SP, jax.numpy.asarray)
    assert float(np.asarray(jw[-2]["fraction"]).max()) > 0.1
    ref = _fields(jax.jit(jstep)(*jw))

    kw = {k: (tconfig.GasModel.ECCKD if k.startswith("gas_model")
              else tconfig.Solver.SPARTACUS if k.endswith("_solver") else v)
          for k, v in over.items()}
    config, tables = setup_radiation(
        flagship.flagship_config("float64").replace(**kw), "cpu",
        torch.float64, data_dir=DATA_DIR)
    for is_sw in (True, False):
        np.testing.assert_array_equal(_spartacus_perm(config, is_sw),
                                      np.arange(32))
    _, args = flagship.build(ncol=NCOL_SP, dtype=torch.float64,
                             device="cpu")
    kwargs = dict(zip(flagship.ARG_ORDER,
                      window(args, LEVELS_SP, torch.as_tensor)))
    got = pipeline.radiation_step(config, tables, solar_irradiance=jstep.solar,
                                  **kwargs).fields()
    assert set(got) == set(ref)
    for k, r in ref.items():
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, atol=atol,
                                   err_msg=k)
