"""Monochromatic gas and cloud optics in the port (GasModel.MONOCHROMATIC,
ecrad_torch/optics/monochromatic.py) against the JAX package (CPU, f64).

* One step per solver (Homogeneous, Cloudless, McICA) and LW Planck form
  (broadband sigma T^4, mono_lw_wavelength -1; single wavelength, 10 um)
  on the meridian columns ``torch_steps.COLUMNS``, as
  ``monochromatic_homogeneous`` with the solver replaced.  Every solver
  runs its kernels' plain versions at one g-point; McICA draws its sample
  at ng = 1, bit-equal to the JAX package's.  The broadband form is held
  to 1e-9 W m-2; the single-wavelength form's fluxes are spectral
  (W m-2 per metre of wavelength, up to ~3e7), so they are held to 1e-13
  of each field's largest value (a few units in the last place of float64;
  ~6e-15 measured).
* The synthetic 20-level state of tests/test_monochromatic.py (night and
  day columns, with and without cloud) through both packages' radiation().
* Mixing monochromatic with another gas model raises in both packages,
  the IFS layer rejects it in both (its UV and PAR weights need a
  spectral definition), and tables_from_numpy takes the JAX package's
  tables without gas tables.
* The offline driver from flagship.namelist_text against the JAX driver on
  the 4-column cut, and the committed reference
  (tests/data/torch_monochromatic_meridian32.npz) against the port.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecrad_tpu import driver as jdriver
from ecrad_tpu.config import Config as JConfig
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.ifs import driver as jifs_driver
from ecrad_tpu.interface import radiation as jradiation
from ecrad_tpu.interface import setup_radiation as jsetup
from ecrad_torch import driver, flagship
from ecrad_torch.config import Config
from ecrad_torch.ifs import driver as ifs_driver
from ecrad_torch.interface import radiation, setup_radiation, \
    tables_from_numpy
from tests.torch_files import (assert_same_files, write_meridian_cut,
                               write_namelist)
from tests.torch_steps import (ATOL_DIMLESS, DIMLESS, FLAGSHIP_FIELDS,
                               assert_fluxes, jax_step, port_step)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
ATOL = 1e-9
RTOL_SPECTRAL = 1e-13
MONO = {k: getattr(v, "name", v) for k, v in
        flagship.CONFIGS["monochromatic_homogeneous"].items()}


@pytest.mark.parametrize("wavelength", [-1.0, 10.0e-6])
@pytest.mark.parametrize("solver", ["HOMOGENEOUS", "CLOUDLESS", "MCICA"])
def test_step_matches_jax(solver, wavelength):
    over = dict(MONO, sw_solver=solver, lw_solver=solver,
                mono_lw_wavelength=wavelength)
    ref, got = jax_step(over), port_step(over)
    if wavelength <= 0.0:
        assert_fluxes(got, ref, FLAGSHIP_FIELDS, atol=ATOL)
        return
    assert set(got) == set(ref) == set(FLAGSHIP_FIELDS)
    for k, r in ref.items():
        atol = (ATOL_DIMLESS if k in DIMLESS
                else RTOL_SPECTRAL * max(np.abs(r).max(), 1.0))
        np.testing.assert_allclose(got[k], r, rtol=0, atol=atol, err_msg=k)
    assert np.abs(ref["lw_up"]).max() > 1e6


def _synthetic(cos_sza, with_cloud):
    """tests/test_monochromatic.py's state: 20 levels, cloud in layers
    12-15 (or none)."""
    ncol, nlev = len(cos_sza), 20
    frac = np.zeros((ncol, nlev))
    if with_cloud:
        frac[:, 12:16] = 0.8
    cloud = {"fraction": frac, "q_liq": frac * 1e-4,
             "q_ice": np.zeros((ncol, nlev)),
             "re_liq": np.full((ncol, nlev), 1e-5),
             "re_ice": np.full((ncol, nlev), 3e-5),
             "overlap_param": np.full((ncol, nlev - 1), 0.8),
             "fractional_std": np.zeros((ncol, nlev))}
    inputs = dict(
        pressure_hl=np.linspace(1.0, 1013e2, nlev + 1)[None].repeat(ncol, 0),
        temperature_hl=np.linspace(220.0, 290.0,
                                   nlev + 1)[None].repeat(ncol, 0),
        gas_mmr=np.zeros((ncol, nlev, 12)), cos_sza=np.asarray(cos_sza),
        skin_temperature=np.full(ncol, 290.0),
        sw_albedo=np.full((ncol, 1), 0.08),
        sw_albedo_direct=np.full((ncol, 1), 0.08),
        lw_emissivity=np.full((ncol, 1), 0.98))
    return inputs, cloud


# tests/test_monochromatic.py's configuration
SYNTHETIC = {"gas_model_name": "Monochromatic",
             "sw_solver_name": "Homogeneous",
             "lw_solver_name": "Homogeneous", "mono_lw_total_od": 1.0,
             "mono_sw_total_od": 0.2, "use_aerosols": False}


@pytest.mark.parametrize("with_cloud", [True, False])
def test_synthetic_state_matches_jax(with_cloud):
    fields = SYNTHETIC
    inputs, cloud = _synthetic([1.0, 0.5, 0.1, 0.0], with_cloud)
    jcfg, jtab = jsetup(JConfig.from_dict(fields), data_dir=DATA_DIR)
    ref = jradiation(jcfg, jtab, solar_irradiance=1366.0,
                     cloud={k: jnp.asarray(v) for k, v in cloud.items()},
                     **{k: jnp.asarray(v) for k, v in inputs.items()})
    cfg, tab = setup_radiation(Config.from_dict(fields), "cpu",
                               torch.float64, data_dir=DATA_DIR)
    got = radiation(cfg, tab, solar_irradiance=1366.0,
                    cloud={k: torch.as_tensor(v) for k, v in cloud.items()},
                    **{k: torch.as_tensor(v) for k, v in inputs.items()})
    got = {k: v.numpy() for k, v in got.fields().items()}
    want = {k: np.asarray(getattr(ref, k)) for k in ref.__dataclass_fields__
            if getattr(ref, k) is not None}
    assert set(got) == set(want)
    for k, r in want.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["sw_dn"][:, 0],
                               [1366.0, 683.0, 136.6, 0.0], rtol=1e-12)


@pytest.mark.parametrize("sw, lw", [("Monochromatic", "RRTMG-IFS"),
                                    ("RRTMG-IFS", "Monochromatic")])
def test_mixed_gas_models_raise(sw, lw):
    fields = {"sw_gas_model_name": sw, "lw_gas_model_name": lw,
              "use_aerosols": False}
    with pytest.raises(NotImplementedError, match="monochromatic"):
        jsetup(JConfig.from_dict(fields), data_dir=DATA_DIR)
    with pytest.raises(NotImplementedError, match="monochromatic"):
        setup_radiation(Config.from_dict(fields), "cpu", torch.float64,
                        data_dir=DATA_DIR)


def test_tables_from_numpy_without_gas_tables():
    _, jtab = jsetup(JConfig.from_dict(SYNTHETIC), data_dir=DATA_DIR)
    assert jtab.gas is None
    tab = tables_from_numpy(jtab, "cpu", torch.float64)
    _, own = setup_radiation(Config.from_dict(SYNTHETIC), "cpu",
                             torch.float64, data_dir=DATA_DIR)
    assert tab.gas is None and own.gas is None
    for name in ("sw_albedo_weights", "lw_emiss_weights", "band_from_g_sw",
                 "band_from_g_lw"):
        assert torch.equal(getattr(tab, name), getattr(own, name)), name


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    return write_meridian_cut(tmp_path_factory.mktemp("mono"))["cut"]


def test_offline_driver_matches_jax(cut, tmp_path):
    nam = write_namelist(str(tmp_path / "mono.nam"),
                         "monochromatic_homogeneous")
    port, ref = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    driver.main([nam, cut, port, "--device", "cpu"])
    jdriver.run(nam, cut, ref)
    worst = assert_same_files(port, ref, atol=ATOL, atol_dimless=ATOL_DIMLESS)
    assert "flux_up_lw" in worst and "flux_dn_sw" in worst


def test_ifs_layer_rejects_monochromatic(cut, tmp_path):
    nam = write_namelist(str(tmp_path / "mono.nam"),
                         "monochromatic_homogeneous")
    with pytest.raises(AttributeError):
        jifs_driver.run_ifs(nam, cut, None, dtype="float64")
    with pytest.raises(NotImplementedError, match="spectral definition"):
        ifs_driver.run_ifs(nam, cut, None, dtype="float64", device="cpu")


def test_reference_file_matches_port():
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu",
                                config_name="monochromatic_homogeneous")
    got = step(*args).fields()
    assert set(got) == set(FLAGSHIP_FIELDS)
    with np.load(os.path.join(DATA, "torch_monochromatic_meridian32.npz")) \
            as z:
        assert {k[4:] for k in z.files if k.startswith("f64/")} == set(got)
        for k, v in got.items():
            atol = ATOL_DIMLESS if k in DIMLESS else ATOL
            np.testing.assert_allclose(v.numpy(), z[f"f64/{k}"], rtol=0,
                                       atol=atol, err_msg=k)
            assert z[f"f32/{k}"].dtype == np.float32, k
