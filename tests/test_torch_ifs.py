"""The port's IFS layer (ecrad_torch/ifs) against the JAX package's
(ecrad_tpu/ifs), on the CPU in float64: the parameterizations and
SpectralPlanck (rtol 1e-13), the NPROMA blocking round trip, the IFS
driver (python -m ecrad_torch.ifs.driver) with and without --bitidentity,
radiation_scheme with VMR gases, blocked against unblocked, and the UV,
PAR and biologically effective UV weights on RRTMG and ecCKD."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecrad_tpu import config as jconfig
from ecrad_tpu.ifs import blocking as jblocking
from ecrad_tpu.ifs import driver as jifs_driver
from ecrad_tpu.ifs import parameterizations as JP
from ecrad_tpu.ifs import scheme as jscheme
from ecrad_tpu.ifs.spectral_planck import SpectralPlanck as JaxPlanck
from ecrad_torch import constants, flagship
from ecrad_torch.config import Config
from ecrad_torch.data import DATA_DIR
from ecrad_torch.ifs import blocking, driver as ifs_driver, scheme
from ecrad_torch.ifs import parameterizations as P
from ecrad_torch.ifs.spectral_planck import SpectralPlanck
from ecrad_torch.io.input import read_input
from tests.torch_files import (assert_same_files, write_meridian_cut,
                               write_namelist)

torch.set_num_threads(2)

RTOL = 1e-13
ATOL, ATOL_DIMLESS = 1e-6, 1e-9
DIMLESS = ("emissivity_out", "lw_derivative")


def _rng_state(seed=11, ncol=5, nlev=6):
    rng = np.random.default_rng(seed)
    return dict(
        pressure=rng.uniform(1e3, 1e5, (ncol, nlev)),
        temperature=rng.uniform(190.0, 310.0, (ncol, nlev)),
        cloud_frac=np.where(rng.uniform(size=(ncol, nlev)) < 0.3, 0.0,
                            rng.uniform(0.0, 1.0, (ncol, nlev))),
        q_liq=rng.uniform(0.0, 1e-3, (ncol, nlev)),
        q_rain=rng.uniform(0.0, 1e-4, (ncol, nlev)),
        q_ice=rng.uniform(0.0, 5e-4, (ncol, nlev)),
        q_snow=rng.uniform(0.0, 1e-4, (ncol, nlev)),
        land_frac=rng.uniform(0.0, 1.0, ncol),
        sin_lat=rng.uniform(-1.0, 1.0, ncol),
        lon=rng.uniform(0.0, 2.0 * np.pi, ncol),
        ccn=rng.uniform(30.0, 1000.0, ncol))


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("nradlp,ccn", [(0, False), (1, False), (2, False),
                                        (2, True)])
def test_liquid_effective_radius(nradlp, ccn):
    s = _rng_state()
    args = [s[k] for k in ("pressure", "temperature", "cloud_frac", "q_liq",
                           "q_rain", "land_frac")]
    ccn_args = (s["ccn"], 0.5 * s["ccn"]) if ccn else (None, None)
    want = JP.liquid_effective_radius(
        *map(jnp.asarray, args),
        *[None if c is None else jnp.asarray(c) for c in ccn_args],
        nradlp=nradlp)
    got = P.liquid_effective_radius(
        *map(_t, args), *[None if c is None else _t(c) for c in ccn_args],
        nradlp=nradlp)
    assert got.shape == s["pressure"].shape
    _close(got, want)


@pytest.mark.parametrize("nradip,nminice", [(0, 1), (1, 1), (2, 1), (3, 1),
                                            (3, 0)])
def test_ice_effective_radius(nradip, nminice):
    s = _rng_state()
    args = [s[k] for k in ("pressure", "temperature", "cloud_frac", "q_ice",
                           "q_snow", "sin_lat")]
    want = JP.ice_effective_radius(*map(jnp.asarray, args), nradip=nradip,
                                   nminice=nminice)
    got = P.ice_effective_radius(*map(_t, args), nradip=nradip,
                                 nminice=nminice)
    _close(got, want)


@pytest.mark.parametrize("ndecolat", [0, 1, 2])
def test_cloud_overlap_decorr_len(ndecolat):
    s = _rng_state()
    want = JP.cloud_overlap_decorr_len(jnp.asarray(s["sin_lat"]), ndecolat)
    got = P.cloud_overlap_decorr_len(_t(s["sin_lat"]), ndecolat)
    for a, b in zip(got, want):
        _close(a, b)


def test_satur():
    s = _rng_state()
    _close(P.satur(_t(s["pressure"]), _t(s["temperature"])),
           JP.satur(jnp.asarray(s["pressure"]),
                    jnp.asarray(s["temperature"])))


@pytest.mark.parametrize("average_over", [None, 3600.0 * np.pi / 43200.0])
def test_cos_solar_zenith_angle(average_over):
    s = _rng_state(ncol=64)
    dec = 0.3
    args = (np.sin(dec), np.cos(dec), 1.1)
    want = JP.cos_solar_zenith_angle(
        jnp.asarray(s["sin_lat"]), jnp.asarray(s["lon"]), *args,
        average_over=average_over)
    got = P.cos_solar_zenith_angle(_t(s["sin_lat"]), _t(s["lon"]), *args,
                                   average_over=average_over)
    assert float(got.max()) > 0.0 and float(got.min()) == 0.0
    _close(got, want)


@pytest.mark.parametrize("bounds,interval_map", [
    ((8.0e-6, 13.0e-6), (1, 2, 1)), ((), (1,)),
    ((5.0e-6, 8.0e-6, 10.0e-6, 13.0e-6), (1, 2, 3, 4, 1))])
def test_spectral_planck(bounds, interval_map):
    t = np.concatenate([np.linspace(140.0, 360.0, 23), [150.0, 200.5]])
    want = JaxPlanck(bounds, interval_map).calc(jnp.asarray(t))
    got = SpectralPlanck(bounds, interval_map).calc(_t(t))
    assert got.shape == (t.size, max(interval_map))
    _close(got, want)


def test_blocking_round_trip():
    rng = np.random.default_rng(2)
    ncol, nproma = 11, 4
    kw = dict(a=rng.uniform(size=(ncol, 3)), b=rng.uniform(size=ncol),
              c=rng.uniform(size=(ncol, 2, 5)), scalar=1.5,
              other=rng.uniform(size=7))
    zrgp, table, scalars = blocking.copy_inputs_to_blocked(kw, ncol, nproma)
    jz, jtable, jscalars = jblocking.copy_inputs_to_blocked(kw, ncol, nproma)
    np.testing.assert_array_equal(zrgp, jz)
    assert table == jtable and set(scalars) == set(jscalars)
    assert zrgp.shape == (3, nproma, 3 + 1 + 10)
    blocks = [blocking.block_kwargs(zrgp[b], table, scalars)
              for b in range(zrgp.shape[0])]
    back = blocking.copy_fluxes_from_blocked(
        [{k: v for k, v in blk.items() if k in ("a", "b", "c")}
         for blk in blocks], ncol)
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(back[k], kw[k])
    # the last block is padded with the last column
    np.testing.assert_array_equal(blocks[-1]["a"][-1], kw["a"][-1])


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The 4-column cut of the meridian file and the flagship namelist."""
    d = tmp_path_factory.mktemp("ifs")
    return (write_meridian_cut(d)["cut"],
            write_namelist(str(d / "config.nam")))


def _compare(got, want):
    assert set(got) == {k for k in want if k != "_flux"} | {"_flux"}
    for k, v in want.items():
        if k == "_flux":
            continue
        bar = ATOL_DIMLESS if k in DIMLESS else ATOL
        assert np.abs(np.asarray(got[k]) - np.asarray(v)).max() <= bar, k


@pytest.mark.parametrize("bitidentity", [True, False])
def test_run_ifs_against_jax(cut, tmp_path, bitidentity):
    path, nam = cut
    out = str(tmp_path / "out.nc")
    got = ifs_driver.run_ifs(nam, path, out, bitidentity=bitidentity,
                             device="cpu")
    want = jifs_driver.run_ifs(nam, path, str(tmp_path / "jax.nc"),
                               bitidentity=bitidentity)
    _compare(got, want)
    assert_same_files(out, str(tmp_path / "jax.nc"), ATOL, ATOL_DIMLESS)


def test_nproma_blocked_against_unblocked(cut, tmp_path):
    """Blocks of 3 columns (the last padded) against one call over the 4
    columns, in memory and through the command line's output file."""
    path, nam = cut
    whole_nc, blocked_nc = str(tmp_path / "whole.nc"), str(tmp_path / "b.nc")
    whole = ifs_driver.run_ifs(nam, path, whole_nc, device="cpu")
    ifs_driver.main([nam, path, blocked_nc, "--nproma", "3",
                     "--device", "cpu"])
    assert_same_files(blocked_nc, whole_nc, 1e-9, 1e-9)
    blocked = ifs_driver.run_ifs(nam, path, nproma=3, device="cpu")
    for k, v in whole.items():
        if k == "_flux":
            for name, f in v.fields().items():
                np.testing.assert_allclose(blocked[k].fields()[name], f,
                                           rtol=0, atol=1e-9)
            continue
        np.testing.assert_allclose(blocked[k], v, rtol=0, atol=1e-9)


def _scheme_kwargs(path):
    """run_ifs's inputs for radiation_scheme from an input file, the
    gases as volume mixing ratios."""
    inp = read_input(path)
    g = inp.gas_mmr
    vmr = {arg: g[:, :, constants.GAS_INDEX[name]]
           * (constants.MOLAR_MASS_DRY_AIR / constants.MOLAR_MASS[name])
           for arg, name in ifs_driver.GAS_FIELDS}
    phl = inp.thermodynamics.pressure_hl
    thl = inp.thermodynamics.temperature_hl
    zeros = np.zeros_like(inp.cloud_fraction)
    return inp, dict(
        mu0=inp.cos_sza, skin_temperature=inp.skin_temperature,
        albedo_diffuse=inp.sw_albedo, albedo_direct=inp.sw_albedo_direct,
        spectral_emissivity=inp.lw_emissivity,
        sin_lat=np.linspace(-0.5, 0.8, inp.ncol),
        lon=np.linspace(0.1, 3.0, inp.ncol), land_frac=zeros[:, 0] + 0.7,
        pressure_fl=0.5 * (phl[:, :-1] + phl[:, 1:]),
        temperature_fl=0.5 * (thl[:, :-1] + thl[:, 1:]),
        pressure_hl=phl, temperature_hl=thl,
        cloud_frac=inp.cloud_fraction,
        q_liquid=inp.cloud_mixing_ratio[:, :, 0],
        q_ice=inp.cloud_mixing_ratio[:, :, 1], q_rain=zeros, q_snow=zeros,
        aerosol_mmr=inp.aerosol_mmr, **vmr)


def test_radiation_scheme_vmr_against_jax(cut):
    path, nam = cut
    inp, kw = _scheme_kwargs(path)
    config = Config.from_namelist(nam)
    port = scheme.setup_radiation_scheme(config, "cpu", torch.float64)
    got = scheme.radiation_scheme(
        port, solar_irradiance=inp.solar_irradiance, gas_units="vmr",
        iseed=torch.as_tensor(inp.iseed), **{k: _t(v) for k, v in kw.items()})
    jax = jscheme.setup_radiation_scheme(jconfig.Config.from_namelist(nam))
    want = jscheme.radiation_scheme(
        jax, solar_irradiance=inp.solar_irradiance, gas_units="vmr",
        iseed=jnp.asarray(inp.iseed),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    _compare(got, want)


@pytest.mark.parametrize("config_name", ["mcica_rrtmg", "ecckd_mcica"])
def test_uv_par_weights(config_name):
    """setup_radiation_scheme's UV, PAR (and, on ecCKD, biologically
    effective UV) weights against the JAX package's."""
    config = flagship.flagship_config("float64", config_name).replace(
        directory_name=DATA_DIR)
    port = scheme.setup_radiation_scheme(config, "cpu", torch.float64)
    kw = {k: (getattr(jconfig, type(v).__name__)[v.name]
              if hasattr(v, "name") and hasattr(v, "value") else v)
          for k, v in vars(config).items()}
    jax = jscheme.setup_radiation_scheme(jconfig.Config(**kw))
    names = ("iband_uv", "weight_uv", "iband_par", "weight_par",
             "ig_uv_bio", "weight_uv_bio")
    for name in names:
        a, b = getattr(port, name), getattr(jax, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.ig_uv_bio is not None) == (config_name == "ecckd_mcica")
    assert port.config.do_surface_sw_spectral_flux


class _Captured(Exception):
    pass


def _capture_radiation(monkeypatch, module, store):
    """Replace a scheme module's radiation() by one that records its
    keyword arguments and stops the scheme."""
    def fake(config, tables, **kw):
        store.update(kw)
        raise _Captured
    monkeypatch.setattr(module, "radiation", fake)


def test_radiation_scheme_spartacus_inputs(cut, monkeypatch):
    """What radiation_scheme derives for SPARTACUS (the cloud effective
    sizes from the separation scales, host numpy) and hands to
    radiation(), against the JAX package's: the same cloud, gas and
    surface inputs."""
    path, _ = cut
    inp, kw = _scheme_kwargs(path)
    config = flagship.flagship_config("float64", "spartacus_3d").replace(
        directory_name=DATA_DIR)
    port = scheme.setup_radiation_scheme(config, "cpu", torch.float64)
    jkw = {k: (getattr(jconfig, type(v).__name__)[v.name]
               if hasattr(v, "name") and hasattr(v, "value") else v)
           for k, v in vars(config).items()}
    jax = jscheme.setup_radiation_scheme(jconfig.Config(**jkw))
    got, want = {}, {}
    _capture_radiation(monkeypatch, scheme, got)
    _capture_radiation(monkeypatch, jscheme, want)
    with pytest.raises(_Captured):
        scheme.radiation_scheme(
            port, solar_irradiance=inp.solar_irradiance, gas_units="vmr",
            **{k: _t(v) for k, v in kw.items()})
    with pytest.raises(_Captured):
        jscheme.radiation_scheme(
            jax, solar_irradiance=inp.solar_irradiance, gas_units="vmr",
            **{k: jnp.asarray(v) for k, v in kw.items()})
    assert set(got) == set(want)
    assert set(got["cloud"]) == set(want["cloud"])
    assert "inv_cloud_effective_size" in got["cloud"]
    for k, v in want["cloud"].items():
        _close(got["cloud"][k], v)
    for k, v in want.items():
        if k not in ("cloud", "aerosol"):
            _close(got[k], v)
    _close(got["aerosol"]["mixing_ratio"], want["aerosol"]["mixing_ratio"])
