"""The port's output writers (ecrad_torch/io/output.py, save_extras.py)
against the JAX package's on the same Flux: the same variables,
dimensions and attributes, values equal at the written precision; and
save_inputs' files read back by read_input, surface-first files
included."""

import dataclasses

import numpy as np
import pytest
import torch

from ecrad_tpu.config import Config as JaxConfig
from ecrad_tpu.containers import Flux as JaxFlux
from ecrad_tpu.io import output as joutput
from ecrad_tpu.io import save_extras as jextras
from ecrad_torch import flagship, pipeline
from ecrad_torch.data import MERIDIAN_INPUT
from ecrad_torch.io import output as poutput
from ecrad_torch.io import save_extras as pextras
from ecrad_torch.io.input import _reverse_levels, read_input
from ecrad_torch.optics.spectral import get_sw_mapping
from tests.torch_files import assert_same_files

torch.set_num_threads(2)

SW_DIAG_BOUNDS = (0.2e-6, 0.4e-6, 0.7e-6, 2.0e-6)


def jax_config(config):
    """The JAX package's Config with the port Config's fields (enums by
    member name)."""
    kw = {}
    for f in dataclasses.fields(JaxConfig):
        v = getattr(config, f.name)
        if hasattr(v, "name") and hasattr(v, "value"):
            v = getattr(type(getattr(JaxConfig(), f.name)), v.name)
        kw[f.name] = v
    return JaxConfig(**kw)


@pytest.fixture(scope="module")
def spectral_step():
    """A 4-column float64 step of mcica_rrtmg_spectral on the CPU, with
    the surface spectral fluxes: (config, tables, Flux)."""
    step, args = flagship.build(ncol=4, dtype=torch.float64, device="cpu",
                                config_name="mcica_rrtmg_spectral")
    config = step.config.replace(do_surface_sw_spectral_flux=True)
    flux = pipeline.radiation_step(
        config, step.tables, solar_irradiance=step.solar,
        **dict(zip(flagship.ARG_ORDER, args)))
    return config, step.tables, flux, args[0]


def _write_both(writer, tmp_path, config, flux, *args, **kw):
    """A writer of each package on the same Flux: (port file, JAX file).
    save_sw_diagnostics takes its extra arguments before the Flux."""
    paths = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    jflux = JaxFlux(**{k: v.numpy() for k, v in flux.fields().items()})
    for mod, path, cfg, fl in ((poutput, paths[0], config, flux),
                               (joutput, paths[1], jax_config(config),
                                jflux)):
        if writer == "save_sw_diagnostics":
            getattr(mod, writer)(path, cfg, *args, fl, **kw)
        else:
            getattr(mod, writer)(path, cfg, fl, *args, **kw)
    return paths


@pytest.mark.parametrize("writer", ["save_fluxes", "save_net_fluxes"])
@pytest.mark.parametrize("double_precision", [False, True])
def test_flux_writers(spectral_step, tmp_path, writer, double_precision):
    config, _, flux, phl = spectral_step
    port, jax = _write_both(writer, tmp_path, config, flux, phl.numpy(),
                            experiment_name="exp",
                            double_precision=double_precision)
    worst = assert_same_files(port, jax)
    assert "spectral_flux_up_sw_toa" in worst
    if writer == "save_fluxes":
        assert "spectral_flux_up_lw" in worst       # profiles per band


def test_flux_writer_hdf5(spectral_step, tmp_path):
    pytest.importorskip("h5py")
    config, _, flux, phl = spectral_step
    port, jax = _write_both("save_fluxes", tmp_path, config, flux,
                            phl.numpy(), hdf5=True)
    assert_same_files(port, jax, hdf5=True)


@pytest.mark.parametrize("double_precision", [False, True])
def test_sw_diagnostics(spectral_step, tmp_path, double_precision):
    config, tables, flux, _ = spectral_step
    mapping = get_sw_mapping(tables.specdef_sw, SW_DIAG_BOUNDS,
                             use_bands=True)
    port, jax = _write_both("save_sw_diagnostics", tmp_path, config, flux,
                            SW_DIAG_BOUNDS, mapping,
                            double_precision=double_precision)
    worst = assert_same_files(port, jax)
    assert "flux_dn_direct_sw_surf_clear" in worst


def test_host_flux_copies_once(spectral_step):
    flux = spectral_step[2]
    host = poutput.host_flux(flux)
    assert set(host.fields()) == set(flux.fields())
    assert all(isinstance(v, np.ndarray) for v in host.fields().values())
    assert poutput.host_flux(host).fields().keys() == host.fields().keys()


@pytest.mark.parametrize("surface_first", [False, True])
def test_save_inputs_round_trip(tmp_path, surface_first):
    config = flagship.flagship_config("float64")
    inp = read_input(MERIDIAN_INPUT)
    written = dataclasses.replace(inp)
    if surface_first:
        written = _reverse_levels(dataclasses.replace(inp))
    path = str(tmp_path / "inputs.nc")
    pextras.save_inputs(path, config, written)
    back = read_input(path)
    assert back.flipped == surface_first
    for f in dataclasses.fields(inp):
        a, b = getattr(back, f.name), getattr(inp, f.name)
        if f.name == "thermodynamics":
            for name in ("pressure_hl", "temperature_hl"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
        elif isinstance(b, np.ndarray):
            # gases go through volume mixing ratios: roundoff
            np.testing.assert_allclose(a, b, rtol=1e-14, atol=0.0,
                                       err_msg=f.name)
    # the JAX writer writes the same file, but for the seeds, which it
    # writes in float32 (and so rounds above 2**24)
    jpath = str(tmp_path / "jax_inputs.nc")
    jextras.save_inputs(jpath, jax_config(config), written)
    worst = assert_same_files(path, jpath, atol=np.inf,
                              other_dtype=("iseed",))
    assert all(v == 0.0 for k, v in worst.items() if k != "iseed")


def test_save_general_cloud_optics(tmp_path):
    """The hydrometeor optics dump of general cloud optics (ecCKD), one
    file per type and band set, from each package's setup tables."""
    from ecrad_tpu.interface import setup_radiation as jax_setup
    from ecrad_tpu.io import save_optics as joptics
    from ecrad_torch.data import DATA_DIR
    from ecrad_torch.interface import setup_radiation
    from ecrad_torch.io import save_optics as poptics
    config = flagship.flagship_config("float64", "tripleclouds_ecckd")
    _, tables = setup_radiation(config, "cpu", torch.float64,
                                data_dir=DATA_DIR)
    _, jtables = jax_setup(jax_config(config), data_dir=DATA_DIR)
    poptics.save_general_cloud_optics(str(tmp_path / "port"), tables.cloud)
    joptics.save_general_cloud_optics(str(tmp_path / "jax"), jtables.cloud)
    names = sorted(p.name[len("port"):] for p in tmp_path.glob("port_*"))
    assert names == sorted(p.name[len("jax"):]
                           for p in tmp_path.glob("jax_*"))
    assert len(names) == 2 * len(tables.cloud["type_names"]) >= 4
    for name in names:
        assert_same_files(str(tmp_path / ("port" + name)),
                          str(tmp_path / ("jax" + name)))
