"""The port's offline driver (python -m ecrad_torch.driver) against the JAX
package's (ecrad_tpu.driver) in process, on the CPU in float64: the same
output files (names, dimensions, attributes; values within 1e-6 W m-2,
1e-9 for the dimensionless fields) on a 4-column cut of the meridian file
that the test writes, for both McICA generators and the driver's flags;
and the 32 meridian columns against the committed JAX driver outputs
(tests/data/torch_driver_meridian32.npz)."""

import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from ecrad_tpu import driver as jdriver
from ecrad_torch import driver, flagship
from ecrad_torch.data import MERIDIAN_INPUT
from ecrad_torch.io.input import DriverConfig, read_input
from tests.torch_files import (CUT_COLUMNS, assert_same_files,
                               write_meridian_cut, write_namelist)

torch.set_num_threads(2)

ATOL, ATOL_DIMLESS = 1e-6, 1e-9
# the optical-property dump: optical depths reach 1e4 and Planck
# functions 1e2, so the bar is relative there
PROPERTIES_RTOL = 1e-10
SW_DIAG_BOUNDS = (0.2e-6, 0.4e-6, 0.7e-6, 2.0e-6)
# case -> (input, generator, &radiation extras, &radiation_driver extras,
#          files written besides the output)
CASES = {
    "exact_dumps": ("cut", "exact", ("do_save_radiative_properties",),
                    dict(do_save_inputs=True, do_save_aerosol_optics=True,
                         sw_diag_wavelength_bound=SW_DIAG_BOUNDS),
                    ("inputs.nc", "aerosol_optics.nc", "sw_diagnostics.nc",
                     "radiative_properties.nc")),
    "device_net_fluxes": ("cut", "device", (),
                          dict(do_save_net_fluxes=True), ()),
    "surface_first": ("flipped", "exact", (), {}, ()),
    "corrected": ("corrupted", "exact", (),
                  dict(do_correct_unphysical_inputs=True), ()),
}
FILES = [(case, f) for case, spec in CASES.items()
         for f in ("output.nc",) + spec[4]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return write_meridian_cut(tmp_path_factory.mktemp("inputs"))


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Each case run by both drivers, lazily: {case: (port dir, JAX
    dir)}, each holding the files written."""
    done = {}

    def get(case):
        if case not in done:
            inp, generator, radiation, driver_kw, _ = CASES[case]
            dirs = []
            for pkg in ("port", "jax"):
                d = tmp_path_factory.mktemp(f"{case}_{pkg}")
                nam = write_namelist(str(d / "config.nam"),
                                     radiation=radiation, **driver_kw)
                cwd = os.getcwd()
                os.chdir(d)          # the dumps go to the working directory
                try:
                    if pkg == "port":
                        driver.main([nam, inputs[inp], "output.nc",
                                     "--generator", generator,
                                     "--device", "cpu"])
                    else:
                        jdriver.run(nam, inputs[inp], "output.nc",
                                    generator=generator)
                finally:
                    os.chdir(cwd)
                dirs.append(d)
            done[case] = dirs
        return done[case]

    return get


@pytest.mark.parametrize("case,fname", FILES,
                         ids=[f"{c}-{f[:-3]}" for c, f in FILES])
def test_driver_files(runs, case, fname):
    port_dir, jax_dir = runs(case)
    port, jax = str(port_dir / fname), str(jax_dir / fname)
    if fname == "radiative_properties.nc":
        a = assert_same_files(port, jax, atol=np.inf, atol_dimless=np.inf)
        with netcdf_file(jax, "r", mmap=False) as f:
            scale = {k: float(np.abs(v.data).max())
                     for k, v in f.variables.items()}
        for name, err in a.items():
            assert err <= PROPERTIES_RTOL * max(scale[name], 1.0), name
        assert "od_lw_cloud" in a and "planck_hl" in a
        return
    if fname == "inputs.nc":
        # the JAX package writes the seeds in float32, which rounds them
        worst = assert_same_files(port, jax, ATOL, ATOL_DIMLESS,
                                  other_dtype=("iseed",))
        with netcdf_file(port, "r", mmap=False) as f:
            seeds = np.array(f.variables["iseed"].data)
        np.testing.assert_array_equal(
            seeds, read_input(MERIDIAN_INPUT).iseed[CUT_COLUMNS])
        return
    worst = assert_same_files(port, jax, ATOL, ATOL_DIMLESS)
    if fname == "output.nc":
        assert ("flux_net_sw" if case == "device_net_fluxes"
                else "cloud_cover_sw") in worst


def test_uncorrected_input_raises(inputs, tmp_path):
    nam = write_namelist(str(tmp_path / "config.nam"))
    out = str(tmp_path / "out.nc")
    with pytest.raises(ValueError) as ej:
        jdriver.run(nam, inputs["corrupted"], out)
    with pytest.raises(ValueError) as ep:
        driver.run(nam, inputs["corrupted"], out, device="cpu")
    assert str(ep.value) == str(ej.value)
    assert not os.path.exists(out)


@pytest.mark.parametrize("entry", ["driver", "ifs"])
def test_cuda_is_the_default_device(inputs, tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from ecrad_torch.ifs import driver as ifs_driver
    main = driver.main if entry == "driver" else ifs_driver.main
    nam = write_namelist(str(tmp_path / "config.nam"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([nam, inputs["cut"], str(tmp_path / "out.nc")])
    assert not os.path.exists(str(tmp_path / "out.nc"))


@pytest.mark.parametrize("config_name,dtype", [
    ("mcica_rrtmg", "float64"), ("mcica_rrtmg", "float32"),
    ("tripleclouds_rrtmg", "float64"), ("tripleclouds_rrtmg", "float32")])
def test_meridian32_against_reference(tmp_path, config_name, dtype):
    """The 32 meridian columns against the JAX driver's output files
    (tools/make_torch_reference.py driver): float64 within 1e-6 W m-2,
    float32 within ecRad's 0.5 W m-2 of the JAX float32 run."""
    nam = write_namelist(str(tmp_path / "config.nam"), config_name)
    out = str(tmp_path / "out.nc")
    driver.run(nam, MERIDIAN_INPUT, out, dtype=dtype, device="cpu")
    tag = "f64" if dtype == "float64" else "f32"
    atol, atol_dimless = (ATOL, ATOL_DIMLESS) if tag == "f64" else (0.5,
                                                                     1e-4)
    with np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_driver_meridian32.npz")) as z:
        prefix = f"{config_name}/{tag}/"
        ref = {k[len(prefix):]: z[k] for k in z.files
               if k.startswith(prefix)}
    with netcdf_file(out, "r", mmap=False) as f:
        got = {k: np.array(v.data) for k, v in f.variables.items()}
    assert set(got) == set(ref)
    for name, v in got.items():
        bar = atol_dimless if name in ("lw_derivative", "cloud_cover_lw",
                                       "cloud_cover_sw") else atol
        assert np.abs(v - ref[name]).max() <= bar, name


def test_driver_settings_reach_read_input(inputs, tmp_path):
    """The namelist's cloud separation scales are the flagship's."""
    nam = write_namelist(str(tmp_path / "config.nam"))
    assert DriverConfig.from_namelist(nam) == DriverConfig(
        **flagship.DRIVER_SETTINGS, iverbose=1,
        do_write_double_precision=True)


@pytest.mark.parametrize("config_name", list(flagship.CONFIGS))
def test_namelist_reads_back_as_the_configuration(tmp_path, config_name):
    """flagship.namelist_text makes each named configuration reachable
    through the drivers' namelist."""
    from ecrad_torch.config import Config
    from ecrad_torch.data import DATA_DIR
    nam = write_namelist(str(tmp_path / "config.nam"), config_name)
    want = flagship.flagship_config("float32", config_name).replace(
        directory_name=DATA_DIR)
    assert Config.from_namelist(nam) == want


def test_profiling_hooks(inputs, tmp_path, capsys):
    """With profiling on, the driver's stages are timed under their hook
    names and the profile is printed."""
    from ecrad_torch import profiling
    nam = write_namelist(str(tmp_path / "config.nam"))
    profiling.enable()
    profiling.reset()
    try:
        driver.run(nam, inputs["cut"], str(tmp_path / "out.nc"),
                   nrepeat=2, device="cpu")
        prof = profiling.get_profile()
    finally:
        profiling.enable(False)
        profiling.reset()
    for name in ("radiation_interface:setup_radiation",
                 "radiation_interface:setup_gas_optics",
                 "radiation_interface:setup_cloud_optics",
                 "radiation_interface:setup_aerosol_optics",
                 "radiation_interface:setup_pdf_sampler",
                 "ecrad_driver:read_input", "ecrad_driver:check_inputs",
                 "ecrad_driver:cloud_generator_exact",
                 "ecrad_driver:copy_to_device", "ecrad_driver:radiation",
                 "ecrad_driver:save_fluxes"):
        assert prof[name][0] >= 1 and prof[name][1] >= 0.0, name
        assert 0.0 <= prof[name][2] <= prof[name][1], name
    assert prof["ecrad_driver:radiation"][0] == 1
    # the set-up's tables are hooks of their own inside it
    setup = prof["radiation_interface:setup_radiation"]
    assert setup[2] < setup[1]
    assert "Profiling information (DR_HOOK=1)" in capsys.readouterr().out


def test_nested_hooks_report_self_time(monkeypatch, capsys):
    """A hook's self time leaves out the time of the hooks opened inside
    it, in the profile and in print_profile's self(s) column."""
    from ecrad_torch import profiling
    # outer opens at 0; inner at 1-3 and 4-8; outer closes at 10
    clock = iter([0.0, 1.0, 3.0, 4.0, 8.0, 10.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    profiling.enable()
    profiling.reset()
    try:
        with profiling.hook("outer"):
            for _ in range(2):
                with profiling.hook("inner"):
                    pass
        prof = profiling.get_profile()
        profiling.print_profile()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert prof == {"outer": (1, 10.0, 4.0), "inner": (2, 6.0, 6.0)}
    rows = {line.split()[-1]: line.split()
            for line in capsys.readouterr().out.splitlines()
            if line.endswith(("outer", "inner"))}
    assert rows["outer"][1:4] == ["10.0000", "4.0000", "1"]
    assert rows["inner"][1:4] == ["6.0000", "6.0000", "2"]
