"""The port stands alone: ecrad_torch (and chip_smoke.py, which runs it on
the GPU) imports neither JAX nor the JAX package, and its own host setup
reproduces the JAX package's tables exactly."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecrad_tpu.config import Config as JaxConfig
from ecrad_tpu.data import DATA_DIR
from ecrad_tpu.interface import setup_radiation as jax_setup
from ecrad_torch import flagship
from ecrad_torch.interface import Tables, setup_radiation, tables_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
before = set(sys.modules)
sys.path.insert(0, {repo!r})
import ecrad_torch, ecrad_torch.flagship, ecrad_torch.pipeline
import ecrad_torch.kernels, ecrad_torch.solvers.cuda_mcica
import ecrad_torch.solvers.tripleclouds, ecrad_torch.solvers.cuda_tripleclouds
import ecrad_torch.solvers.cuda_adding, ecrad_torch.solvers.cloudless
import ecrad_torch.solvers.matrix, ecrad_torch.solvers.spartacus
import ecrad_torch.solvers.cuda_spartacus
import ecrad_torch.optics.ecckd, ecrad_torch.optics.general_cloud
import ecrad_torch.optics.aerosol_description
import ecrad_torch.containers, ecrad_torch.solvers.outputs
import ecrad_torch.solvers.adding, ecrad_torch.solvers.mcica
import ecrad_torch.driver, ecrad_torch.gas, ecrad_torch.check
import ecrad_torch.profiling, ecrad_torch.native
import ecrad_torch.solvers.cloud_generator_exact
import ecrad_torch.io.output, ecrad_torch.io.save_optics
import ecrad_torch.io.save_extras
import ecrad_torch.ifs, ecrad_torch.ifs.driver, ecrad_torch.ifs.scheme
import ecrad_torch.ifs.blocking
import ecrad_torch.optics.monochromatic, ecrad_torch.distributed
import ecrad_torch.utils
import ecrad_torch.evaluate.compare_output, ecrad_torch.evaluate.plot_input
import chip_smoke
new = set(sys.modules) - before
bad = sorted(m for m in new
             if m.split(".")[0] in ("jax", "jaxlib", "ecrad_tpu"))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_port_sources_import_no_jax():
    """Nor inside a function: no import statement of the port's sources
    (and of chip_smoke.py) names JAX or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ecrad_tpu)\b",
                         re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, files in os.walk(os.path.join(REPO, "ecrad_torch"))
        for f in files if f.endswith(".py")]
    assert len(sources) > 50
    bad = [p for p in sources if pattern.search(open(p).read())]
    assert not bad, bad


def test_native_holds_no_binary():
    """The native generator's directory holds its source and loader only:
    the library is built into build/ecrad_torch/."""
    files = set(os.listdir(os.path.join(REPO, "ecrad_torch", "native")))
    assert files - {"__pycache__"} == {"__init__.py", "cloud_generator.cc"}


def _assert_same(a, b, path="tables"):
    """Leaf-for-leaf equality of a port table tree against another."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(b):
        assert torch.is_tensor(a), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


def _same_config(port, jax):
    for f in dataclasses.fields(jax):
        a, b = getattr(port, f.name), getattr(jax, f.name)
        if hasattr(b, "name") and hasattr(b, "value"):     # enums
            a, b = (a.name, a.value), (b.name, b.value)
        assert a == b, f.name


SPECDEF_ARRAYS = ("wavenumber1", "wavenumber2", "gpoint_fraction",
                  "wavenumber1_band", "wavenumber2_band", "band_number")


def _setup_both(config):
    """setup_radiation of the port and of the JAX package for the same
    port Config: (port config, port tables, JAX config, JAX tables)."""
    port_config, port_tables = setup_radiation(config, "cpu", torch.float64,
                                               data_dir=DATA_DIR)
    kw = {f.name: getattr(config, f.name)
          for f in dataclasses.fields(JaxConfig)}
    kw = {k: (getattr(type(getattr(JaxConfig(), k)), v.name)
              if hasattr(v, "name") and hasattr(v, "value") else v)
          for k, v in kw.items()}
    jax_config, jax_tables = jax_setup(JaxConfig(**kw), data_dir=DATA_DIR)
    _same_config(port_config, jax_config)
    assert isinstance(port_tables, Tables)
    converted = tables_from_numpy(jax_tables, "cpu", torch.float64)
    for name in Tables._fields:
        if name.startswith("specdef"):
            # host objects of each package: the same arrays
            for attr in SPECDEF_ARRAYS:
                np.testing.assert_array_equal(
                    getattr(getattr(port_tables, name), attr),
                    getattr(getattr(jax_tables, name), attr),
                    err_msg=f"{name}.{attr}")
            continue
        _assert_same(getattr(port_tables, name), getattr(converted, name),
                     name)
    return port_config, port_tables, jax_config, jax_tables


def test_setup_radiation_matches_jax_exactly():
    _, port_tables, _, jax_tables = _setup_both(
        flagship.flagship_config("float64"))
    # the conversion keeps integer index arrays integer
    assert port_tables.band_from_g_lw.dtype == torch.int64
    np.testing.assert_array_equal(port_tables.band_from_g_sw.numpy(),
                                  np.asarray(jax_tables.band_from_g_sw))


# the ecCKD configurations, and ecckd_mcica with the flagship's aerosols
# (per g-point) and the solar cycle with the updated solar spectrum
ECCKD_SETUPS = {
    "tripleclouds_ecckd": {},
    "ecckd_mcica": {},
    "ecckd_mcica_aerosols_solar_cycle": dict(
        use_aerosols=True, n_aerosol_types=12,
        i_aerosol_type_map=(-1, -2, -3, 7, 8, 9, -4, 10, 11, 11, -5, 14),
        use_spectral_solar_cycle=True, use_updated_solar_spectrum=True),
}


@pytest.mark.parametrize("case", list(ECCKD_SETUPS))
def test_setup_radiation_matches_jax_exactly_ecckd(case):
    name = case if case in flagship.CONFIGS else "ecckd_mcica"
    config = flagship.flagship_config("float64", name).replace(
        **ECCKD_SETUPS[case])
    port_config, port_tables, _, _ = _setup_both(config)
    assert port_config.n_g_sw == port_config.n_bands_sw == 32
    assert set(port_tables.gas) == {"sw", "lw"}
    assert port_tables.gas_meta["lw"]["gases"][1]["name"] == "h2o"
    assert (port_tables.aerosol is not None) == ("aerosols" in case)
    assert ("norm_amplitude_solar_irradiance" in port_tables.gas["sw"]) \
        == ("solar_cycle" in case)


# band-wise cloud optics models and aerosol types by name
BANDWISE_SETUPS = {
    "tripleclouds_baran2016": {},
    "baran2017_yi_names": dict(
        ice_model="BARAN2017", n_aerosol_types=0, i_aerosol_type_map=(),
        aerosol_type_name=("SS,bin=1,philic", "DD,bin=2", "SU"),
        aerosol_preferred_optical_model=("DD:Woodward2001",)),
    "yi": dict(ice_model="YI"),
}


@pytest.mark.parametrize("case", list(BANDWISE_SETUPS))
def test_setup_radiation_matches_jax_exactly_bandwise(case):
    from ecrad_torch.config import IceModel
    over = dict(BANDWISE_SETUPS[case])
    if "ice_model" in over:
        over["ice_model"] = IceModel[over["ice_model"]]
    config = flagship.flagship_config(
        "float64", "tripleclouds_baran2016").replace(**over)
    port_config, port_tables, _, _ = _setup_both(config)
    assert ("ice_coeff_gen" in port_tables.cloud) == ("2017" in case)
    if "names" in case:
        assert port_config.i_aerosol_type_map == (-1, 8, 14)
