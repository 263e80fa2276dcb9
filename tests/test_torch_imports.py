"""The port stands alone: ecrad_torch (and chip_smoke.py, which runs it on
the GPU) imports neither JAX nor the JAX package, and its own host setup
reproduces the JAX package's tables exactly."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
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


def _assert_same(a, b, path="tables"):
    """Leaf-for-leaf equality of a port table tree against another."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
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


def test_setup_radiation_matches_jax_exactly():
    port_config, port_tables = setup_radiation(
        flagship.flagship_config("float64"), "cpu", torch.float64,
        data_dir=DATA_DIR)
    kw = {f.name: getattr(flagship.flagship_config("float64"), f.name)
          for f in dataclasses.fields(JaxConfig)}
    kw = {k: (getattr(type(getattr(JaxConfig(), k)), v.name)
              if hasattr(v, "name") and hasattr(v, "value") else v)
          for k, v in kw.items()}
    jax_config, jax_tables = jax_setup(JaxConfig(**kw), data_dir=DATA_DIR)
    _same_config(port_config, jax_config)
    assert isinstance(port_tables, Tables)
    converted = tables_from_numpy(jax_tables, "cpu", torch.float64)
    for name in Tables._fields:
        _assert_same(getattr(port_tables, name), getattr(converted, name),
                     name)
    # the conversion keeps integer index arrays integer
    assert port_tables.band_from_g_lw.dtype == torch.int64
    np.testing.assert_array_equal(port_tables.band_from_g_sw.numpy(),
                                  np.asarray(jax_tables.band_from_g_sw))
