"""A step of the port and of the JAX package on the same few meridian
columns (CPU, f64), for the port's tests that hold one step to the other.

Both start from the flagship with Config fields replaced; a field that
``tools.make_torch_reference.ENUM_FIELDS`` names is given by enum member
name and resolved in each package's own enum.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from ecrad_tpu import config as jconfig
from ecrad_tpu.data import DATA_DIR
from ecrad_torch import config as tconfig
from ecrad_torch import flagship, pipeline
from ecrad_torch.interface import setup_radiation
from tools.make_torch_reference import ENUM_FIELDS

COLUMNS = [2, 9, 17, 26]        # night, low, high and setting sun
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")


def columns(tree, to):
    """The COLUMNS of every (32, ...) array of the step's arguments."""
    if isinstance(tree, dict):
        return {k: columns(v, to) for k, v in tree.items()}
    x = np.asarray(tree)
    return to(x[COLUMNS]) if x.ndim and x.shape[0] == 32 else tree


def enums(mod, over):
    """Config fields with enum fields given by member name resolved in the
    config module ``mod``."""
    return {k: getattr(mod, ENUM_FIELDS[k])[v] if k in ENUM_FIELDS else v
            for k, v in over.items()}


def port_args():
    """The port's flagship step and its keyword arguments on the COLUMNS."""
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu")
    return step, dict(zip(flagship.ARG_ORDER,
                          [columns(a, torch.as_tensor) for a in args]))


def port_step(over, aerosol=None):
    """The port's flagship with Config fields replaced on the COLUMNS, fed
    the meridian aerosol mixing ratios or ``aerosol`` (numpy arrays): its
    fields as numpy arrays."""
    config, tables = setup_radiation(
        flagship.flagship_config("float64").replace(**enums(tconfig, over)),
        "cpu", torch.float64, data_dir=DATA_DIR)
    step, kw = port_args()
    if aerosol is not None:
        kw["aerosol"] = {k: torch.as_tensor(v) for k, v in aerosol.items()}
    got = pipeline.radiation_step(config, tables, solar_irradiance=step.solar,
                                  **kw).fields()
    return {k: v.numpy() for k, v in got.items()}


def jax_step(over, aerosol=None):
    """The same in the JAX package."""
    jstep, jargs = __graft_entry__._build(
        ncol=32, dtype="float64", nam_overrides=enums(jconfig, over))
    jargs = [columns(a, jnp.asarray) for a in jargs]
    if aerosol is not None:
        jargs[-1] = {k: jnp.asarray(v) for k, v in aerosol.items()}
    flux = jax.jit(jstep)(*jargs)
    return {k: np.asarray(getattr(flux, k)) for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


def assert_fluxes(got, ref):
    """All 20 fields, within ATOL_FLUX W m-2 (ATOL_DIMLESS for DIMLESS)."""
    assert set(got) == set(ref) and len(got) == 20
    for k, r in ref.items():
        atol = ATOL_DIMLESS if k in DIMLESS else ATOL_FLUX
        np.testing.assert_allclose(got[k], r, rtol=0, atol=atol, err_msg=k)
