"""A step of the port and of the JAX package on the same few meridian
columns (CPU, f64), for the port's tests that hold one step to the other.

Both start from the flagship with Config fields replaced; a field that
``tools.make_torch_reference.ENUM_FIELDS`` names is given by enum member
name and resolved in each package's own enum.  A step may also be cut to
a window of levels (``levels``, a slice of the 137 layers).
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
from tools.make_torch_reference import ENUM_FIELDS, PROFILE_COLUMNS

COLUMNS = list(PROFILE_COLUMNS)  # night, low, high and setting sun
ATOL_FLUX, ATOL_DIMLESS = 1e-7, 1e-10
DIMLESS = ("lw_derivatives", "cloud_cover_lw", "cloud_cover_sw")
# The fields of the flagship's Flux
FLAGSHIP_FIELDS = (
    "lw_up", "lw_dn", "sw_up", "sw_dn", "sw_dn_direct", "lw_up_clear",
    "lw_dn_clear", "sw_up_clear", "sw_dn_clear", "sw_dn_direct_clear",
    "sw_dn_surf_band", "sw_dn_direct_surf_band", "sw_dn_surf_clear_band",
    "sw_dn_direct_surf_clear_band", "lw_dn_surf_canopy",
    "sw_dn_diffuse_surf_canopy", "sw_dn_direct_surf_canopy",
    "cloud_cover_lw", "cloud_cover_sw", "lw_derivatives")
# ... and those that spectral flux output adds: the profiles per band or
# per g-point (do_save_spectral_flux, do_save_gpoint_flux) and the TOA
# fluxes per band (do_toa_spectral_flux)
PROFILE_FIELDS = (
    "lw_up_band", "lw_dn_band", "sw_up_band", "sw_dn_band",
    "sw_dn_direct_band", "lw_up_clear_band", "lw_dn_clear_band",
    "sw_up_clear_band", "sw_dn_clear_band", "sw_dn_direct_clear_band")
TOA_FIELDS = ("sw_dn_toa_band", "sw_up_toa_band", "sw_up_toa_clear_band",
              "lw_up_toa_band", "lw_up_toa_clear_band")


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


def window(args, levels, to):
    """The step's arguments (in flagship.ARG_ORDER) cut to the layers of
    ``levels`` (their half levels, the overlap parameters between them),
    converted by ``to``; levels None keeps all."""
    if levels is None:
        return [to(a) if not isinstance(a, dict)
                else {k: to(v) for k, v in a.items()} for a in args]
    lo, hi = levels.start, levels.stop

    def cut(name, x):
        x = np.asarray(x)
        if name in ("pressure_hl", "temperature_hl"):
            return to(x[:, lo:hi + 1])
        if name == "overlap_param":
            return to(x[:, lo:hi - 1])
        if x.ndim >= 2 and x.shape[1] == 137:
            return to(x[:, lo:hi])
        return to(x)

    return [{k: cut(k, v) for k, v in x.items()} if isinstance(x, dict)
            else cut(name, x) for name, x in zip(flagship.ARG_ORDER, args)]


def port_args(levels=None):
    """The port's flagship step and its keyword arguments on the COLUMNS
    (and the layers of ``levels``)."""
    step, args = flagship.build(ncol=32, dtype=torch.float64, device="cpu")
    args = [columns(a, np.asarray) for a in args]
    return step, dict(zip(flagship.ARG_ORDER,
                          window(args, levels, torch.as_tensor)))


def port_step(over, aerosol=None, levels=None):
    """The port's flagship with Config fields replaced on the COLUMNS (and
    the layers of ``levels``), fed the meridian aerosol mixing ratios or
    ``aerosol`` (numpy arrays): its fields as numpy arrays."""
    config, tables = setup_radiation(
        flagship.flagship_config("float64").replace(**enums(tconfig, over)),
        "cpu", torch.float64, data_dir=DATA_DIR)
    step, kw = port_args(levels)
    if aerosol is not None:
        kw["aerosol"] = {k: torch.as_tensor(v) for k, v in aerosol.items()}
    got = pipeline.radiation_step(config, tables, solar_irradiance=step.solar,
                                  **kw).fields()
    return {k: v.numpy() for k, v in got.items()}


def jax_step(over, aerosol=None, levels=None):
    """The same in the JAX package."""
    jstep, jargs = __graft_entry__._build(
        ncol=32, dtype="float64", nam_overrides=enums(jconfig, over))
    jargs = window([columns(a, np.asarray) for a in jargs], levels,
                   jnp.asarray)
    if aerosol is not None:
        jargs[-1] = {k: jnp.asarray(v) for k, v in aerosol.items()}
    flux = jax.jit(jstep)(*jargs)
    return {k: np.asarray(getattr(flux, k)) for k in flux.__dataclass_fields__
            if getattr(flux, k) is not None}


def assert_fluxes(got, ref, fields=FLAGSHIP_FIELDS, atol=ATOL_FLUX):
    """Exactly the fields ``fields`` (the flagship's 20 unless given), each
    within ``atol`` W m-2 (ATOL_FLUX unless given; ATOL_DIMLESS for
    DIMLESS)."""
    assert set(got) == set(ref) == set(fields)
    flux_atol = atol
    for k, r in ref.items():
        atol = ATOL_DIMLESS if k in DIMLESS else flux_atol
        np.testing.assert_allclose(got[k], r, rtol=0, atol=atol, err_msg=k)
