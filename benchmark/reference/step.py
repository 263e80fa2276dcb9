"""The plain reference of one radiation call: the benchmark's own copy of
the configuration's physics, built from its configuration file and the
raw data files, in plain torch on any device.

The solvers are the route of the configuration's solvers, found by name
(``routes/``).  Where the route needs it, the McICA sample is drawn from
the columns' own seeds as the program draws it (threefry keyed per
column, LW seeds offset by 997), in ``sample_dtype``; the optics and the
solvers run in ``dtype``.  Nothing here reads anything the program made:
the tables are read again from the data files, the sample is drawn again
from the seeds.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from types import ModuleType
from typing import NamedTuple, Optional

import torch

from benchmark.reference import config as config_mod
from benchmark.reference import routes
from benchmark.reference.config import Config
from benchmark.reference.data import DATA_DIR, find_data_file
from benchmark.reference.interface import (Tables, _to_tensors,
                                           pdf_file_name, radiation,
                                           setup_radiation)
from benchmark.reference.io.netcdf import NcFile
from benchmark.reference.solvers.cloud_generator import (
    cloud_generator_device, fit_pdf_cheb)

# Offset decorrelating the LW stochastic sample from the SW one
LW_SEED_OFFSET = 997


def config_from_fields(fields: dict, dtype_name: str,
                       module=config_mod):
    """A Config of ``module`` (this reference's, or a program's with the
    same fields) from a configuration file's ``config`` group: enum fields
    by member name (``"MCICA"``), lists as tuples."""
    types = {f.name: f.type for f in dataclasses.fields(module.Config)}
    kw = {}
    for name, value in fields.items():
        kind = getattr(module, str(types[name]), None)
        if isinstance(kind, type) and issubclass(kind, enum.Enum):
            value = kind[value]
        elif isinstance(value, list):
            value = tuple(value)
        kw[name] = value
    return module.Config(**kw, dtype_name=dtype_name)


class Reference(NamedTuple):
    config: Config
    tables: Tables
    route: ModuleType       # routes.find(config)
    # the McICA PDF tables in the sample's dtype; None where the route
    # draws no sample
    pdf_sample: Optional[dict]
    dtype: torch.dtype
    sample_dtype: torch.dtype


def setup(config_path: str, device, dtype=torch.float64,
          sample_dtype=torch.float32) -> Reference:
    """Read the configuration file and the data files: the consolidated
    Config, its route, its tables in ``dtype`` and, where the route draws
    the McICA sample, the PDF tables in ``sample_dtype``."""
    with open(config_path) as f:
        fields = json.load(f)["config"]
    config = config_from_fields(fields, "float64" if dtype == torch.float64
                                else "float32")
    route = routes.find(config)
    config, tables = setup_radiation(config, route, device, dtype, DATA_DIR)
    pdf = None
    if route.NEEDS_SAMPLE:
        with NcFile(find_data_file(DATA_DIR, pdf_file_name(config))) as f:
            pdf = {"fsd": f.get("fsd"), "val": f.get("x").T}
        pdf["cheb_fit"] = fit_pdf_cheb(pdf)
        pdf = _to_tensors(pdf, device, sample_dtype)
    return Reference(config, tables, route, pdf, dtype, sample_dtype)


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x


def sample(ref: Reference, cloud: dict) -> dict:
    """The McICA sample of both band sets (od_scaling (ncol, nlev, ng),
    total cloud cover (ncol,)) from the columns' seeds, in the sample's
    dtype."""
    c = _cast(cloud, ref.sample_dtype)
    out = {}
    for band, offset, ng in (("sw", 0, ref.config.n_g_sw),
                             ("lw", LW_SEED_OFFSET, ref.config.n_g_lw)):
        od, tcc = cloud_generator_device(
            ref.config, ref.pdf_sample, c["iseed"] + offset, c["fraction"],
            c["overlap_param"], c["fractional_std"], ng)
        out[f"od_scaling_{band}"] = od
        out[f"total_cloud_cover_{band}"] = tcc
    return out


def fluxes(ref: Reference, inputs: dict, solar_irradiance: float) -> dict:
    """Every flux field of one call's columns, as {name: tensor} in the
    reference's dtype: the sample from the seeds where the route needs it,
    then the optics and the route's solvers.  ``inputs``: the program's
    keyword inputs (pressure_hl, ..., cloud, aerosol) on the reference's
    device."""
    kw = _cast(inputs, ref.dtype)
    if ref.route.NEEDS_SAMPLE:
        drawn = sample(ref, inputs["cloud"])
        kw["cloud"] = dict(kw["cloud"], **_cast(drawn, ref.dtype))
    return radiation(ref.config, ref.tables, ref.route,
                     solar_irradiance=solar_irradiance, **kw).fields()
