"""The system under test: ``ecrad_torch``, the PyTorch and CUDA port, built
from the benchmark's configuration file and driven through
``pipeline.radiation_blocked``, the entry both of its drivers reach.

``spans`` wraps the entry points of three layers in
``torch.profiler.record_function`` ranges for a traced run: the cloud
generator (``pipeline.add_cloud_sample``), the optics
(``interface._optical_properties``) and the solvers (the LW and SW
solvers of every route: ``solver_<name>_lw`` / ``_sw`` of the McICA,
Tripleclouds, SPARTACUS and Cloudless modules, ``SOLVER_MODULES``).  They
are module attributes looked up at call time, so the wrap reaches them;
it adds no synchronisation.  An untraced run wraps nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
from typing import NamedTuple

import torch

from benchmark.reference import constants as reference_constants
from benchmark.reference.step import config_from_fields

# Range names of the traced layers; metric readers find them by these
GENERATOR, OPTICS, SOLVERS, CALL = ("bench.generator", "bench.optics",
                                    "bench.solvers", "bench.call")
# The modules of ecrad_torch.solvers whose solver_<name>_lw and _sw the
# solvers' range wraps: one for each route of the port's interface (none
# calls another's)
SOLVER_MODULES = ("mcica", "tripleclouds", "spartacus", "cloudless")


class Program(NamedTuple):
    config: object          # ecrad_torch.config.Config, consolidated
    tables: object          # ecrad_torch.interface.Tables


def read_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def build(config_path: str, device, dtype) -> Program:
    """The port's consolidated Config and tables (its own setup, reading
    the data files) for a configuration file."""
    from ecrad_torch import config as config_mod
    from ecrad_torch import constants
    from ecrad_torch.data import DATA_DIR
    from ecrad_torch.interface import setup_radiation
    if constants.GAS_NAMES != reference_constants.GAS_NAMES:
        raise RuntimeError("the port's gas order differs from the one the "
                           "benchmark's inputs are laid out in")
    dtype_name = "float64" if dtype == torch.float64 else "float32"
    config = config_from_fields(read_config(config_path)["config"],
                                dtype_name, module=config_mod)
    config, tables = setup_radiation(config, device, dtype,
                                     data_dir=DATA_DIR)
    return Program(config, tables)


def call(program: Program, inputs: dict, block: int,
         solar_irradiance: float):
    """One radiation call over the columns of ``inputs`` in blocks of
    ``block`` columns: returns the port's Flux."""
    from ecrad_torch import pipeline
    return pipeline.radiation_blocked(
        program.config, program.tables, solar_irradiance=solar_irradiance,
        block_size=block, **inputs)


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def spans():
    """Wrap the three layers' entry points in profiler ranges for the
    duration of the block, and restore them after."""
    import importlib

    from ecrad_torch import interface, pipeline
    targets = [(pipeline, "add_cloud_sample", GENERATOR),
               (interface, "_optical_properties", OPTICS)]
    for name in SOLVER_MODULES:
        mod = importlib.import_module(f"ecrad_torch.solvers.{name}")
        targets += [(mod, f"solver_{name}_{band}", SOLVERS)
                    for band in ("lw", "sw")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, name in targets:
            setattr(mod, attr, _ranged(name, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
