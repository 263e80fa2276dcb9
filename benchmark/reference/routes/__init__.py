"""The reference's solver routes, found by name.

A route solves both band sets on the optical properties that
``interface.optical_properties`` gives, and is the module
``routes/<name>.py``, where ``<name>`` is the consolidated Config's solvers
in lower case: the SW solver's name where both band sets take the same
solver (``mcica``), else the SW and the LW solver's names joined by ``_``
(``tripleclouds_mcica``).  A route module holds:

* ``NEEDS_SAMPLE``: whether it reads the McICA sample (``od_scaling_*``,
  ``total_cloud_cover_*`` in ``cloud``), which ``step.fluxes`` draws only
  then, from the McICA PDF table it reads only then;
* ``check_supported(config)``: raises NotImplementedError on any Config
  field the route does not follow;
* ``solve(config, tables, op, cloud, cos_sza)``: the solvers' outputs,
  ``(LwFluxes, SwFluxes)`` of ``solvers/outputs.py``, whose spectral
  profiles (``*_s``) are set where the route gives the Config's spectral
  flux output.

A configuration whose solvers have no route here brings its route as new
files: ``routes/<name>.py``, and any solver modules beside it.
"""

from __future__ import annotations

import importlib.util
import os

DIRECTORY = os.path.dirname(os.path.abspath(__file__))


def name(config) -> str:
    """The route's name for a Config's solvers."""
    sw, lw = config.sw_solver.name.lower(), config.lw_solver.name.lower()
    return sw if sw == lw else f"{sw}_{lw}"


def find(config):
    """The route module of a Config's solvers, loaded from
    ``DIRECTORY``; NotImplementedError naming the file where there is
    none."""
    route = name(config)
    path = os.path.join(DIRECTORY, route + ".py")
    if not os.path.isfile(path):
        raise NotImplementedError(
            f"the reference has no route for SW {config.sw_solver.name} "
            f"and LW {config.lw_solver.name}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.reference.routes.{route}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
