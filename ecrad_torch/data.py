"""Locator for the data files the port shares with the JAX package.

The coefficient files (NetCDF3, which scipy reads, plus the extracted
RRTMG cache ``rrtmg.npz``) and the bundled meridian input live in
``ecrad_tpu/data/``.  The port reads them there by path and imports
nothing of that package, which needs JAX.
"""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO_ROOT, "ecrad_tpu", "data")
MERIDIAN_INPUT = os.path.join(DATA_DIR, "io", "ecrad_meridian.nc")


def find_data_file(directory_name: str, filename: str) -> str:
    """Resolve a data file: absolute path as-is; otherwise try the
    configured directory, then the bundled data directory."""
    if filename.startswith("/"):
        return filename
    cand = os.path.join(directory_name, filename)
    if os.path.exists(cand):
        return cand
    bundled = os.path.join(DATA_DIR, filename)
    if os.path.exists(bundled):
        return bundled
    return cand  # let the open() raise with the configured path
