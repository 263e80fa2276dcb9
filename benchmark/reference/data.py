"""Locator for the raw data files the reference reads: the coefficient
files (NetCDF3, read with scipy, and the extracted RRTMG tables
``rrtmg.npz``) bundled in the repository's ``ecrad_tpu/data/`` directory,
read by path."""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO_ROOT, "ecrad_tpu", "data")


def find_data_file(directory_name: str, filename: str) -> str:
    """Resolve a data file: an absolute path as it is; otherwise the
    configured directory, then the bundled data directory."""
    if filename.startswith("/"):
        return filename
    cand = os.path.join(directory_name, filename)
    if os.path.exists(cand):
        return cand
    bundled = os.path.join(DATA_DIR, filename)
    if os.path.exists(bundled):
        return bundled
    return cand
