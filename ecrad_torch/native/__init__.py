"""The host runtime's native (C++/OpenMP) piece, bound with ctypes
(port of ``ecrad_tpu/native``, with its own copy of the source):

- ``cloud_generator.cc``: the bit-exact McICA stochastic cloud generator,
  the offline driver's host hot spot, parallel over columns with OpenMP
  as in driver/ecrad_driver.F90:339-384.

The shared library is built with ``g++ -O2 -fopenmp`` at first use into
``build/ecrad_torch/`` under the repository root, named by a hash of the
source and flags, so that a checkout builds its own and a changed source
is never served a stale library.  Nothing is written beside the source,
and nothing is built at import time.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ecrad_torch.kernels import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "cloud_generator.cc")
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-fopenmp", "-std=c++17")


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libecrad_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it exists for this source; returns its
    path.  Raises RuntimeError if g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ for {SOURCE}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded shared library, built on first call."""
    handle = ctypes.CDLL(build())
    fn = handle.ecrad_cloud_generator
    fn.restype = None
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_double, f64, f64, ctypes.c_double, f64, f64,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, f64, f64,
    ]
    return handle


def cloud_generator_all_columns(ng, i_overlap_scheme, iseed,
                                frac_threshold, frac, overlap_param,
                                decorrelation_scaling, fractional_std,
                                pdf_sampler, use_beta_overlap=False):
    """The native form of
    solvers.cloud_generator_exact.cloud_generator_all_columns: returns
    (od_scaling (ncol, nlev, ng), total_cloud_cover (ncol,))."""
    frac = np.ascontiguousarray(frac, np.float64)
    ncol, nlev = frac.shape
    overlap_param = np.ascontiguousarray(overlap_param, np.float64)
    fractional_std = np.ascontiguousarray(fractional_std, np.float64)
    iseed = np.ascontiguousarray(iseed, np.int64)
    if overlap_param.shape != (ncol, nlev - 1) \
            or fractional_std.shape != (ncol, nlev) \
            or iseed.shape != (ncol,):
        raise ValueError(
            f"shapes: frac {frac.shape}, overlap_param "
            f"{overlap_param.shape}, fractional_std {fractional_std.shape}, "
            f"iseed {iseed.shape}")
    pdf_val = np.ascontiguousarray(pdf_sampler.val, np.float64)
    od_scaling = np.zeros((ncol, nlev, int(ng)), np.float64)
    cover = np.zeros(ncol, np.float64)
    lib().ecrad_cloud_generator(
        ncol, nlev, int(ng), int(i_overlap_scheme), iseed,
        float(frac_threshold), frac, overlap_param,
        float(decorrelation_scaling), fractional_std, pdf_val,
        int(pdf_sampler.ncdf), int(pdf_sampler.nfsd),
        float(pdf_sampler.fsd1), float(pdf_sampler.inv_fsd_interval),
        int(bool(use_beta_overlap)), od_scaling, cover)
    return od_scaling, cover
