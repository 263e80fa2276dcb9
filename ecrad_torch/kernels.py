"""Build and load the package's CUDA kernels (``ecrad_torch/csrc``).

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  The
library is built at first use into ``build/ecrad_torch/`` under the
repository root, named by a hash of the sources and flags, so a checkout
builds everything itself and a changed source is never served a stale
library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ecrad_torch.data import REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "ecrad_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ecrad_generator_scan": [_P] * 6 + [_I] * 4 + [_P],
    "ecrad_lw_fused": [_P] + [_I] * 4 + [_P],
    "ecrad_sw_fused": [_P] + [_I] * 5 + [_P],
    "ecrad_tripleclouds_lw": [_P] + [_I] * 4 + [_P],
    "ecrad_tripleclouds_sw": [_P] + [_I] * 5 + [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libecrad_torch_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernels unless the library for the current sources
    exists: one nvcc per source, run in parallel, then one link.  Returns
    {"path", "seconds" (0 when cached), "log"}."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        failed = [p.args[-1] for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0, "log": log}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ecrad_error_string.argtypes = [ctypes.c_int]
    lib.ecrad_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = library().ecrad_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def pointer_array(tensors):
    """ctypes array of the tensors' device pointers (None -> NULL)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def stream_of(tensor) -> int:
    """The current CUDA stream of the tensor's device, as an address."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
