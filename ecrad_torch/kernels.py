"""Build and load the package's CUDA kernels (``ecrad_torch/csrc``).

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  The library is built at
first use (``interface.setup_radiation`` on a CUDA device) into
``build/ecrad_torch/`` under the repository root, named by a hash of the
sources and flags, so a checkout builds everything itself and a changed
source is never served a stale library.  Nothing here runs at import
time.
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

from ecrad_torch import profiling
from ecrad_torch.data import REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "ecrad_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source.  The two sources that compute the SW layer
# coefficients (common.cuh sw_ref_trans), sw_fused.cu and
# tripleclouds_sw.cu, contract no multiply-add into an FMA, so that their
# f64 coefficients round op for op as the plain torch versions' do: near
# k * mu0 = 1 the Meador-Weaver direct-beam coefficients lose up to ~10
# digits (one f64 rounding there becomes a ~1e-6 relative change), which
# other rounding carries into the fluxes at more than chip_smoke.py's f64
# tolerance.  The f32 builds were timed without contraction (PERF.md).  The
# generator's cumulator, generator_cumulate.cu, contracts none either, so
# that its float32 covers equal the plain version's bit for bit: the
# generator's scan compares random numbers against them.  Nor do the
# SPARTACUS layer matrices, spartacus_layer_mats.cu: SW coefficients too,
# and a refinement whose every add and multiply is one torch op in its plain
# version.
SOURCE_FLAGS = {"sw_fused.cu": ("-fmad=false",),
                "tripleclouds_sw.cu": ("-fmad=false",),
                "generator_cumulate.cu": ("-fmad=false",),
                "spartacus_layer_mats.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # the generator: seeds, scalars, total cloud cover, fractional std,
    # the fit's table, od_scaling; ncol, nlev, ng, exp-exp, the table's
    # shape; the fit's axes and the cloud-fraction threshold
    "ecrad_generator_draw_sample": [_P] * 6 + [_I] * 6 + [_D] * 5 + [_P],
    # its cumulator: cloud fraction, overlap parameter, the packed scalars,
    # total cloud cover; ncol, nlev, Maximum-Random; the inhomogeneity
    # overlap's exponent and the cloud-fraction threshold
    "ecrad_generator_cumulate": [_P] * 4 + [_I] * 3 + [_D] * 2 + [_P],
    # the fused kernels take a last int: write the per-g planes
    "ecrad_lw_fused": [_P] + [_I] * 5 + [_P],
    "ecrad_sw_fused": [_P] + [_I] * 6 + [_P],
    "ecrad_tripleclouds_lw": [_P] + [_I] * 5 + [_P],
    "ecrad_tripleclouds_sw": [_P] + [_I] * 6 + [_P],
    # the three adding sweeps too
    "ecrad_lw_noscat_sweeps": [_P] + [_I] * 4 + [_P],
    "ecrad_scat_sweeps": [_P] + [_I] * 4 + [_P],
    "ecrad_sw_sweeps": [_P] + [_I] * 4 + [_P],
    "ecrad_spartacus_sw": [_P] + [_I] * 5 + [_D] * 3 + [_P],
    "ecrad_spartacus_lw": [_P] + [_I] * 4 + [_P],
    # the SPARTACUS layer matrices: ncol, nlev, ng, the cloud properties'
    # bands, (LW: the Planck inputs' column stride,) refine; max_cloud_od
    "ecrad_spartacus_sw_mats": [_P] + [_I] * 5 + [_D, _P],
    "ecrad_spartacus_lw_mats": [_P] + [_I] * 6 + [_D, _P],
    # the RRTMG gas optics: pointers, the packed tables' layout, ncol,
    # nlev, the least optical depth
    "ecrad_rrtmg_lw_taumol": [_P, _P, _I, _I, _D, _P],
    "ecrad_rrtmg_sw_taumol": [_P, _P, _I, _I, _D, _P],
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
    h = hashlib.sha256((" ".join(NVCC_FLAGS)
                        + repr(sorted(SOURCE_FLAGS.items()))).encode())
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
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), ()),
             "-c", "-o", obj, src],
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
    """The loaded kernel library (built on first call; the Dr Hook
    profile says which of the two it was)."""
    stage = "load" if os.path.exists(library_path()) else "build"
    with profiling.hook(f"kernels:library[{stage}]"):
        lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ecrad_error_string.argtypes = [ctypes.c_int]
    lib.ecrad_error_string.restype = ctypes.c_char_p
    lib.ecrad_adding_chunk_levels.argtypes = []
    lib.ecrad_adding_chunk_levels.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = library().ecrad_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def check_inputs(name, ref, specs):
    """Raise unless ``ref`` is a float32/float64 CUDA tensor whose last
    axis (the g-points, one thread each) has at most 1024 entries, and
    every ``specs`` entry {arg: (tensor, shape)} has that shape and is
    contiguous, of ref's dtype on ref's device."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {ref.dtype}")
    for arg, (t, shape) in specs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: {arg} must be {ref.dtype} on "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if ref.shape[-1] > 1024:
        raise ValueError(f"{name}: ng={ref.shape[-1]} exceeds 1024 threads")


def pointer_array(tensors):
    """ctypes array of the tensors' device pointers (None -> NULL)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def stream_of(tensor) -> int:
    """The current CUDA stream of the tensor's device, as an address."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
