"""The McICA generator's cumulator kernel (ecrad_torch/csrc/
generator_cumulate.cu: the Exponential-Random or Maximum-Random overlap
cumulator and the packed per-level scalars in one launch) on the CPU, and
the route scan_scalars takes to it.

* The kernel source compiled with g++ through a thread-per-CUDA-thread
  stand-in for the CUDA runtime (tests/cuda_cpu/cuda_runtime.h), without
  contracting multiply-adds as nvcc builds it (kernels.SOURCE_FLAGS),
  against the plain scan_scalars: the packed scalars and the total cloud
  cover bit for bit, in float64 and float32, on the meridian profiles,
  all-clear columns, overcast runs at and above MAX_CLOUD_FRAC, fractions
  at and next to the cloud-fraction threshold, and 37 columns (not a
  multiple of the block of 64), at the IFS's decorrelation scaling of 0.5
  (exponent 2, x * x) and at 1/3 (exponent 3, x * x * x).  The other
  exponents take sqrt, rsqrt or pow, which torch's vectorised CPU kernels
  round otherwise than the C library: those are held on the card
  (chip_smoke.py), where torch and the kernel call the same functions.
* scan_scalars' routes: Exponential-Random and Maximum-Random call
  generator_cumulate inside the cumulator's span; CPU tensors run its plain
  version and launch nothing; tensors it cannot take raise, with no
  fallback and no launch; Exp-Exp cumulates in torch on every device.
The build with nvcc and the runs on the card are chip_smoke.py's.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from ecrad_torch import flagship, kernels
from ecrad_torch.config import Overlap
from ecrad_torch.solvers import cloud_generator, cuda_generator

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "ecrad_torch", "csrc", "generator_cumulate.cu")
NCOL = 32


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """generator_cumulate.cu built with g++: each launch becomes a loop over
    blocks, each block one std::thread per CUDA thread."""
    tmp = tmp_path_factory.mktemp("cumulate_cpu")
    src = re.sub(r"(\w+<[\w, ]+>)\s*<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\(\s*",
                 r"shim_launch(\1, \2, \3, ", open(SOURCE).read())
    cc, lib = tmp / "generator_cumulate.cc", tmp / "libcumulate_cpu.so"
    cc.write_text(src)
    res = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", os.path.join(REPO, "tests", "cuda_cpu"),
         "-I", os.path.dirname(SOURCE), "-o", str(lib), str(cc)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, "ecrad_generator_cumulate" + suffix)
        fn.argtypes = kernels._SIGNATURES["ecrad_generator_cumulate"]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def meridian():
    """The flagship's configuration and the cloud fraction and overlap
    parameter of the 32 meridian columns, in float64."""
    step, args = flagship.build(ncol=NCOL, dtype=torch.float64, device="cpu")
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    return step.config, cloud["fraction"], cloud["overlap_param"]


def _profiles(meridian, case, dtype):
    """(frac, overlap_param) of a case, in dtype."""
    config, frac, op = meridian
    frac, op = frac.to(dtype).clone(), op.to(dtype).clone()
    rng = np.random.default_rng(11)
    if case == "clear":
        frac.zero_()
    elif case == "overcast":
        # runs at exactly 1, at MAX_CLOUD_FRAC and the next value under it
        # (rounded to dtype as torch rounds the scalar), and one overcast
        # column
        at = torch.tensor(cuda_generator.MAX_CLOUD_FRAC, dtype=dtype)
        frac[::3, 30:45] = 1.0
        frac[1::3, 50:60] = at
        frac[2::3, 50:60] = torch.nextafter(at, torch.zeros_like(at))
        frac[::4, 80:83] = at
        frac[-1] = 1.0
    elif case == "threshold":
        thr = torch.tensor(config.cloud_fraction_threshold, dtype=dtype)
        for k, v in enumerate((thr, torch.nextafter(thr, 2 * thr),
                               torch.nextafter(thr, 0 * thr))):
            lev = torch.as_tensor(rng.integers(0, frac.shape[1], (NCOL, 20)))
            frac.scatter_(1, lev[:, k::3], float(v))
    elif case == "ragged":
        idx = torch.as_tensor(rng.integers(0, NCOL, 37))
        frac, op = frac[idx].contiguous(), op[idx].contiguous()
    return frac, op


def _cpu_launch(lib, frac, op, max_ran, decorr, threshold):
    """The wrapper's launch of the kernel, on CPU tensors."""
    ncol, nlev = frac.shape
    scalars = torch.full((ncol, nlev, 8), float("nan"), dtype=frac.dtype)
    tcc = torch.full((ncol,), float("nan"), dtype=frac.dtype)
    fn = getattr(lib, "ecrad_generator_cumulate"
                 + ("_f32" if frac.dtype == torch.float32 else "_f64"))
    code = fn(frac.data_ptr(), op.data_ptr(), scalars.data_ptr(),
              tcc.data_ptr(), ncol, nlev, int(max_ran), 1.0 / decorr,
              threshold, None)
    assert code == 0
    return scalars, tcc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("decorr", [0.5, 1.0 / 3.0], ids=["x2", "x3"])
@pytest.mark.parametrize("case", ["meridian", "clear", "overcast",
                                  "threshold", "ragged"])
@pytest.mark.parametrize("overlap", ["EXPONENTIAL_RANDOM", "MAXIMUM_RANDOM"])
def test_kernel_source_matches_plain_bit_for_bit(cpu_kernel, meridian,
                                                 overlap, case, decorr,
                                                 dtype):
    config = meridian[0].replace(overlap_scheme=Overlap[overlap],
                                 cloud_inhom_decorr_scaling=decorr)
    frac, op = _profiles(meridian, case, dtype)
    want, exp_exp, want_tcc = cloud_generator.scan_scalars(config, frac, op)
    assert not exp_exp
    thr = config.cloud_fraction_threshold
    got, tcc = _cpu_launch(cpu_kernel, frac, op,
                           overlap == "MAXIMUM_RANDOM", decorr, thr)
    assert torch.equal(got, want)
    assert torch.equal(tcc, want_tcc)
    if case in ("meridian", "ragged"):
        assert bool((want_tcc > 0.0).any()) and bool((op > 0.0).any())
    if case == "clear":
        assert not bool(want_tcc.any())
    if case == "threshold":     # clear and cloudy at the threshold's ulp
        any_c = want[..., cuda_generator._ANY]
        assert bool((any_c[frac == thr] == 1.0).all())
        assert bool((any_c[frac < thr] == 0.0).all())


@pytest.fixture
def cumulate_calls(monkeypatch):
    """Records the arguments of each generator_cumulate call scan_scalars
    makes."""
    seen = []
    cumulate = cloud_generator.generator_cumulate

    def spy(*args):
        seen.append(args)
        return cumulate(*args)

    monkeypatch.setattr(cloud_generator, "generator_cumulate", spy)
    return seen


def _record(fn):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


@pytest.mark.parametrize("overlap", ["EXPONENTIAL_RANDOM", "MAXIMUM_RANDOM"])
def test_cpu_takes_the_plain_route(meridian, cumulate_calls, overlap):
    """One generator_cumulate call inside the cumulator's span, with the
    overlap flag, the decorrelation scaling and the threshold; nothing is
    launched, and the result is the plain version's."""
    config, frac, op = meridian
    config = config.replace(overlap_scheme=Overlap[overlap])
    before = cuda_generator.generator_cumulate.launches
    (scalars, exp_exp, tcc), spans = _record(
        lambda: cloud_generator.scan_scalars(config, frac, op))
    ((f, o, max_ran, decorr, thr),) = cumulate_calls
    assert f is frac and o is op and not exp_exp
    assert max_ran == (overlap == "MAXIMUM_RANDOM")
    assert decorr == config.cloud_inhom_decorr_scaling
    assert thr == config.cloud_fraction_threshold
    assert cuda_generator.generator_cumulate.launches == before
    want = cuda_generator.generator_cumulate_plain(frac, op, max_ran, decorr,
                                                   thr)
    assert torch.equal(scalars, want[0]) and torch.equal(tcc, want[1])
    assert "ecrad.generator.cumulator" in spans


@pytest.mark.parametrize("args", ["meta", "three_axes"])
def test_off_the_cpu_the_wrapper_raises_on_what_it_cannot_take(meridian,
                                                               args):
    """On the meta device, or with a cloud fraction of three axes, the
    wrapper raises before any launch; there is no fallback."""
    config, frac, op = meridian
    frac, op = frac.to("meta"), op.to("meta")
    if args == "three_axes":
        frac = frac[..., None]
    before = (cuda_generator.generator_cumulate.launches,
              cuda_generator.generator_draw_scan.launches)
    match = ("unsupported device meta" if args == "meta"
             else r"frac has shape \(32, 137, 1\)")
    with pytest.raises(ValueError, match="generator_cumulate: " + match):
        cuda_generator.generator_cumulate(frac, op, False, 0.5, 1e-6)
    assert (cuda_generator.generator_cumulate.launches,
            cuda_generator.generator_draw_scan.launches) == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_exp_exp_keeps_its_torch_route(meridian, cumulate_calls, device):
    """Exp-Exp overlap never calls generator_cumulate: its cumulator and the
    packing run in torch on every device, inside the cumulator's span."""
    config, frac, op = meridian
    config = config.replace(overlap_scheme=Overlap.EXPONENTIAL)
    frac, op = frac.to(device), op.to(device)
    before = cuda_generator.generator_cumulate.launches
    (scalars, exp_exp, tcc), spans = _record(
        lambda: cloud_generator.scan_scalars(config, frac, op))
    assert exp_exp and not cumulate_calls
    assert cuda_generator.generator_cumulate.launches == before
    assert scalars.shape == (NCOL, frac.shape[1], 8)
    assert scalars.device.type == device and tcc.shape == (NCOL,)
    assert "ecrad.generator.cumulator" in spans
    if device == "cpu":
        cum, pair = cloud_generator.cum_cloud_cover_exp_exp_jnp(frac, op)
        want = cuda_generator.pack_scalars(
            frac, op, cum, pair, config.cloud_inhom_decorr_scaling,
            config.cloud_fraction_threshold)
        assert torch.equal(scalars, want[0]) and torch.equal(tcc, want[1])
