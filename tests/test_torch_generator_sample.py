"""The McICA generator kernel (the threefry draws, the overlap scan and the
Chebyshev sampling epilogue, ecrad_torch/csrc/generator_scan.cu) on the
CPU, and the one route cloud_generator_device takes to it.

* The kernel source compiled with g++ through a thread-per-CUDA-thread
  stand-in for the CUDA runtime (tests/cuda_cpu/cuda_runtime.h) against
  its plain version, generator_draw_scan_plain, at 1, 14, 32 and 140
  g-points: zero exactly where the plain version is zero, and elsewhere
  within a relative gap of 1e-12 (float64) or 2e-6 (float32).  The draws
  and the scan are pure selection, so the CDF entries agree bit for bit;
  the gap comes from the libm behind the epilogue (glibc's log and exp
  here, torch's vectorised ones in the plain version, up to an ulp apart),
  which ndtri and the 15-term Clenshaw sum carry into y = ln(od_scaling),
  and a relative gap in od_scaling is the absolute gap in y.  Measured:
  7.2e-15 in float64 (1e-12 leaves ~140x); in float32 1.0e-6 where
  |y| <= 4 (~8 ulps, 2e-6 leaves 2x).  Beyond, where the sampled PDF is
  wide and od_scaling under 0.018 or over 55, the sum rounds in proportion
  to |y| (up to 68 on the fit's table), so the float32 bar there is
  2e-6 |y| / 4 (measured 1.5e-6 |y| / 4; 3.8e-6 at od_scaling 1.1e-5,
  y = -11.4).
* The plain version equals, bit for bit, the CDF (generator_cdf_plain)
  put through sample_pdf_cheb and then masked where the CDF is 0, the
  layer is clear or the thresholded total cover is 0, one mask at a time.
* cloud_generator_device's one route: generator_draw_scan with the
  Chebyshev fit, the fractional standard deviation and the threshold,
  inside the sampler's span; CPU tensors run the plain version and launch
  nothing; other tensors go to the kernels (first the cumulator's, but in
  Exp-Exp overlap), which raise where they cannot launch, with no
  fallback.
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
SOURCE = os.path.join(REPO, "ecrad_torch", "csrc", "generator_scan.cu")
OVERLAPS = ["EXPONENTIAL_RANDOM", "MAXIMUM_RANDOM", "EXPONENTIAL"]
NCOL = 8
RTOL = {torch.float64: 1e-12, torch.float32: 2e-6}


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """generator_scan.cu built with g++: each launch becomes a loop over
    blocks, each block one std::thread per CUDA thread."""
    tmp = tmp_path_factory.mktemp("generator_cpu")
    src = re.sub(r"(\w+<[\w, ]+>)\s*<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\(\s*",
                 r"shim_launch(\1, \2, \3, ", open(SOURCE).read())
    cc, lib = tmp / "generator_scan.cc", tmp / "libgenerator_cpu.so"
    cc.write_text(src)
    res = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-I", os.path.join(REPO, "tests", "cuda_cpu"),
         "-I", os.path.dirname(SOURCE), "-o", str(lib), str(cc)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, "ecrad_generator_draw_sample" + suffix)
        fn.argtypes = kernels._SIGNATURES["ecrad_generator_draw_sample"]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def meridian():
    """The flagship's configuration, its PDF tables (with the Chebyshev
    fit) and the cloud of the first meridian columns, in float64: seeds
    ~2.5e8 with two at the ends of the uint32 range, and the fractional
    standard deviation (1 in the file) spread over and beyond the fit's
    axis [0, 4], so that the interpolation and its clamps are taken."""
    step, args = flagship.build(ncol=NCOL, dtype=torch.float64, device="cpu")
    cloud = dict(zip(flagship.ARG_ORDER, args))["cloud"]
    iseed = cloud["iseed"].clone()
    iseed[:2] = torch.tensor([2**32 - 1, 0])
    rng = np.random.default_rng(7)
    fsd = torch.as_tensor(rng.uniform(0.0, 2.5, (NCOL, 137)))
    fsd[-1] = torch.linspace(0.0, 5.0, 137, dtype=torch.float64)
    fsd *= cloud["fractional_std"]
    return (step.config, step.tables.pdf_sampler, iseed, cloud["fraction"],
            cloud["overlap_param"], fsd)


def _case(meridian, overlap, dtype):
    config, pdf, iseed, frac, op, fsd = meridian
    config = config.replace(overlap_scheme=Overlap[overlap])
    frac, op, fsd = frac.to(dtype), op.to(dtype), fsd.to(dtype)
    scalars, exp_exp, tcc = cloud_generator.scan_scalars(config, frac, op)
    return config, pdf, iseed, frac, fsd, scalars, exp_exp, tcc


def _masked_cdf_route(config, pdf, iseed, frac, fsd, scalars, tcc, ng,
                      exp_exp):
    """od_scaling from the CDF plane: the Chebyshev sampler, then zero
    where the CDF is 0, the layer is under the cloud-fraction threshold or
    the thresholded total cover is 0."""
    thr = config.cloud_fraction_threshold
    cdf = cuda_generator.generator_cdf_plain(iseed, scalars, tcc, ng,
                                             exp_exp)
    tcc = torch.where(tcc >= thr, tcc, torch.zeros_like(tcc))
    zero = torch.zeros_like(cdf)
    od = torch.where(cdf > 0.0, cuda_generator.sample_pdf_cheb(
        pdf["cheb_fit"], fsd[..., None], cdf), zero)
    od = torch.where((frac >= thr)[..., None], od, zero)
    return torch.where(tcc[:, None, None] > 0.0, od, zero)


def _cpu_launch(lib, iseed, scalars, tcc, ng, exp_exp, fsd, fit, threshold):
    """The wrapper's launch of the kernel, on CPU tensors."""
    ncol, nlev = scalars.shape[:2]
    dtype = scalars.dtype
    cheb = fit["cheb"].to(dtype).contiguous()
    out = torch.full((ncol, nlev, ng), float("nan"), dtype=dtype)
    words = iseed.to(torch.int64).bitwise_and(0xFFFFFFFF).to(torch.int32)
    fn = getattr(lib, "ecrad_generator_draw_sample"
                 + ("_f32" if dtype == torch.float32 else "_f64"))
    code = fn(words.data_ptr(), scalars.data_ptr(), tcc.data_ptr(),
              fsd.contiguous().data_ptr(), cheb.data_ptr(), out.data_ptr(),
              ncol, nlev, ng, int(exp_exp), fit["nfsd"], cheb.shape[-1],
              fit["z_lo"] + fit["z_hi"], fit["z_hi"] - fit["z_lo"],
              fit["fsd1"], fit["inv_int"], threshold, None)
    assert code == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("ng", [1, 14, 32, 140])
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_sampled_build_source_matches_plain(cpu_kernel, meridian, overlap,
                                            ng, dtype):
    config, pdf, iseed, frac, fsd, scalars, exp_exp, tcc = _case(
        meridian, overlap, dtype)
    thr = config.cloud_fraction_threshold
    want = _masked_cdf_route(config, pdf, iseed, frac, fsd, scalars, tcc, ng,
                             exp_exp)
    got = _cpu_launch(cpu_kernel, iseed, scalars, tcc, ng, exp_exp, fsd,
                      pdf["cheb_fit"], thr)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    cloudy = want != 0.0
    assert bool(cloudy.any()) and not bool(cloudy.all())
    assert torch.equal(got != 0.0, cloudy)
    got, want_ = got[cloudy].double(), want[cloudy].double()
    scale = (want_.log().abs() / 4.0).clamp(min=1.0)
    rel = (got - want_).abs() / want_ / scale
    assert float(rel.max()) <= RTOL[dtype], float(rel.max())
    plain = cuda_generator.generator_draw_scan_plain(
        iseed, scalars, tcc, ng, exp_exp, fsd, pdf["cheb_fit"], thr)
    assert torch.equal(plain, want)


@pytest.fixture
def calls(monkeypatch):
    """Records the arguments of each generator_draw_scan call
    cloud_generator_device makes."""
    seen = []
    draw = cloud_generator.generator_draw_scan

    def spy_draw(*args):
        seen.append(args)
        return draw(*args)

    monkeypatch.setattr(cloud_generator, "generator_draw_scan", spy_draw)
    return seen


def _generate(meridian, pdf, device="cpu", ng=14, config=None):
    config = config or meridian[0]
    _, _, iseed, frac, op, fsd = meridian
    on = lambda t: t.to(device)  # noqa: E731
    return cloud_generator.cloud_generator_device(
        config, pdf, on(iseed), on(frac), on(op), on(fsd), ng)


def _spans(prof, which=("cumulator", "sampler")):
    names = {e.name for e in prof.events()}
    return {f"ecrad.generator.{w}" for w in which} <= names


def test_cpu_takes_the_plain_route(meridian, calls):
    """One generator_draw_scan call with the fit, inside the sampler's
    span; nothing is launched, and the result is the plain version's."""
    config, pdf, iseed, frac, fsd, scalars, exp_exp, tcc = _case(
        meridian, meridian[0].overlap_scheme.name, torch.float64)
    thr = config.cloud_fraction_threshold
    before = cuda_generator.generator_draw_scan.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        od, tcc_thr = _generate(meridian, pdf)
    ((*_, ng, ee, fsd_in, fit, thr_in),) = calls
    assert (ng, ee, thr_in) == (14, exp_exp, thr)
    assert fit is pdf["cheb_fit"] and torch.equal(fsd_in, fsd)
    assert cuda_generator.generator_draw_scan.launches == before
    assert torch.equal(od, cuda_generator.generator_draw_scan_plain(
        iseed, scalars, tcc, 14, exp_exp, fsd, pdf["cheb_fit"], thr))
    assert bool((od != 0.0).any())
    assert torch.equal(tcc_thr, tcc)
    assert _spans(prof)


def test_off_the_cpu_takes_the_sampled_build_or_raises(meridian, calls):
    """Tensors on another device go to the kernels.  In the flagship's
    Exponential-Random overlap the cumulator's kernel comes first and
    raises where it cannot launch, inside the cumulator's span, before the
    draw kernel is called.  In Exp-Exp overlap (its cumulator torch on every
    device) the draw kernel is called with the fit, the fractional
    standard deviation and the threshold, and raises, inside the sampler's
    span.  Either way there is no fallback, and nothing is launched."""
    config, pdf = meridian[:2]
    before = (cuda_generator.generator_cumulate.launches,
              cuda_generator.generator_draw_scan.launches)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="generator_cumulate: "
                           "unsupported device meta"):
            _generate(meridian, pdf, device="meta")
    assert not calls and _spans(prof, ("cumulator",))
    exp_exp = config.replace(overlap_scheme=Overlap.EXPONENTIAL)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="generator_draw_scan: "
                           "unsupported device meta"):
            _generate(meridian, pdf, device="meta", config=exp_exp)
    ((*_, ee, fsd, fit, thr),) = calls
    assert ee and fsd.device.type == "meta" and fit is pdf["cheb_fit"]
    assert thr == config.cloud_fraction_threshold
    assert (cuda_generator.generator_cumulate.launches,
            cuda_generator.generator_draw_scan.launches) == before
    assert _spans(prof)
