"""The SPARTACUS layer-matrix kernels (a build pass and a refine pass per
band set, ecrad_torch/csrc/spartacus_layer_mats.cu, from the band set's raw
optics) on the CPU, and the route to them.

* The kernel source compiled with g++ through a thread-per-CUDA-thread
  stand-in for the CUDA runtime (tests/cuda_cpu/cuda_runtime.h), without
  contracting multiply-adds as nvcc builds it (kernels.SOURCE_FLAGS),
  launched through the wrappers' own kernel branch
  (cuda_spartacus._sw_layer_mats_kernel, _lw_layer_mats_kernel: checks,
  outputs, scratch, pointer order, counter), against the plain build
  (spartacus._sw_layer_mats, _lw_layer_mats), in float64 and float32, the
  LW refinement in float64 in both; the layer matrices and the clear-sky
  planes (cl5, cl4).  Inputs as the route builds them: the
  spartacus_ecckd meridian state (the 32 columns behind
  tests/data/torch_spartacus_ecckd_meridian32.npz), spartacus_3d at
  RRTMG's widths (112 SW, 140 LW g-points), columns made clear,
  use_expm_everywhere, 5 columns (no multiple of a block), elements
  whose squaring count reaches its cap (13 SW, 6 LW), an absorbing LW
  (no ssa and g: the route's default) and, LW only, a scattering one
  (aerosol scattering on, RRTMG) and one without side emissivity.
  - Refined elements: equal bit for bit.  Their arithmetic (the region
    optics and side emissivity the refine pass makes again, the
    exponential) is adds, multiplies, divides, square roots, absolute
    values, frexp and ldexp, each rounded once in both, in the same order
    (the source mirrors spartacus._region_optics, _side_emissivity and
    solvers/matrix.py op for op); so are they against _sw_refine /
    _lw_refine fed the region optics and side emissivity built over whole
    planes, as the route built them before the kernels made them.  The
    square roots are correctly rounded in g++'s libm and on the card, but
    torch's on the CPU go through MKL's vector math, within an ulp: these
    comparisons give the plain side a correctly rounded torch.sqrt
    (numpy's).
  - The others, and the clear-sky planes: the two-stream coefficients go
    through exp and expm1,
    which g++'s libm and torch's vectorised CPU kernels round apart by an
    ulp.  Float64: within 1e-6 of an entry plus 1e-10 of the plane's
    largest (chip_smoke.py's floor), as the Meador-Weaver direct-beam terms
    lose up to ~10 digits of their scale near k mu0 = 1
    (kernels.SOURCE_FLAGS; measured 4.3e-12 of the largest).  Float32:
    within 1e-4 of the plane's largest, or else a plane's worst distance
    to the float64 plain build at most twice the float32 plain build's
    (both lose ~1e-3 of the Rd and Tdd planes' scale there, and either may
    be the closer, entry by entry).
* The route: the SPARTACUS solvers call the wrappers once a band set; CPU
  tensors run the plain build and launch nothing; tensors the kernels
  cannot take raise before any launch, with no fallback; a launch set
  counts once.  With the kernel branch, the sweep arguments
  (spartacus.sw_sweep_args, lw_sweep_args) are built without the region
  merge or a two-stream call in torch, and equal the plain route's.
* The counters: .refined, the kernels' running total of refined
  elements, which the refine pass keeps on the card, and the CPU route's
  grow by the plain build's use_expm.sum(), and the kernel branch reads
  no tensor's value on the host.
The build with nvcc and the runs on the card are chip_smoke.py's
(spartacus_sw_mats, spartacus_lw_mats, equal to their plain versions bit
for bit there too).
"""

import ctypes
import functools
import os
import re
import subprocess

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ecrad_torch import flagship, kernels, pipeline
from ecrad_torch.solvers import cuda_spartacus, cuda_tripleclouds, matrix
from ecrad_torch.solvers import spartacus as sp
from ecrad_torch.solvers import two_stream

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "ecrad_torch", "csrc", "spartacus_layer_mats.cu")
NAMES = {"sw": "sw_layer_mats", "lw": "lw_layer_mats"}
SWEEP_ARGS = {"sw": "sw_sweep_args", "lw": "lw_sweep_args"}
# the positions in each wrapper's arguments of the mask, the clear layers,
# the 3D rates (SW: the direct ones) and the Planck terms (LW)
USE = {"sw": 12, "lw": 15}
CLEAR = {"sw": 13, "lw": 12}
RATES = {"sw": 11, "lw": 9}
PLANCK = 13
CASES = ("meridian", "rrtmg", "clear", "everywhere", "ragged", "clamp")
# the cases of both band sets, and those of the LW alone (the SW has no
# absorbing gas and no side emissivity)
PAIRS = [(c, b) for c in CASES for b in ("sw", "lw")] + [
    ("scattering", "lw"), ("no_side", "lw")]


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """spartacus_layer_mats.cu built with g++: each launch becomes a loop
    over blocks, each block one std::thread per CUDA thread."""
    tmp = tmp_path_factory.mktemp("layer_mats_cpu")
    src = re.sub(r"(\w+<[\w, ]+>)\s*<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\(\s*",
                 r"shim_launch(\1, \2, \3, ", open(SOURCE).read())
    cc, lib = tmp / "spartacus_layer_mats.cc", tmp / "liblayer_mats_cpu.so"
    cc.write_text(src)
    res = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", os.path.join(REPO, "tests", "cuda_cpu"),
         "-I", os.path.dirname(SOURCE), "-o", str(lib), str(cc)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for name in ("ecrad_spartacus_sw_mats", "ecrad_spartacus_lw_mats"):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = kernels._SIGNATURES[name]
            fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def exact_sqrt(monkeypatch):
    """torch.sqrt correctly rounded (numpy's), as g++'s libm and the
    card's: on the CPU torch's goes through MKL's vector math, within an
    ulp of it, and the refine pass's LW side emissivity takes two square
    roots."""
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


@pytest.fixture
def launches_on_cpu(monkeypatch, cpu_kernel):
    """The wrappers' kernel branch on CPU tensors: the device checks record
    their specs (CPU tensors stand in for the card's), and each launch goes
    to the g++ build.  Yields the recorded (name, specs)."""
    specs = []
    monkeypatch.setattr(kernels, "check_inputs",
                        lambda name, ref, s: specs.append((name, s)))

    def launch(fn_name, ref, tensors, *params):
        fn = getattr(cpu_kernel, f"ecrad_{fn_name}_"
                     + ("f32" if ref.dtype == torch.float32 else "f64"))
        assert fn(kernels.pointer_array(tensors), *params, None) == 0

    monkeypatch.setattr(cuda_spartacus, "_launch", launch)
    return specs


def _capture(config_name, ncol, dtype=torch.float64, config=None,
             cloud=None):
    """The arguments of the two layer-matrix wrappers in one CPU step of a
    configuration (config(Config) editing its Config, cloud(dict) its
    cloud inputs), the Config it ran, and the arguments of the two sweep
    argument builders (spartacus.sw_sweep_args, lw_sweep_args); checks
    that each is called once."""
    step, args = flagship.build(ncol=ncol, dtype=dtype, device="cpu",
                                config_name=config_name)
    kw = dict(zip(flagship.ARG_ORDER, args))
    if cloud is not None:
        kw["cloud"] = cloud(dict(kw["cloud"]))
    seen = {"sw": [], "lw": []}
    inputs = {"sw": [], "lw": []}
    real = {k: getattr(cuda_spartacus, n) for k, n in NAMES.items()}
    real_args = {k: getattr(sp, n) for k, n in SWEEP_ARGS.items()}
    try:
        for k, n in NAMES.items():
            # the spy carries the wrapper's counters, which a wrapper
            # updates through its module's name
            spy = functools.wraps(real[k])(
                lambda *a, _k=k: seen[_k].append(a) or real[_k](*a))
            setattr(cuda_spartacus, n, spy)
            setattr(sp, SWEEP_ARGS[k], lambda *a, _k=k: inputs[_k].append(a)
                    or real_args[_k](*a))
        conf = step.config if config is None else config(step.config)
        pipeline.radiation_step(conf, step.tables,
                                solar_irradiance=step.solar, **kw)
    finally:
        for k, n in NAMES.items():
            setattr(cuda_spartacus, n, real[k])
            setattr(sp, SWEEP_ARGS[k], real_args[k])
    assert [len(v) for v in seen.values()] == [1, 1]
    assert [len(v) for v in inputs.values()] == [1, 1]
    return ({k: v[0] for k, v in seen.items()}, conf,
            {k: v[0] for k, v in inputs.items()})


def _clear_every_other(cloud):
    cloud["fraction"] = cloud["fraction"].clone()
    cloud["fraction"][::2] = 0.0
    return cloud


def _scaled_to_the_cap(args, band):
    """The meridian arguments with the 3D rates (SW: direct, LW: diffuse)
    of the (column, layer)s of the first 8 refined elements raised, so that
    their exponentials' norms reach the squaring cap."""
    args = list(args)
    c, lev, _ = args[USE[band]].nonzero(as_tuple=True)
    c, lev = c[:8], lev[:8]
    i = RATES[band]
    rates = args[i].clone()
    rates[c, lev] = rates[c, lev] * 0.0 + (3.0e4 if band == "sw" else 60.0)
    args[i] = rates
    return tuple(args)


@pytest.fixture(scope="module")
def states():
    """{case: ({"sw": args, "lw": args}, config, {"sw": sweep_args
    inputs, "lw": ...})} in float64."""
    out = {}
    out["meridian"] = _capture("spartacus_ecckd", 32)
    out["rrtmg"] = _capture("spartacus_3d", 4)
    out["clear"] = _capture("spartacus_ecckd", 8, cloud=_clear_every_other)
    out["everywhere"] = _capture(
        "spartacus_ecckd", 8,
        config=lambda c: c.replace(use_expm_everywhere=True))
    out["ragged"] = _capture("spartacus_ecckd", 5)
    args, config, inputs = _capture("spartacus_ecckd", 4)
    out["clamp"] = ({b: _scaled_to_the_cap(a, b) for b, a in args.items()},
                    config, inputs)
    # RRTMG's aerosols scatter in the LW once asked to: ssa and g given
    out["scattering"] = _capture(
        "spartacus_3d", 4,
        config=lambda c: c.replace(do_lw_aerosol_scattering=True))
    out["no_side"] = _capture(
        "spartacus_ecckd", 8,
        config=lambda c: c.replace(do_lw_side_emissivity=False))
    return out


def _rounded(args, dtype):
    if dtype == torch.float64:
        return args
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _refined_entries(band, args, x):
    """The entries of an output plane (nlev, K, ncol, ng) that belong to
    refined elements, and those of the others."""
    use = args[USE[band]].permute(1, 0, 2)[:, None].expand_as(x)
    return x[use], x[~use]


def _close_as_built(got, want, want64, dtype):
    """Entries not refined and clear-sky planes: within libm's rounding of
    exp and expm1 (the module's bars)."""
    big = float(want.abs().max())
    err = (got - want).abs()
    if dtype == torch.float64:
        assert bool((err <= 1e-6 * want.abs() + 1e-10 * big).all())
    elif float(err.max()) > 1e-4 * big:
        assert float((got - want64).abs().max()) \
            <= 2.0 * float((want - want64).abs().max())


def _match_plain(band, args, got, want, want64):
    """A wrapper's outputs (the layer matrices, then the clear-sky planes)
    against the plain build's: refined entries bit for bit, the rest and
    the planes as built (_close_as_built)."""
    dtype = args[0].dtype
    assert len(got) == len(want) and len(got[-1]) == len(want[-1])
    for g, w, w64 in zip(got[:-1], want[:-1], want64[:-1]):
        assert g.shape == w.shape and g.dtype == w.dtype
        g_ref, g_rest = _refined_entries(band, args, g)
        w_ref, w_rest = _refined_entries(band, args, w)
        # the clamp case's capped exponentials may overflow: NaN and inf
        # where the plain build has them
        torch.testing.assert_close(g_ref, w_ref, rtol=0, atol=0,
                                   equal_nan=True)
        if w_rest.numel():             # not every element refined
            _close_as_built(g_rest, w_rest,
                            _refined_entries(band, args, w64)[1], dtype)
    ncol, nlev, ng = args[0].shape
    for g, w, w64 in zip(got[-1], want[-1], want64[-1]):
        assert g.shape == w.shape == (nlev, ncol, ng)
        assert g.dtype == w.dtype
        _close_as_built(g, w, w64, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case,band", PAIRS)
def test_kernel_source_matches_plain(launches_on_cpu, exact_sqrt, states,
                                     case, band, dtype):
    args64 = states[case][0][band]
    args = _rounded(args64, dtype)
    plain = sp._sw_layer_mats if band == "sw" else sp._lw_layer_mats
    kernel = getattr(cuda_spartacus, f"_{NAMES[band]}_kernel")
    before = getattr(cuda_spartacus, NAMES[band]).launches
    got, want = kernel(*args), plain(*args)
    assert getattr(cuda_spartacus, NAMES[band]).launches == before + 1
    want64 = plain(*args64) if dtype == torch.float32 else want
    n_refined = int(args[USE[band]].sum())
    assert n_refined > 0
    _match_plain(band, args, got, want, want64)
    if case == "clear":
        clear = args[CLEAR[band]]
        assert bool(clear[::2].all()) and not bool(clear[1::2].all())
    if case == "everywhere":       # clear layers refined, their selects
        clear = args[CLEAR[band]]
        assert bool((args[USE[band]].any(-1) & clear).any())
    if case == "rrtmg":
        assert args[0].shape[2] == (112 if band == "sw" else 140)
    if band == "lw":   # the LW gas absorbs unless asked to scatter
        assert (args[1] is None) == (case != "scattering")
        assert bool((args[10] > 0.0).any()) == (case != "no_side")


@pytest.mark.parametrize("band", ["sw", "lw"])
def test_clamp_case_reaches_the_squaring_cap(states, band, monkeypatch):
    """The "clamp" inputs hold elements whose 1-norm asks for more
    squarings than the cap (13 SW, 6 LW): the plain build's own norms, read
    where it calls the exponential."""
    args = states["clamp"][0][band]
    norms = []
    if band == "sw":
        real = sp.pl_expm_blockut

        def spy(A11, A13, A33):
            cs = torch.cat([matrix._abs_colsums(A11),
                            matrix._abs_colsums(A13)
                            + matrix._abs_colsums(A33)])
            norms.append(cs.amax(0))
            return real(A11, A13, A33)
        monkeypatch.setattr(sp, "pl_expm_blockut", spy)
        cap = matrix._STATIC_SQUARINGS
        sp._sw_layer_mats(*args)
    else:
        real = sp.pl_expm

        def spy(G, max_squarings):
            norms.append(matrix._abs_colsums(G).amax(0))
            return real(G, max_squarings)
        monkeypatch.setattr(sp, "pl_expm", spy)
        cap = 6
        sp._lw_layer_mats(*args)
    wanted = torch.log2(torch.cat(norms) / matrix._THETA3)
    assert int((wanted > cap).sum()) >= 8


def test_route_calls_the_wrappers_once_a_band_set(states):
    """Each SPARTACUS band set's solver calls its wrapper once (the
    capture's count), with the plain build's argument layout: the band
    set's raw optics, the band map as int32, the LW gas absorbing (no ssa
    and g); and the CPU route launches nothing."""
    args = states["meridian"][0]
    assert args["sw"][0].shape == (32, 137, 32)
    assert args["sw"][6].dtype == args["lw"][6].dtype == torch.int32
    assert args["lw"][1] is None and args["lw"][2] is None
    assert args["lw"][PLANCK].stride() == (138 * 32, 32, 1)  # [:, :-1]
    assert args["sw"][14] is True and args["lw"][16] is True


def _flat(outs):
    """A wrapper's outputs, the clear-sky planes' tuple flattened."""
    return [*outs[:-1], *outs[-1]]


@pytest.mark.parametrize("band", ["sw", "lw"])
def test_cpu_runs_the_plain_build(states, band):
    args = states["ragged"][0][band]
    wrapper = getattr(cuda_spartacus, NAMES[band])
    plain = sp._sw_layer_mats if band == "sw" else sp._lw_layer_mats
    before = wrapper.launches
    for g, w in zip(_flat(wrapper(*args)), _flat(plain(*args)), strict=True):
        assert torch.equal(g, w)
    assert wrapper.launches == before


def _fault(band, args, fault):
    args = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    if band == "lw":    # Planck views of one half-level tensor, as routed
        ncol, nlev, ng = args[0].shape
        hl = torch.empty((ncol, nlev + 1, ng), dtype=args[0].dtype,
                         device="meta")
        args[PLANCK], args[PLANCK + 1] = hl[:, :-1], hl[:, 1:]
    if fault == "mask_dtype":
        args[USE[band]] = args[USE[band]].float()
    elif fault == "rank":
        args[0] = args[0][..., 0]
    elif fault == "clear_shape":
        args[CLEAR[band]] = args[CLEAR[band]][:, :-1]
    elif fault == "planck_strides":
        args[PLANCK] = args[PLANCK].contiguous()  # pl_bot keeps the view's
    elif fault == "band_dtype":
        args[6] = args[6].long()
    return args


FAULTS = [("meta", "unsupported device meta"),
          ("mask_dtype", "use_expm must be bool"),
          ("rank", r"od has shape \(5, 137\)"),
          ("clear_shape", r"clear_layer has shape \(5, 136\)"),
          ("band_dtype", r"band_from_g must be contiguous int32")]


@pytest.mark.parametrize("band,fault,match", [
    *((band, *f) for band in ("sw", "lw") for f in FAULTS),
    ("lw", "planck_strides", r"pl_bot has strides")])
def test_off_the_cpu_the_wrappers_raise_before_any_launch(states, band,
                                                          fault, match):
    """On the meta device the wrappers take the kernel branch and raise on
    what the kernels cannot take: the device itself, a mask that is not
    bool, a gas od of another rank, a clear mask of another shape, a band
    map that is not int32, LW Planck inputs of unlike strides; nothing is
    launched and there is no fallback."""
    args = _fault(band, states["ragged"][0][band], fault)
    wrapper = getattr(cuda_spartacus, NAMES[band])
    before = wrapper.launches
    with pytest.raises(ValueError, match=f"spartacus {NAMES[band]}: {match}"):
        wrapper(*args)
    assert wrapper.launches == before


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("band", ["sw", "lw"])
def test_a_launch_set_counts_once(launches_on_cpu, states, band, refine):
    """One call, one launch set (the build pass and, with any_expm, the
    refine pass), counted once; without any_expm no element is refined and
    the build pass writes every element's two-stream matrices (the plain
    build's, where use_expm is all false)."""
    args = list(states["ragged"][0][band])
    args[-1] = refine
    if not refine:
        args[USE[band]] = torch.zeros_like(args[USE[band]])
    wrapper = getattr(cuda_spartacus, NAMES[band])
    kernel = getattr(cuda_spartacus, f"_{NAMES[band]}_kernel")
    plain = sp._sw_layer_mats if band == "sw" else sp._lw_layer_mats
    before = wrapper.launches
    got = kernel(*args)
    assert wrapper.launches == before + 1
    ((name, specs),) = launches_on_cpu
    assert name == f"spartacus {NAMES[band]}"
    assert specs["od"][1] == (5, 137, 32)
    for g, w in zip(_flat(got), _flat(plain(*args)), strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-12 * float(w.abs().max()))


class _HostReads(TorchDispatchMode):
    """Records the operations that make the host wait for the card: a
    tensor's value read on the host (item, int, bool) and nonzero, whose
    shape depends on the data."""
    WAITS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default)

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.WAITS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("band", ["sw", "lw"])
@pytest.mark.parametrize("case", ["meridian", "rrtmg"])
def test_refined_counts_the_plain_builds_elements(launches_on_cpu, states,
                                                  monkeypatch, case, band):
    """The kernels' running total of refined elements (.refined: the
    refine pass adds the list's length on the card) grows by the plain
    build's use_expm.sum(), from an int left by earlier counts; the
    card's branch reads nothing back on the host for it; the CPU route
    counts the plain build's use_expm.sum() on the same total."""
    args = states[case][0][band]
    wrapper = getattr(cuda_spartacus, NAMES[band])
    kernel = getattr(cuda_spartacus, f"_{NAMES[band]}_kernel")
    want = int(args[USE[band]].sum())
    assert want > 0
    monkeypatch.setattr(wrapper, "refined", 5)
    with _HostReads() as reads:
        kernel(*args)
    assert reads.seen == []
    assert torch.is_tensor(wrapper.refined)
    assert wrapper.refined.dtype == torch.int64
    assert int(wrapper.refined) == 5 + want
    wrapper(*args)
    assert int(wrapper.refined) == 5 + 2 * want


def _refuse(*_, **__):
    raise AssertionError("called in torch on the kernels' route")


@pytest.mark.parametrize("band", ["sw", "lw"])
@pytest.mark.parametrize("case", ["ragged", "rrtmg"])
def test_sweep_args_take_the_kernel_route(launches_on_cpu, exact_sqrt,
                                          states, monkeypatch, case, band):
    """The sweep arguments built through the wrappers' kernel branch: no
    region merge, no region optics and no two-stream call in torch (each
    raises here), one launch set a band set (.launches), and the
    arguments equal the plain route's (the matrices and the clear-sky
    planes as the kernels build them, the rest bit for bit).  The CPU
    route counts no launch set."""
    inputs = states[case][2][band]
    build = getattr(sp, SWEEP_ARGS[band])
    wrapper = getattr(cuda_spartacus, NAMES[band])
    monkeypatch.setattr(wrapper, "launches", 0)
    opts, want, _ = build(*inputs)
    assert wrapper.launches == 0
    nmats = 5 if band == "sw" else 4

    kernel = getattr(cuda_spartacus, f"_{NAMES[band]}_kernel")
    # the spy carries the wrapper's counters: the kernel branch counts
    # through the module's name
    spy = functools.wraps(wrapper)(lambda *a: kernel(*a))
    spy.launches = 0
    monkeypatch.setattr(cuda_spartacus, NAMES[band], spy)
    for mod, fn in ((two_stream, "sw_ref_trans"), (two_stream, "lw_ref_trans"),
                    (cuda_tripleclouds, "merge_regions"),
                    (sp, "merge_regions"), (sp, "_region_optics"),
                    (sp, "_side_emissivity")):
        monkeypatch.setattr(mod, fn, _refuse)
    got_opts, got, _ = build(*inputs)
    assert spy.launches == 1
    assert got_opts == opts and len(got) == len(want)
    args = states[case][0][band]          # the wrapper's, for the mask
    _match_plain(band, args, got[:nmats + 1], want[:nmats + 1],
                 want[:nmats + 1])
    for g, w in zip(got[nmats + 1:], want[nmats + 1:]):
        assert torch.equal(g, w)


def _whole_plane_refinement(band, args):
    """The refined elements' matrices as the route built them before the
    kernels made the region optics: _region_optics and the LW side
    emissivity over whole (ncol, nlev, ng) planes (the side emissivity as
    lw_sweep_args computed it, a sum over the cloudy regions), gathered
    into _sw_refine / _lw_refine; the clear layers' selects applied.
    Returns the list of (c, l, k) indices and the matrices, each (N, K)."""
    od, ssa, g = args[:3]
    if ssa is None:
        ssa = g = torch.zeros_like(od)
    od3, ssa3, g3 = sp._region_optics(args[8], od, ssa, g, *args[3:8])
    use, clear = args[USE[band]], args[CLEAR[band]]
    c, l, k = use.nonzero(as_tuple=True)
    if band == "sw":
        mu0, tr_diff, tr_dir = args[9:12]
        res = sp._sw_refine(od3[c, l, k].T, ssa3[c, l, k].T, g3[c, l, k].T,
                            mu0[c], (1.0 / mu0)[c],
                            tr_diff[c, l].permute(1, 2, 0),
                            tr_dir[c, l].permute(1, 2, 0))
    else:
        tr, aspect, rf = args[9], args[10], args[11]
        pl_top, pl_bot = args[PLANCK], args[PLANCK + 1]
        lateral_od = (aspect[..., None] / (sp.NREG - 1.0)) * torch.sum(
            od3[..., 1:] * (1.0 - ssa3[..., 1:]), -1)
        sq1 = torch.sqrt(torch.clamp(1.0 - ssa3[..., 1], min=0.0))
        thick = 2.0 * sq1 / (sq1 + torch.sqrt(
            torch.clamp(1.0 - ssa3[..., 1] * g3[..., 1], min=0.0)))
        side = (sp.SIDE_EMISS_THIN - thick) / (lateral_od + 1.0) + thick
        side = torch.where((aspect > 0.0)[..., None], side, 1.0)
        res = sp._lw_refine(*(x.double() for x in (
            od3[c, l, k].T, ssa3[c, l, k].T, g3[c, l, k].T,
            tr[c, l].permute(1, 2, 0), side[c, l, k], rf[c, l].T,
            pl_top[c, l, k], pl_bot[c, l, k])))
        res = tuple(x.to(od.dtype) for x in res)
    clr = clear[c, l]
    out = []
    for x in res:
        x = x.reshape(-1, x.shape[-1]).T                  # (N, K)
        x = torch.where(clr[:, None] & (torch.arange(x.shape[1]) > 0),
                        0.0, x)
        out.append(x)
    return (c, l, k), out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case,band", [
    ("ragged", "sw"), ("ragged", "lw"), ("everywhere", "sw"),
    ("everywhere", "lw"), ("scattering", "lw"), ("no_side", "lw")])
def test_refine_pass_makes_the_region_optics_again(launches_on_cpu,
                                                   exact_sqrt, states, case,
                                                   band, dtype):
    """The refine pass makes each listed element's region optics and LW
    side emissivity from the raw inputs: its matrices equal, bit for bit,
    _sw_refine's / _lw_refine's fed the region optics and side emissivity
    built over whole planes, as the route built them before.  The cases
    hold refined elements where the side emissivity's condition fails (a
    clear or overcast layer: aspect 0) and, in no_side, a LW without side
    emissivity (aspect 0 everywhere)."""
    args = _rounded(states[case][0][band], dtype)
    got = getattr(cuda_spartacus, f"_{NAMES[band]}_kernel")(*args)
    (c, l, k), want = _whole_plane_refinement(band, args)
    assert c.numel() > 0
    for g, w in zip(got[:-1], want, strict=True):
        torch.testing.assert_close(g[l, :, c, k], w, rtol=0, atol=0,
                                   equal_nan=True)
    if band == "lw" and case == "everywhere":
        aspect = args[10][c, l]
        assert bool((aspect == 0.0).any()) and bool((aspect > 0.0).any())
    if case == "no_side":
        assert not bool((args[10] > 0.0).any())
