"""The Tripleclouds cell's new pieces found by name and checked by hand: the
two fused kernels' work counts against hand counts and against the
kernels' own arguments and outputs at a small shape, with and without
per-g planes; the readers of the region set-up's span on a synthetic
trace, reading nothing where the span is absent; and the cell
``tripleclouds_ecckd.slab16k`` with its configuration, mix and metrics."""

import json
import types

import pytest
import torch

from benchmark import run, trace
from benchmark.work import tripleclouds_lw, tripleclouds_sw

SHAPE = dict(ncol=2, nlev=3, ng_sw=4, ng_lw=5, nband_sw=6, nband_lw=7,
             itemsize=4, cloudy=0.25)
CELL = "tripleclouds_ecckd.slab16k"
REGION_METRICS = ("regions_dev_ms_per_kcol", "regions_per_block")


def test_tripleclouds_work_by_hand():
    (w,) = tripleclouds_lw.block_launches(SHAPE)
    assert w["flops"] == pytest.approx((97 + 174 * 0.25) * 2 * 3 * 5)
    assert w["int_ops"] == 0
    # od; three cloud planes per band; scal2 and rf3; u9, v9; Planck;
    # emission, albedo, src0; then the clear flags and the band index
    assert w["bytes"] == (4 * (30 + 3 * 42 + 5 * 6 + 18 * 8 + 40 + 5 * 10)
                          + 6 + 4 * 5
                          + 4 * (5 * 6 + 8 * 10))
    (w,) = tripleclouds_sw.block_launches(SHAPE)
    assert w["flops"] == pytest.approx((157 + 354 * 0.25) * 2 * 3 * 4)
    assert w["int_ops"] == 0
    # od, ssa, g; the cloud's per band; scal2; v9; mu0; incoming, fdir0
    # and the four surface planes; the clear flags and the band index
    assert w["bytes"] == (4 * (3 * 24 + 3 * 36 + 2 * 6 + 9 * 8 + 2 + 12 * 8)
                          + 6 + 4 * 4
                          + 4 * (6 * 6 + 8 * 8))
    # all clear: the operations of the clear sky and region 0 alone
    for m, ops, ng in ((tripleclouds_lw, 97, 5), (tripleclouds_sw, 157, 4)):
        (w,) = m.block_launches({**SHAPE, "cloudy": 0.0})
        assert w["flops"] == ops * 2 * 3 * ng


def test_tripleclouds_planes_by_hand():
    """The builds with per-g planes write 4 (LW) and 6 (SW) planes at the
    half-levels more; the operations do not change."""
    (lw,), (sw,) = (tripleclouds_lw.block_launches(SHAPE),
                    tripleclouds_sw.block_launches(SHAPE))
    for key in ({}, {"planes": False}):
        assert tripleclouds_lw.block_launches({**SHAPE, **key}) == [lw]
        assert tripleclouds_sw.block_launches({**SHAPE, **key}) == [sw]
    (lwp,) = tripleclouds_lw.block_launches({**SHAPE, "planes": True})
    (swp,) = tripleclouds_sw.block_launches({**SHAPE, "planes": True})
    assert lwp["bytes"] - lw["bytes"] == 4 * 4 * 2 * 4 * 5
    assert swp["bytes"] - sw["bytes"] == 4 * 6 * 2 * 4 * 4
    assert lwp["flops"] == lw["flops"] and swp["flops"] == sw["flops"]


def _kernel_args(ncol, nlev, ng, nband):
    """The fused kernels' arguments (the port's lw_fused_args and
    sw_fused_args) on random inputs of one shape, float32 on the CPU."""
    from ecrad_torch.config import Config
    from ecrad_torch.solvers import tripleclouds
    gen = torch.Generator().manual_seed(5)
    r = lambda *s: torch.rand(s, generator=gen)             # noqa: E731
    frac = torch.where(r(ncol, nlev) > 0.5, r(ncol, nlev), 0.0)
    band = torch.arange(ng) * nband // ng
    config = Config().replace(do_lw_derivatives=True,
                              do_sw_delta_scaling_with_gases=False)
    common = (r(ncol, nlev, nband), r(ncol, nlev, nband),
              r(ncol, nlev, nband), band, frac, r(ncol, nlev),
              r(ncol, nlev - 1))
    lw, _ = tripleclouds.lw_fused_args(
        config, r(ncol, nlev, ng), *common, r(ncol, nlev + 1, ng),
        r(ncol, ng), r(ncol, ng))
    sw, _ = tripleclouds.sw_fused_args(
        config, r(ncol, nlev, ng), r(ncol, nlev, ng), r(ncol, nlev, ng),
        *common, r(ncol, ng), r(ncol) - 0.3, r(ncol, ng), r(ncol, ng))
    return lw, sw, float((frac > 0).double().mean())


@pytest.mark.parametrize("planes", (False, True))
def test_tripleclouds_work_is_the_kernels_tensors(planes):
    """The bytes are those of every input and output of the kernel's call
    once (the band index as the int32 the kernel reads), as
    ``chip_smoke.py``'s bound counts them."""
    from ecrad_torch.solvers import cuda_tripleclouds
    n, l, g, b = 3, 6, 5, 4
    lw, sw, cloudy = _kernel_args(n, l, g, b)
    shape = dict(ncol=n, nlev=l, ng_sw=g, ng_lw=g, nband_sw=b, nband_lw=b,
                 itemsize=4, cloudy=cloudy, planes=planes)
    for work, fn, args in (
            (tripleclouds_lw, cuda_tripleclouds.lw_fused_plain, lw),
            (tripleclouds_sw, cuda_tripleclouds.sw_fused_plain, sw)):
        out = fn(*args, planes=planes)
        tensors = [a for a in args if torch.is_tensor(a)] + list(
            out.values())
        nbytes = sum(t.numel() * t.element_size() for t in tensors
                     if t.dtype != torch.int64) + 4 * g
        (w,) = work.block_launches(shape)
        assert w["bytes"] == nbytes, work.KERNEL


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                pid=0, args=args)


def _events(regions=True):
    """Two calls of one block each: in each step the solvers' span, and in
    it the regions' span twice (once per band set), each launching one
    kernel of 10 and 15 us, then a fused kernel of 50 us outside them."""
    ev, corr = [], [0]

    def launch(ts, k_ts, k_dur, name="elementwise_kernel"):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2,
                     correlation=corr[0]))
        ev.append(_x("kernel", name, k_ts, k_dur, tid=7,
                     correlation=corr[0]))

    for t0 in (0.0, 1000.0):
        ev.append(_x("user_annotation", "bench.call", t0, 900))
        ev.append(_x("user_annotation", "ecrad.step", t0 + 10, 800))
        ev.append(_x("user_annotation", "ecrad.solvers", t0 + 100, 600))
        for ts, dur in ((110, 10), (400, 15)):
            if regions:
                ev.append(_x("user_annotation", "ecrad.solvers.regions",
                             t0 + ts, 40))
            launch(t0 + ts + 5, t0 + ts + 10, dur)
        launch(t0 + 500, t0 + 550, 50, "tripleclouds_lw_kernel")
    return ev


def _run(regions=True):
    tr = trace.parse(_events(regions))
    lo, hi = trace.window(tr, "bench.call")
    return types.SimpleNamespace(trace=tr, lo=lo, hi=hi, kcol=2 * 4 / 1e3)


def _reader(name):
    return run._load_module(f"{run.HERE}/metrics/{name}.py")


def test_region_readers_on_a_synthetic_trace():
    r = _run()
    assert _reader("regions_dev_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * (10 + 15) / r.kcol)
    assert _reader("regions_per_block").read(r) == 2.0


def test_region_readers_read_nothing_without_the_span():
    for name in REGION_METRICS:
        assert _reader(name).read(_run(regions=False)) is None, name


def test_the_cell_is_found_by_name():
    cell = run.load_cell(CELL)
    assert cell.config["name"] == "tripleclouds_ecckd"
    assert cell.config["config"]["sw_solver"] == "TRIPLECLOUDS"
    assert cell.config["config"]["lw_solver"] == "TRIPLECLOUDS"
    assert cell.config["reduced"] == []
    assert set(cell.traffic) == set(run.TRAFFIC_KEYS)
    assert (cell.traffic["ncol"], cell.traffic["block"]) == (16384, 8192)
    assert set(cell.end_to_end) == {"cols_per_s", "step_peak_gib",
                                    "setup_s"}
    assert set(REGION_METRICS) <= set(cell.per_layer)
    assert not any(k.startswith(("generator", "cumulator", "sampler"))
                   for k in cell.per_layer)
    # the two kernels' work is found beside the others'
    work = run.work_modules()
    assert work["tripleclouds_lw"].KERNEL == "tripleclouds_lw_kernel"
    assert work["tripleclouds_sw"].KERNEL == "tripleclouds_sw_kernel"
    # no other kernel's name holds theirs, nor theirs another's
    names = [m.KERNEL for m in work.values()]
    for a in names:
        assert [b for b in names if a in b] == [a], a
    # the region metrics are read in the two cells that build regions
    with open(f"{run.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in REGION_METRICS:
            assert m["workloads"] == ["spartacus_ecckd.slab16k", CELL]
    assert set(REGION_METRICS) <= set(
        run.load_cell("spartacus_ecckd.slab16k").per_layer)
    assert not set(REGION_METRICS) & set(
        run.load_cell("ecckd_mcica.slab16k").per_layer)
