"""The metric readers on a synthetic profiler trace, and the work counts
against hand counts at small sizes."""

import types

import pytest

from benchmark import peaks, run, trace
from benchmark.work import (generator_draw_scan, lw_fused,
                            rrtmg_lw_taumol, rrtmg_sw_taumol, spartacus_lw,
                            spartacus_sw, sw_fused)

MAIN, OTHER = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                pid=0, args=args)


def _events():
    """Two calls of one block each, on the main thread: in each a
    generator range launching the draw kernel twice, an optics range
    launching a gather, a solvers range launching the two fused kernels
    and waiting 15 us for the device, and a kernel launched outside any
    layer, then the call's own synchronise.  Times in us."""
    ev, corr = [], [0]

    def launch(ts, name, k_ts, k_dur):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2,
                     correlation=corr[0]))
        ev.append(_x("kernel", name, k_ts, k_dur, tid=7,
                     correlation=corr[0]))

    for c, t0 in enumerate((0.0, 1000.0)):
        ev.append(_x("user_annotation", "bench.call", t0, 900))
        ev.append(_x("user_annotation", "bench.generator", t0 + 10, 100))
        launch(t0 + 20, "void generator_draw_scan_kernel<float>(...)",
               t0 + 30, 40)
        launch(t0 + 60, "void generator_draw_scan_kernel<float>(...)",
               t0 + 80, 50)
        ev.append(_x("user_annotation", "bench.optics", t0 + 200, 300))
        ev.append(_x("cpu_op", "aten::index", t0 + 210, 50))
        launch(t0 + 220, "indexing_kernel", t0 + 230, 200)
        ev.append(_x("user_annotation", "bench.solvers", t0 + 600, 100))
        launch(t0 + 610, "void lw_fused_kernel<float>(LwArgs<float>)",
               t0 + 620, 60)
        launch(t0 + 650, "void sw_fused_kernel<float>(SwArgs<float>)",
               t0 + 700, 80)
        ev.append(_x("cuda_runtime", "cudaStreamSynchronize", t0 + 680, 15))
        launch(t0 + 800, "elementwise_kernel", t0 + 810, 10)
        ev.append(_x("gpu_memcpy", "Memcpy DtoH", t0 + 850, 20, tid=7))
        ev.append(_x("cuda_runtime", "cudaDeviceSynchronize", t0 + 880, 15))
    # a range of the same name on another thread owns nothing here
    ev.append(_x("user_annotation", "bench.optics", 0, 5000, tid=OTHER))
    ev.append(dict(ph="f", name="flow", ts=1, id=1))
    return ev


@pytest.fixture
def tr():
    return trace.parse(_events())


def _run(tr, **kw):
    lo, hi = trace.window(tr, "bench.call")
    shape = dict(ncol=4, nlev=3, ng_sw=2, ng_lw=5, nband_sw=2, nband_lw=3,
                 itemsize=4, cloudy=0.5)
    r = types.SimpleNamespace(trace=tr, lo=lo, hi=hi, kcol=2 * 4 / 1000.0,
                              block_shapes=[shape, shape],
                              work=run.work_modules(), issue_rate=1e12)
    r.__dict__.update(kw)
    return r


def _reader(name):
    return run._load_module(f"{run.HERE}/metrics/{name}.py")


def test_parse_and_window(tr):
    assert len(tr.kernels) == 12
    assert len(tr.device_ops) == 14
    assert trace.window(tr, "bench.call") == (0.0, 1900.0)
    assert trace.window(tr, "bench.nothing") is None


def test_layer_device_and_host_times(tr):
    r = _run(tr)
    gen = _reader("generator_dev_ms_per_kcol").read(r)
    assert gen == pytest.approx(1e-3 * 2 * (40 + 50) / r.kcol)
    assert _reader("optics_dev_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * 200 / r.kcol)
    assert _reader("solvers_dev_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * (60 + 80) / r.kcol)
    assert _reader("generator_host_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * 100 / r.kcol)
    # the other thread's optics range counts in host time only
    assert _reader("optics_host_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * (2 * 300 + 5000) / r.kcol)
    # the solvers' wait for the device is not their host time
    assert _reader("solvers_host_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * (100 - 15) / r.kcol)


def test_host_waits(tr):
    """The waits inside the layers are counted apart; the call's own
    synchronise, outside every layer, is not among them."""
    assert len(tr.waits) == 4
    assert trace.range_wait_us(tr, "bench.solvers") == pytest.approx(30)
    assert trace.range_wait_us(tr, "bench.generator") == 0
    r = _run(tr)
    assert _reader("host_wait_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * 2 * 15 / r.kcol)
    bare = tr._replace(ranges=[x for x in tr.ranges if x[0] == "bench.call"])
    assert _reader("host_wait_ms_per_kcol").read(_run(bare)) is None


def test_a_layer_without_its_range_reads_nothing(tr):
    bare = tr._replace(ranges=[x for x in tr.ranges
                               if x[0] != "bench.generator"])
    r = _run(bare)
    assert _reader("generator_dev_ms_per_kcol").read(r) is None
    assert _reader("generator_host_ms_per_kcol").read(r) is None


def test_idle_and_launches(tr):
    r = _run(tr)
    busy = 2 * (40 + 50 + 200 + 60 + 80 + 10 + 20)
    assert trace.busy_us(tr, r.lo, r.hi) == pytest.approx(busy)
    assert _reader("device_idle_pct").read(r) == pytest.approx(
        100 * (1 - busy / 1900))
    assert _reader("launches_per_kcol").read(r) == pytest.approx(12 / r.kcol)
    assert _reader("device_busy_ms_per_kcol").read(r) == pytest.approx(
        1e-3 * busy / r.kcol)
    idle = tr._replace(device_ops=[])
    assert _reader("device_busy_ms_per_kcol").read(_run(idle)) is None


def test_busy_merges_overlaps():
    tr = trace.parse([_x("kernel", "a", 0, 10, correlation=1),
                      _x("kernel", "b", 5, 10, correlation=2),
                      _x("gpu_memset", "m", 30, 5)])
    assert trace.busy_intervals(tr, 0, 100) == [(0, 15), (30, 35)]
    assert trace.busy_us(tr, 8, 32) == pytest.approx(7 + 2)


def test_roofline_share(tr):
    r = _run(tr)
    least = sum(peaks.least_seconds(w, r.issue_rate)
                for m in (generator_draw_scan, lw_fused, sw_fused)
                for s in r.block_shapes for w in m.block_launches(s))
    device = 2 * (40 + 50 + 60 + 80) * 1e-6
    got = _reader("kernel_roofline_pct").read(r)
    assert got == pytest.approx(100 * least / device)


def test_roofline_not_read_from_unmatched_launches(tr):
    r = _run(tr, block_shapes=[r_ for r_ in _run(tr).block_shapes[:1]])
    # one block's work against two blocks' launches: nothing matches
    assert _reader("kernel_roofline_pct").read(r) is None
    assert _reader("kernel_roofline_pct").read(
        _run(tr, issue_rate=None)) is None
    # a trace that lost one kernel's launch of the last block
    last_lw = max((k for k in tr.kernels if "lw_fused" in k[0]),
                  key=lambda k: k[1])
    lost = tr._replace(kernels=[k for k in tr.kernels if k != last_lw])
    assert trace.lost_kernels(lost) == 1 and trace.lost_kernels(tr) == 0
    assert _reader("kernel_roofline_pct").read(_run(lost)) is None


def test_breakdown(tr):
    r = _run(tr)
    top = trace.top_device_ops(tr, r.lo, r.hi)
    assert top[0] == ["indexing_kernel", pytest.approx(400e-6)]
    assert len(top) == 6
    gaps = dict(trace.idle_gaps(tr, r.lo, r.hi, tid=MAIN))
    # each gap goes to the innermost range open at its midpoint; the gap
    # from 870 to 1030 us, between the calls, to none
    assert gaps == pytest.approx({
        "bench.generator": (30 + 10 + 10) * 1e-6,
        "bench.solvers": 2 * 20 * 1e-6,
        "bench.call": (2 * (100 + 190 + 30 + 30) + 30) * 1e-6,
        "none": 160e-6})
    assert sum(gaps.values()) == pytest.approx(
        (1900 - trace.busy_us(tr, r.lo, r.hi)) * 1e-6)
    assert trace.thread_of(tr, "bench.call") == MAIN


def test_work_counts_by_hand():
    s = dict(ncol=2, nlev=3, ng_sw=4, ng_lw=5, nband_sw=6, nband_lw=7,
             itemsize=4, cloudy=0.25)
    sw, lw = generator_draw_scan.block_launches(s)
    assert lw["int_ops"] == 2 * 5 * (3 * 3 + 1) * 70 + 2 * 4 * 67
    assert sw["flops"] == 23 * 2 * 3 * 4
    assert lw["bytes"] == 4 * (2 * 2 + 4 * 2 * 3 + 2 * 3 * 5)
    (w,) = lw_fused.block_launches(s)
    assert w["flops"] == pytest.approx((49 + 54 * 0.25) * 2 * 3 * 5)
    assert w["bytes"] == (4 * (2 * 30 + 3 * 42 + 2 * 4 * 5 + 2 * 10)
                          + 6 + 4 * (4 * 6 + 6 * 10 + 2 * 6))
    (w,) = sw_fused.block_launches(s)
    assert w["flops"] == pytest.approx((163 + 121 * 0.25) * 2 * 3 * 4)
    assert w["bytes"] == (4 * (4 * 24 + 3 * 36 + 2 + 3 * 8) + 6
                          + 4 * 2 * (3 * 6 + 3 * 8))


def test_planes_and_gas_optics_work_by_hand():
    """The fused kernels' builds with per-g planes write 4 (LW) and 6 (SW)
    planes at the half-levels more than the builds without, which count
    as before; the RRTMG gas optics kernels read the gas columns, their
    temperatures and tables and write their outputs once."""
    s = dict(ncol=2, nlev=3, ng_sw=4, ng_lw=5, nband_sw=6, nband_lw=7,
             itemsize=4, cloudy=0.25)
    (lw,), (sw,) = lw_fused.block_launches(s), sw_fused.block_launches(s)
    for key in ({}, {"planes": False}):
        assert lw_fused.block_launches({**s, **key}) == [lw]
        assert sw_fused.block_launches({**s, **key}) == [sw]
    (lwp,) = lw_fused.block_launches({**s, "planes": True})
    (swp,) = sw_fused.block_launches({**s, "planes": True})
    assert lwp["bytes"] - lw["bytes"] == 4 * 4 * 2 * 4 * 5
    assert swp["bytes"] - sw["bytes"] == 4 * 6 * 2 * 4 * 4
    assert lwp["flops"] == lw["flops"] and swp["flops"] == sw["flops"]
    rows = 2 * 3
    columns = rows * (4 * 38 + 8 * 6 + 1)
    (w,) = rrtmg_lw_taumol.block_launches(s)
    assert w["flops"] == 35 * rows * 5 and w["int_ops"] == 0
    assert w["bytes"] == (columns + 4 * (2 * 4 + 2 + 145552)
                          + 4 * (rows * 5 + 2 * 4 * 5 + 2 * 5))
    (w,) = rrtmg_sw_taumol.block_launches(s)
    assert w["flops"] == 23 * rows * 4 and w["int_ops"] == 0
    assert w["bytes"] == (columns + 4 * 87469
                          + 4 * (2 * rows * 4 + 2 * 4))


def test_spartacus_work_by_hand():
    """The SPARTACUS sweeps read every entry of their layer matrices in a
    cloudy layer and those of region 0 (and Tdir's first column) in a clear
    one, with the clear-sky coefficients, the per-level and the surface
    inputs once, and write their profiles once."""
    s = dict(ncol=2, nlev=3, ng_sw=4, ng_lw=5, nband_sw=6, nband_lw=7,
             itemsize=4, cloudy=0.25)
    (w,) = spartacus_sw.block_launches(s)
    assert w["flops"] == 700 * 2 * 3 * 4 and w["int_ops"] == 0
    assert w["bytes"] == pytest.approx(4 * (
        (45 * 0.25 + 7 * 0.75 + 5) * 24 + (27 + 4 + 2 + 13) * 6
        + (18 + 2 + 3 + 1) * 8 + (9 + 2 + 6 * 3) * 8))
    (w,) = spartacus_lw.block_launches(s)
    assert w["flops"] == 400 * 2 * 3 * 5 and w["int_ops"] == 0
    assert w["bytes"] == pytest.approx(4 * (
        (24 * 0.25 + 4 * 0.75 + 4) * 30 + (27 + 2 + 2) * 6
        + (9 + 3 + 1 + 1) * 10 + (3 + 1 + 4 * 3) * 10))
    # all-clear: the layer matrices' clear entries only
    clear = spartacus_sw.block_launches({**s, "cloudy": 0.0})[0]["bytes"]
    cloudy = spartacus_sw.block_launches({**s, "cloudy": 1.0})[0]["bytes"]
    assert cloudy - clear == pytest.approx(4 * (45 - 7) * 24)


def test_least_time_takes_the_longest_term():
    w = dict(flops=67e12, int_ops=0.0, bytes=3.35e12)
    assert peaks.least_seconds(w, 1e12) == pytest.approx(1.0)
    w = dict(flops=0.0, int_ops=4e12, bytes=1.0)
    assert peaks.least_seconds(w, 1e12) == pytest.approx(4.0)
    assert peaks.issue_per_s(132, 1980.0) == pytest.approx(
        132 * 128 * 1.98e9)
