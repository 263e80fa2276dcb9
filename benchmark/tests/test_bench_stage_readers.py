"""The readers of the SPARTACUS solver stages' spans, of the idle time
under the solvers and the outputs, and of the launches per span
(``launches.py``), on a synthetic profiler trace against values computed
by hand."""

import types

import pytest

from benchmark import launches, run, spans, trace

MAIN, OTHER = 1, 2
STAGES = ("mask_dev_ms_per_kcol", "sweep_inputs_dev_ms_per_kcol",
          "sweep_inputs_host_ms_per_kcol", "sweeps_dev_ms_per_kcol",
          "lw_derivatives_host_ms_per_kcol",
          "lw_derivatives_idle_ms_per_kcol",
          "lw_derivatives_launches_per_block", "assemble_dev_ms_per_kcol",
          "assemble_host_ms_per_kcol")
LAYERS = ("solvers_idle_ms_per_kcol", "outputs_idle_ms_per_kcol",
          "solvers_launches_per_block")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                pid=0, args=args)


def _events():
    """Two calls of one block each on the main thread, times in us from
    the call's start.  In the step: outputs 40-60; the solvers 100-700,
    and in them the mask 110-130 (a kernel at 140-150), the sweep inputs
    140-200 (a kernel at 160-180) and 250-280 (300-310), the layer
    matrices 200-250 (220-300), the sweeps 290-320 (310-400), the LW
    derivatives 330-530 (three launches, one a driver call, kernels at
    400-410, 410-420 and 500-505; a fill queued that launches no kernel;
    a synchronise waiting 30 us at 450), the assembly 540-600 (550-560);
    then outputs 710-760.  Another thread launches a kernel (302-306,
    inside busy time) while the LW derivatives are open on the main one."""
    ev, corr = [], [0]

    def launch(ts, k_ts, k_dur, tid=MAIN, call="cudaLaunchKernel",
               cat="cuda_runtime"):
        corr[0] += 1
        ev.append(_x(cat, call, ts, 2, tid=tid, correlation=corr[0]))
        ev.append(_x("kernel", "kernel", k_ts, k_dur, tid=7,
                     correlation=corr[0]))

    def span(name, ts, dur):
        ev.append(_x("user_annotation", name, ts, dur))

    for t0 in (0.0, 1000.0):
        span("bench.call", t0, 900)
        span("ecrad.step", t0 + 20, 780)
        span("ecrad.outputs", t0 + 40, 20)
        span("ecrad.solvers", t0 + 100, 600)
        span("ecrad.solvers.mask", t0 + 110, 20)
        launch(t0 + 112, t0 + 140, 10)
        span("ecrad.solvers.sweep_inputs", t0 + 140, 60)
        launch(t0 + 150, t0 + 160, 20)
        span("ecrad.solvers.layer_mats", t0 + 200, 50)
        launch(t0 + 210, t0 + 220, 80)
        span("ecrad.solvers.sweep_inputs", t0 + 250, 30)
        launch(t0 + 260, t0 + 300, 10)
        span("ecrad.solvers.sweeps", t0 + 290, 30)
        launch(t0 + 295, t0 + 310, 90)
        span("ecrad.solvers.lw_derivatives", t0 + 330, 200)
        launch(t0 + 340, t0 + 400, 10)
        launch(t0 + 360, t0 + 410, 10, call="cuLaunchKernel",
               cat="cuda_driver")
        launch(t0 + 350, t0 + 302, 4, tid=OTHER)
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaMemsetAsync", t0 + 370, 2,
                     correlation=corr[0]))
        launch(t0 + 380, t0 + 500, 5)
        ev.append(_x("cuda_runtime", "cudaStreamSynchronize", t0 + 450, 30))
        span("ecrad.solvers.assemble", t0 + 540, 60)
        launch(t0 + 545, t0 + 550, 10)
        span("ecrad.outputs", t0 + 710, 50)
    return ev


@pytest.fixture
def tr():
    return trace.parse(_events())


def _run(tr):
    lo, hi = trace.window(tr, "bench.call")
    return types.SimpleNamespace(trace=tr, lo=lo, hi=hi,
                                 kcol=2 * 4 / 1000.0)


def _reader(name):
    return run._load_module(f"{run.HERE}/metrics/{name}.py")


def _per_kcol(r, us_per_call):
    return 1e-3 * 2 * us_per_call / r.kcol


def test_stage_device_and_host_times(tr):
    r = _run(tr)
    assert _reader("mask_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 10))
    assert _reader("sweep_inputs_dev_ms_per_kcol").read(r) == \
        pytest.approx(_per_kcol(r, 20 + 10))
    assert _reader("sweep_inputs_host_ms_per_kcol").read(r) == \
        pytest.approx(_per_kcol(r, 60 + 30))
    assert _reader("sweeps_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 90))
    assert _reader("assemble_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 10))
    assert _reader("assemble_host_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 60))
    # the synchronise is not the derivatives' host time
    assert _reader("lw_derivatives_host_ms_per_kcol").read(r) == \
        pytest.approx(_per_kcol(r, 200 - 30))


def test_idle_under_the_solvers_and_outputs(tr):
    """Busy: 140-150, 160-180, 220-420 (the other thread's kernel inside
    it), 500-505, 550-560 in each call."""
    r = _run(tr)
    # 100-140, 150-160, 180-220, 420-500, 505-550, 560-700
    assert _reader("solvers_idle_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 40 + 10 + 40 + 80 + 45 + 140))
    # 420-500 and 505-530
    assert _reader("lw_derivatives_idle_ms_per_kcol").read(r) == \
        pytest.approx(_per_kcol(r, 80 + 25))
    assert _reader("outputs_idle_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 20 + 50))


def test_launches_per_block(tr):
    """Runtime and driver launches count; a fill, and a launch on another
    thread while the span is open on the main one, do not."""
    assert launches.launches_in(tr, "ecrad.solvers.lw_derivatives") == 6
    r = _run(tr)
    assert _reader("lw_derivatives_launches_per_block").read(r) == 3.0
    # mask 1, sweep inputs 2, layer matrices 1, sweeps 1, derivatives 3,
    # assembly 1
    assert _reader("solvers_launches_per_block").read(r) == 9.0


def test_a_launch_on_another_thread_is_not_counted(tr):
    """The same trace with the derivatives' span on the other thread: only
    the other thread's launch lies in it."""
    moved = tr._replace(ranges=[
        (n, ts, dur, OTHER if n == "ecrad.solvers.lw_derivatives" else tid)
        for n, ts, dur, tid in tr.ranges])
    assert launches.launches_in(moved, "ecrad.solvers.lw_derivatives") == 2


def test_nothing_read_without_the_spans(tr):
    """A program without the stages' spans (the parent's SPARTACUS route,
    or another route) reads none of the stage metrics, and still the
    solvers' and outputs' idle time and launches; a program that opens
    no span of its own reads nothing."""
    stages = tr._replace(ranges=[x for x in tr.ranges
                                 if not x[0].startswith("ecrad.solvers.")])
    for name in STAGES:
        assert _reader(name).read(_run(stages)) is None, name
    for name in LAYERS:
        assert _reader(name).read(_run(stages)) is not None, name
    bare = tr._replace(ranges=[x for x in tr.ranges
                               if not x[0].startswith(spans.PREFIX)])
    for name in STAGES + LAYERS:
        assert _reader(name).read(_run(bare)) is None, name
