"""The readers of the program's own spans (``ecrad.*``, ``spans.py``) on a
synthetic profiler trace, against values computed by hand."""

import types

import pytest

from benchmark import run, spans, trace

MAIN, OTHER = 1, 2
READERS = ("gas_dev_ms_per_kcol", "aerosol_dev_ms_per_kcol",
           "cloud_optics_dev_ms_per_kcol", "cumulator_host_ms_per_kcol",
           "sampler_dev_ms_per_kcol", "blocking_dev_ms_per_kcol",
           "outputs_host_ms_per_kcol", "generator_idle_ms_per_kcol",
           "optics_idle_ms_per_kcol", "idle_unspanned_pct",
           "syncs_per_block")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                pid=0, args=args)


def _events():
    """Two calls of one block each on the main thread, times in us from
    the call's start: the blocking's pad (a kernel at 10-15) and
    concatenation (820-826); in the step the generator (30-200: the
    cumulator 40-100 with a 10 us synchronise and a kernel at 60-80, the
    sampler 120-180 with a kernel at 140-170), the optics (220-500: gas
    250-350, aerosol 355-375, cloud 380-420 and one kernel of the optics'
    own at 460-470), outputs 510-530 and 710-790, the solvers (540-700: a
    kernel at 600-650, a copy to the host waiting 30 us, the copy at
    650-660); then the call's synchronise.  Another thread holds an
    optics span over everything and launches nothing."""
    ev, corr = [], [0]

    def launch(ts, k_ts, k_dur, name="kernel"):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2,
                     correlation=corr[0]))
        ev.append(_x("kernel", name, k_ts, k_dur, tid=7,
                     correlation=corr[0]))

    def span(name, ts, dur):
        ev.append(_x("user_annotation", name, ts, dur))

    for t0 in (0.0, 1000.0):
        span("bench.call", t0, 900)
        span("ecrad.blocking", t0 + 5, 10)
        launch(t0 + 8, t0 + 10, 5, "CatArrayBatchedCopy")
        span("ecrad.step", t0 + 20, 780)
        span("ecrad.generator", t0 + 30, 170)
        span("ecrad.generator.cumulator", t0 + 40, 60)
        launch(t0 + 45, t0 + 60, 20)
        ev.append(_x("cuda_runtime", "cudaStreamSynchronize", t0 + 50, 10))
        span("ecrad.generator.sampler", t0 + 120, 60)
        launch(t0 + 130, t0 + 140, 30)
        span("ecrad.optics", t0 + 220, 280)
        span("ecrad.optics.gas", t0 + 230, 70)
        launch(t0 + 240, t0 + 250, 100, "vectorized_gather_kernel")
        span("ecrad.optics.aerosol", t0 + 310, 20)
        launch(t0 + 315, t0 + 355, 20)
        span("ecrad.optics.cloud", t0 + 340, 60)
        launch(t0 + 350, t0 + 380, 40)
        launch(t0 + 450, t0 + 460, 10)
        span("ecrad.outputs", t0 + 510, 20)
        span("ecrad.solvers", t0 + 540, 160)
        launch(t0 + 550, t0 + 600, 50, "lw_fused_kernel")
        ev.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 + 560, 30))
        ev.append(_x("gpu_memcpy", "Memcpy DtoH", t0 + 650, 10, tid=7))
        span("ecrad.outputs", t0 + 710, 80)
        span("ecrad.blocking", t0 + 810, 20)
        launch(t0 + 815, t0 + 820, 6, "CatArrayBatchedCopy")
        ev.append(_x("cuda_runtime", "cudaDeviceSynchronize", t0 + 850, 40))
    ev.append(_x("user_annotation", "ecrad.optics", 0, 5000, tid=OTHER))
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


def test_device_and_host_times(tr):
    r = _run(tr)
    assert _reader("gas_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 100))
    assert _reader("aerosol_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 20))
    assert _reader("cloud_optics_dev_ms_per_kcol").read(r) == \
        pytest.approx(_per_kcol(r, 40))
    # the optics' own kernel is in none of the three
    assert spans.device_ms_per_kcol(r, spans.OPTICS) == pytest.approx(
        _per_kcol(r, 100 + 20 + 40 + 10))
    assert _reader("sampler_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 30))
    # the pad's and the concatenation's kernels
    assert _reader("blocking_dev_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 5 + 6))
    # the cumulator's synchronise is not its host time
    assert _reader("cumulator_host_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 60 - 10))
    assert _reader("outputs_host_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 20 + 80))


def test_idle_under_spans(tr):
    """Idle time under a span is counted on the calls' thread only: the
    other thread's optics span, open throughout, adds nothing."""
    r = _run(tr)
    assert _reader("generator_idle_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 170 - 20 - 30))
    assert _reader("optics_idle_ms_per_kcol").read(r) == pytest.approx(
        _per_kcol(r, 280 - 100 - 20 - 40 - 10))


def test_idle_unspanned(tr):
    r = _run(tr)
    busy = 2 * (5 + 20 + 30 + 100 + 20 + 40 + 10 + 50 + 10 + 6)
    assert trace.busy_us(tr, r.lo, r.hi) == pytest.approx(busy)
    idle = 1900 - busy
    # before the blocking's pad, between it and the step, between the
    # step and the concatenation, the call's end, and between the calls
    unspanned = 2 * (5 + 5 + 10 + 70) + 100
    assert _reader("idle_unspanned_pct").read(r) == pytest.approx(
        100 * unspanned / idle)


def test_idle_unspanned_extremes(tr):
    calls = [x for x in tr.ranges if x[0] == "bench.call"]
    # a step span over the whole stretch: every idle moment is spanned
    whole = tr._replace(ranges=calls + [("ecrad.step", 0.0, 1900.0, MAIN)])
    assert _reader("idle_unspanned_pct").read(_run(whole)) == 0.0
    # the program's spans only on another thread: none is
    elsewhere = tr._replace(
        ranges=calls + [("ecrad.step", 0.0, 1900.0, OTHER)])
    assert _reader("idle_unspanned_pct").read(_run(elsewhere)) == 100.0


def test_syncs_per_block(tr):
    """The cumulator's synchronise and the solvers' copy to the host are
    in the step; the call's own synchronise is not."""
    assert spans.waits_in(tr, spans.STEP) == 4
    assert _reader("syncs_per_block").read(_run(tr)) == pytest.approx(2.0)


def test_nothing_read_without_the_spans(tr):
    """A program that opens no span of its own (the harness's ranges
    alone) reads nothing."""
    bare = tr._replace(ranges=[x for x in tr.ranges
                               if not x[0].startswith(spans.PREFIX)])
    for name in READERS:
        assert _reader(name).read(_run(bare)) is None, name


def test_spans_wrap_every_route_s_solvers():
    """The solvers' range wraps the LW and SW solvers of every route of
    the port's interface while open, and restores them after."""
    import importlib

    from benchmark import program
    modules = {name: importlib.import_module(f"ecrad_torch.solvers.{name}")
               for name in program.SOLVER_MODULES}
    before = {(n, b): getattr(m, f"solver_{n}_{b}")
              for n, m in modules.items() for b in ("lw", "sw")}
    assert {"mcica", "tripleclouds", "spartacus", "cloudless"} \
        == set(modules)
    with program.spans():
        for (n, b), fn in before.items():
            wrapped = getattr(modules[n], f"solver_{n}_{b}")
            assert wrapped is not fn and wrapped.__wrapped__ is fn
    for (n, b), fn in before.items():
        assert getattr(modules[n], f"solver_{n}_{b}") is fn
