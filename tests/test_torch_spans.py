"""The step's profiler spans (``profiling.scope``) on the CPU: one
``pipeline.radiation_blocked`` call of two blocks under torch.profiler
opens every span as often as SPANS and the configuration's own spans say,
each inside its parent on the same thread; without a profiler no
``record_function`` is opened; and the fluxes are bit for bit the same
with and without one, in float64 and float32.  SPARTACUS runs on a window
of levels, where its CPU step takes seconds."""

import collections
import json

import pytest
import torch

from ecrad_torch import flagship
from tests.torch_steps import window

torch.set_num_threads(2)

NCOL, BLOCK = 8, 4
# span -> (the span it opens inside, opens in a call of two blocks, each
# with both band sets), in every configuration
SPANS = {
    "ecrad.blocking": (None, 2),
    "ecrad.step": (None, 2),
    "ecrad.generator": ("ecrad.step", 2),
    "ecrad.optics": ("ecrad.step", 2),
    "ecrad.optics.gas": ("ecrad.optics", 2),
    "ecrad.optics.aerosol": ("ecrad.optics", 2),
    "ecrad.optics.cloud": ("ecrad.optics", 2),
    "ecrad.solvers": ("ecrad.step", 4),
    "ecrad.outputs": ("ecrad.step", 6),
}
# the McICA generator's cumulator and sampler, in each band set
GENERATOR = {
    "ecrad.generator.cumulator": ("ecrad.generator", 4),
    "ecrad.generator.sampler": ("ecrad.generator", 4),
}
# the three regions and their overlap matrices, built in each band set
REGIONS = {"ecrad.solvers.regions": ("ecrad.solvers", 4)}
# SPARTACUS: besides the regions, in each band set the exponential mask,
# the sweep arguments before and after the layer matrices, the layer
# matrices, the sweeps and the flux profiles from their outputs, the g
# permutation, into SPARTACUS order and back, and in the LW band set the
# LW derivatives
SPARTACUS = {**REGIONS,
             "ecrad.solvers.mask": ("ecrad.solvers", 4),
             "ecrad.solvers.sweep_inputs": ("ecrad.solvers", 8),
             "ecrad.solvers.layer_mats": ("ecrad.solvers", 4),
             "ecrad.solvers.sweeps": ("ecrad.solvers", 4),
             "ecrad.solvers.lw_derivatives": ("ecrad.solvers", 2),
             "ecrad.solvers.assemble": ("ecrad.solvers", 4),
             "ecrad.solvers.reorder": ("ecrad.solvers", 8)}
# configuration -> (its own spans, the levels its step runs on)
CONFIGS = {"mcica_rrtmg": (GENERATOR, None),
           "ecckd_mcica": (GENERATOR, None),
           "tripleclouds_ecckd": (REGIONS, None),
           "spartacus_ecckd": (SPARTACUS, slice(88, 100)),
           "spartacus_3d": (SPARTACUS, slice(88, 100))}


def spans_of(name):
    return {**SPANS, **CONFIGS[name][0]}


@pytest.fixture(scope="module")
def steps():
    """(config name, dtype) -> (blocked step, its arguments), built once."""
    built = {}

    def get(name, dtype):
        if (name, dtype) not in built:
            step, args = flagship.build(
                ncol=NCOL, dtype=dtype, device="cpu", block_size=BLOCK,
                config_name=name)
            levels = CONFIGS[name][1]
            if levels is not None:
                args = window(args, levels, torch.as_tensor)
            built[name, dtype] = step, args
        return built[name, dtype]
    return get


def _profiled(step, args, tmp_path):
    """The step's Flux under torch.profiler, and the ``ecrad.`` ranges of
    its trace: [(name, start us, end us, thread)]."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        flux = step(*args)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return flux, [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
                  for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith("ecrad.")]


@pytest.mark.parametrize("name", CONFIGS)
def test_spans_counted_and_nested(steps, name, tmp_path):
    _, spans = _profiled(*steps(name, torch.float64), tmp_path)
    expected = spans_of(name)
    counts = collections.Counter(span for span, *_ in spans)
    assert counts == {span: n for span, (_, n) in expected.items()}
    for span, start, end, tid in spans:
        parent = expected[span][0]
        if parent is None:
            continue
        assert any(p == parent and p_tid == tid and p_start <= start
                   and end <= p_end
                   for p, p_start, p_end, p_tid in spans), (span, parent)


@pytest.mark.parametrize("name", CONFIGS)
def test_no_range_without_a_profiler(steps, name, monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, span, *a, **kw):
            opened.append(span)
            super().__init__(span, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    step, args = steps(name, torch.float64)
    step(*args)
    assert opened == []
    _profiled(step, args, tmp_path)
    assert collections.Counter(opened) == {
        span: n for span, (_, n) in spans_of(name).items()}


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
@pytest.mark.parametrize("name", CONFIGS)
def test_fluxes_same_with_a_profiler(steps, name, dtype, tmp_path):
    step, args = steps(name, dtype)
    plain = step(*args).fields()
    traced, _ = _profiled(step, args, tmp_path)
    traced = traced.fields()
    assert plain.keys() == traced.keys()
    for field, value in plain.items():
        assert torch.equal(value, traced[field]), field
