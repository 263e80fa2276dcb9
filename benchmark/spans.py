"""The program's own spans in a traced run: the ``ecrad.*`` ranges that
``ecrad_torch.profiling.scope`` opens inside the step while a profiler
records, found by name, and what the metric readers take from them.

A span's device time is its kernels' time and its host time its duration
less the host's waits inside it (``trace.range_device_us``,
``trace.range_host_us``).  Its idle time is the device's idle time (the
complement of ``trace.busy_intervals`` in the traced stretch) while the
span was open on the thread that drives the calls (``program.CALL``'s).
Each function returns None where the trace holds no span of the name: a
program that opens none reads nothing.
"""

from __future__ import annotations

from benchmark import program, trace

PREFIX = "ecrad."
STEP = "ecrad.step"
BLOCKING = "ecrad.blocking"
GENERATOR = "ecrad.generator"
CUMULATOR = "ecrad.generator.cumulator"
SAMPLER = "ecrad.generator.sampler"
OPTICS = "ecrad.optics"
GAS = "ecrad.optics.gas"
AEROSOL = "ecrad.optics.aerosol"
CLOUD = "ecrad.optics.cloud"
SOLVERS = "ecrad.solvers"
OUTPUTS = "ecrad.outputs"


def count(tr: trace.Trace, name: str) -> int:
    return sum(1 for r in tr.ranges if r[0] == name)


def device_ms_per_kcol(run, name: str):
    if not count(run.trace, name):
        return None
    return 1e-3 * trace.range_device_us(run.trace, name) / run.kcol


def host_ms_per_kcol(run, name: str):
    if not count(run.trace, name):
        return None
    return 1e-3 * trace.range_host_us(run.trace, name) / run.kcol


def waits_in(tr: trace.Trace, name: str) -> int:
    """The number of the host's waits for the device that began while a
    range called ``name`` was open on the waiting thread."""
    return round(trace.range_wait_us(tr._replace(waits=[
        (w, ts, 1.0, tid) for w, ts, _, tid in tr.waits]), name))


def _union(spans) -> list:
    """Sorted disjoint (start, end) pairs covering ``spans``."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap_us(xs, ys) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(run) -> list:
    """The device's idle intervals in the traced stretch [lo, hi]."""
    gaps, t = [], run.lo
    for a, b in trace.busy_intervals(run.trace, run.lo, run.hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if run.hi > t:
        gaps.append((t, run.hi))
    return gaps


def _open(run, keep) -> list:
    """The union of the ranges whose name ``keep`` accepts, open on the
    calls' thread, clipped to [lo, hi]."""
    tid = trace.thread_of(run.trace, program.CALL)
    return _union((max(ts, run.lo), min(ts + dur, run.hi))
                  for n, ts, dur, t in run.trace.ranges
                  if t == tid and keep(n) and ts + dur > run.lo
                  and ts < run.hi)


def idle_ms_per_kcol(run, name: str):
    """The device's idle time while a span called ``name`` was open on
    the calls' thread, per 1000 traced columns."""
    if not count(run.trace, name):
        return None
    under = _overlap_us(idle_intervals(run), _open(run, lambda n: n == name))
    return 1e-3 * under / run.kcol


def unspanned_idle_pct(run):
    """The share of the device's idle time in which no span of the
    program was open on the calls' thread."""
    if not any(r[0].startswith(PREFIX) for r in run.trace.ranges):
        return None
    idle = idle_intervals(run)
    total = sum(b - a for a, b in idle)
    if total <= 0.0:
        return None
    spanned = _overlap_us(idle, _open(run, lambda n: n.startswith(PREFIX)))
    return 100.0 * (total - spanned) / total
