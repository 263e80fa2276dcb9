"""Kernel launches by span in a traced run: the host's runtime or driver
calls that launch a kernel (``LaunchKernel`` in their name, as
``trace.lost_kernels`` counts them) that began while a span of the
program was open on the launching thread, per block."""

from __future__ import annotations

from benchmark import spans, trace


def launches_in(tr: trace.Trace, name: str) -> int:
    """The kernel launches whose host call began while a range called
    ``name`` was open on the launching thread."""
    inside = trace._intervals(tr, name)
    return sum(1 for ts, tid, call in tr.launches.values()
               if "LaunchKernel" in call and trace._inside(inside, ts, tid))


def per_block(run, name: str):
    """``launches_in`` over the number of ``ecrad.step`` spans (one per
    NPROMA block); None where the trace holds no span of either name."""
    steps = spans.count(run.trace, spans.STEP)
    if not steps or not spans.count(run.trace, name):
        return None
    return launches_in(run.trace, name) / steps
