"""Host time of the generator layer per 1000 columns: the duration of its
range (``bench.generator``) less the host's waits for the device inside it
(``trace.range_host_us``; the waits are ``host_wait_ms_per_kcol``'s), over
the traced columns."""

from benchmark import trace


def read(run):
    if not any(r[0] == "bench.generator" for r in run.trace.ranges):
        return None
    return 1e-3 * trace.range_host_us(run.trace, "bench.generator") / run.kcol
