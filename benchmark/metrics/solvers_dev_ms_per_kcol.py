"""Device time of the solvers layer per 1000 columns: the kernels launched
while its range (``bench.solvers``) was open, over the traced columns."""

from benchmark import trace


def read(run):
    if not any(r[0] == "bench.solvers" for r in run.trace.ranges):
        return None
    return 1e-3 * trace.range_device_us(run.trace, "bench.solvers") / run.kcol
