"""Device time of the generator layer per 1000 columns: the kernels launched
while its range (``bench.generator``) was open, over the traced columns."""

from benchmark import trace


def read(run):
    if not any(r[0] == "bench.generator" for r in run.trace.ranges):
        return None
    return 1e-3 * trace.range_device_us(run.trace, "bench.generator") / run.kcol
