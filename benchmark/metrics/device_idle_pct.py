"""The share of the traced stretch in which no operation runs on the
device (the union of the device's kernels, copies and fills)."""

from benchmark import trace


def read(run):
    lo, hi = run.lo, run.hi
    return 100.0 * (1.0 - trace.busy_us(run.trace, lo, hi) / (hi - lo))
