"""The device's busy time per 1000 columns: the union of its kernels',
copies' and fills' intervals over the traced stretch, over the traced
columns.  It leaves out the host, so it stays steady where the host's
speed moves ``cols_per_s`` from run to run."""

from benchmark import trace


def read(run):
    busy = trace.busy_us(run.trace, run.lo, run.hi)
    if busy <= 0:
        return None
    return 1e-3 * busy / run.kcol
