"""Device kernels launched per 1000 columns in the traced stretch."""


def read(run):
    n = sum(1 for k in run.trace.kernels if run.lo <= k[1] < run.hi)
    return n / run.kcol
