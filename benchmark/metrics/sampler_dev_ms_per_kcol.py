"""Device time of the cloud generator's sampler per 1000 columns: the
kernels launched while the program's ``ecrad.generator.sampler`` span was
open (the Chebyshev PDF sampler and the masks of clear layers and
columns, once per band set), over the traced columns.  A part of
``generator_dev_ms_per_kcol``."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_kcol(run, spans.SAMPLER)
