"""Device time of the SPARTACUS exponential mask per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.mask`` span was open
(``spartacus._use_expm_mask``, the ng3D prefix of each (column, layer),
once a band set), over the traced columns.  A program without the span
reads nothing."""

from benchmark import spans

MASK = "ecrad.solvers.mask"


def read(run):
    return spans.device_ms_per_kcol(run, MASK)
