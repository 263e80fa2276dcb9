"""Device time of the SPARTACUS adding sweeps per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.sweeps`` span was
open (``cuda_spartacus.sw_sweeps`` / ``lw_sweeps``, once a band set:
``spartacus_sw_kernel``, ``spartacus_lw_kernel``), over the traced
columns.  A program without the span reads nothing."""

from benchmark import spans

SWEEPS = "ecrad.solvers.sweeps"


def read(run):
    return spans.device_ms_per_kcol(run, SWEEPS)
