"""Device time of the SPARTACUS g permutation per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.reorder`` span was
open (the g-dependent inputs taken into SPARTACUS order, and the solvers'
per-g outputs put back, in each band set), over the traced columns.  A
part of ``solvers_dev_ms_per_kcol``; a program without the span reads
nothing."""

from benchmark import spans

REORDER = "ecrad.solvers.reorder"


def read(run):
    return spans.device_ms_per_kcol(run, REORDER)
