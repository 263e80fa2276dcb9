"""The device's idle time while the host was in the SPARTACUS LW
derivatives, per 1000 columns: the stretches in which no kernel, copy or
fill ran while the program's ``ecrad.solvers.lw_derivatives`` span was
open on the calls' thread, over the traced columns.  A level loop that
launches small kernels faster than the card runs them reads 0; one that
launches slower leaves the card waiting."""

from benchmark import spans

LW_DERIVATIVES = "ecrad.solvers.lw_derivatives"


def read(run):
    return spans.idle_ms_per_kcol(run, LW_DERIVATIVES)
