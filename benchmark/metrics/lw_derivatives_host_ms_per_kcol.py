"""Host time of the SPARTACUS LW derivatives per 1000 columns: the
duration of the program's ``ecrad.solvers.lw_derivatives`` span (once a
block, around the level loop of ``solver_spartacus_lw``) less the host's
waits for the device inside it, over the traced columns.  A program
without the span reads nothing."""

from benchmark import spans

LW_DERIVATIVES = "ecrad.solvers.lw_derivatives"


def read(run):
    return spans.host_ms_per_kcol(run, LW_DERIVATIVES)
