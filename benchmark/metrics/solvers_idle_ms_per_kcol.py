"""The device's idle time while the host was in the solvers, per 1000
columns: the stretches in which no kernel, copy or fill ran while the
program's ``ecrad.solvers`` span (once a band set, every route) was open
on the calls' thread, over the traced columns."""

from benchmark import spans


def read(run):
    return spans.idle_ms_per_kcol(run, spans.SOLVERS)
