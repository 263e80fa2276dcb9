"""Device time of the three regions' set-up per 1000 columns: the kernels
launched while the program's ``ecrad.solvers.regions`` span was open (the
region fractions and od scalings and the overlap matrices, which the
Tripleclouds and SPARTACUS solvers build in each band set), over the
traced columns.  A part of ``solvers_dev_ms_per_kcol``."""

from benchmark import spans

REGIONS = "ecrad.solvers.regions"


def read(run):
    return spans.device_ms_per_kcol(run, REGIONS)
