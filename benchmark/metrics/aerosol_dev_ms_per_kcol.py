"""Device time of the aerosol optics per 1000 columns: the kernels
launched while the program's ``ecrad.optics.aerosol`` span was open (the
aerosols' band properties and their merge into the gas optics,
``add_aerosol_optics``), over the traced columns.  A part of
``optics_dev_ms_per_kcol``."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_kcol(run, spans.AEROSOL)
