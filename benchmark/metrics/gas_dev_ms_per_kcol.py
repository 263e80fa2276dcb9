"""Device time of the gas optics per 1000 columns: the kernels launched
while the program's ``ecrad.optics.gas`` span was open (the RRTMG, ecCKD
or monochromatic gas optics), over the traced columns.  A part of
``optics_dev_ms_per_kcol``."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_kcol(run, spans.GAS)
