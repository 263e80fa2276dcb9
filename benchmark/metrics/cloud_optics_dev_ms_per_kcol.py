"""Device time of the cloud optics per 1000 columns: the kernels launched
while the program's ``ecrad.optics.cloud`` span was open (the cropped
cloud fraction and the liquid and ice optics), over the traced columns.
A part of ``optics_dev_ms_per_kcol``."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_kcol(run, spans.CLOUD)
