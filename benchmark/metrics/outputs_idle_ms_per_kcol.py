"""The device's idle time while the host was in the outputs, per 1000
columns: the stretches in which no kernel, copy or fill ran while the
program's ``ecrad.outputs`` span (the spectral matrices, and each band
set's flux fields) was open on the calls' thread, over the traced
columns."""

from benchmark import spans


def read(run):
    return spans.idle_ms_per_kcol(run, spans.OUTPUTS)
