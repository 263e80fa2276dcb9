"""Host time of the outputs per 1000 columns: the duration of the
program's ``ecrad.outputs`` spans (the spectral matrices before the
solvers, and each band set's flux fields after its solver: surface,
TOA and canopy fluxes) less the host's waits inside them, over the
traced columns."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_kcol(run, spans.OUTPUTS)
