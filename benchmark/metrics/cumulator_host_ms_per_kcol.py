"""Host time of the cloud generator's cumulator per 1000 columns: the
duration of the program's ``ecrad.generator.cumulator`` spans (the
overlap cumulator's per-level loop and the packing of the scan's
scalars, once per band set) less the host's waits inside them, over the
traced columns.  A part of ``generator_host_ms_per_kcol``."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_kcol(run, spans.CUMULATOR)
