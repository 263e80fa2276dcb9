"""Host time of the SPARTACUS flux assembly per 1000 columns: the
duration of the program's ``ecrad.solvers.assemble`` spans (once a band
set) less the host's waits for the device inside them, over the traced
columns.  A program without the span reads nothing."""

from benchmark import spans

ASSEMBLE = "ecrad.solvers.assemble"


def read(run):
    return spans.host_ms_per_kcol(run, ASSEMBLE)
