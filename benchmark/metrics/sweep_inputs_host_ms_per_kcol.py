"""Host time of the SPARTACUS sweep arguments per 1000 columns: the
duration of the program's ``ecrad.solvers.sweep_inputs`` spans (twice a
band set, before and after the layer matrices) less the host's waits for
the device inside them, over the traced columns.  A program without the
span reads nothing."""

from benchmark import spans

SWEEP_INPUTS = "ecrad.solvers.sweep_inputs"


def read(run):
    return spans.host_ms_per_kcol(run, SWEEP_INPUTS)
