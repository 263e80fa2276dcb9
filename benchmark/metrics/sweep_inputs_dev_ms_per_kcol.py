"""Device time of the SPARTACUS sweep arguments per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.sweep_inputs`` span
was open (in ``spartacus.sw_sweep_args`` / ``lw_sweep_args``, twice a band
set: the angles, transfer rates and LW aspect ratio before the layer
matrices; the masks, entrapment stack, interface matrices, albedo planes
and top sources after), over the traced columns.  A program without the
span reads nothing."""

from benchmark import spans

SWEEP_INPUTS = "ecrad.solvers.sweep_inputs"


def read(run):
    return spans.device_ms_per_kcol(run, SWEEP_INPUTS)
