"""Device time of the SPARTACUS flux assembly per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.assemble`` span was
open (the per-g half-level profiles from the sweeps' outputs, once a
band set: the top-of-atmosphere rows, night masking, and the broadband
and per-band sums of ``outputs.sw_from_g_profiles`` /
``lw_from_g_profiles``), over the traced columns.  A program without the
span reads nothing."""

from benchmark import spans

ASSEMBLE = "ecrad.solvers.assemble"


def read(run):
    return spans.device_ms_per_kcol(run, ASSEMBLE)
