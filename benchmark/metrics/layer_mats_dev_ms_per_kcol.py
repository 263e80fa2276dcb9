"""Device time of the SPARTACUS layer matrices per 1000 columns: the
kernels launched while the program's ``ecrad.solvers.layer_mats`` span was
open (the build and refine passes of ``cuda_spartacus.sw_layer_mats`` and
``lw_layer_mats``, one launch set a band set), over the traced columns.
A part of ``solvers_dev_ms_per_kcol``; a program without the span reads
nothing."""

from benchmark import spans

LAYER_MATS = "ecrad.solvers.layer_mats"


def read(run):
    return spans.device_ms_per_kcol(run, LAYER_MATS)
