"""Kernel launches of the SPARTACUS LW derivatives per block: the
launches whose host call began while the program's
``ecrad.solvers.lw_derivatives`` span was open on the launching thread,
over the number of ``ecrad.step`` spans (one per NPROMA block).  A
program without the span reads nothing."""

from benchmark import launches

LW_DERIVATIVES = "ecrad.solvers.lw_derivatives"


def read(run):
    return launches.per_block(run, LW_DERIVATIVES)
