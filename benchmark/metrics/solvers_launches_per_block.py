"""Kernel launches of the solvers per block: the launches whose host
call began while the program's ``ecrad.solvers`` span (once a band set,
every route) was open on the launching thread, over the number of
``ecrad.step`` spans (one per NPROMA block)."""

from benchmark import launches, spans


def read(run):
    return launches.per_block(run, spans.SOLVERS)
