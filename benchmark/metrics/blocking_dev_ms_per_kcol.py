"""Device time of the column blocking per 1000 columns: the kernels
launched while the program's ``ecrad.blocking`` span was open
(``pipeline.radiation_blocked``'s padding and slicing of the inputs
before the blocks, the concatenation of the blocks' fluxes after), over
the traced columns.  It reads 0 where a call is one block.  The trace
keeps no launch of the device's copies, so a copy it issued would not be
counted: the padding and the concatenation are kernels."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_kcol(run, spans.BLOCKING)
