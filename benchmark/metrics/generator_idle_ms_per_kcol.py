"""The device's idle time while the host was in the cloud generator, per
1000 columns: the stretches in which no kernel, copy or fill ran while
the program's ``ecrad.generator`` span was open on the calls' thread,
over the traced columns.  Host work there that launches too little
leaves the card waiting."""

from benchmark import spans


def read(run):
    return spans.idle_ms_per_kcol(run, spans.GENERATOR)
