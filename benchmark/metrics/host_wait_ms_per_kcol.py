"""The host's waits for the device inside the three layers, per 1000
columns: the runtime calls that block until the device has done the work
queued before them (a synchronise, or a copy to the host) that began in
a layer's range, over the traced columns.  A wait there holds the host's
next launches back while the card drains its queue."""

from benchmark import program, trace

LAYERS = (program.GENERATOR, program.OPTICS, program.SOLVERS)


def read(run):
    if not any(r[0] in LAYERS for r in run.trace.ranges):
        return None
    return 1e-3 * sum(trace.range_wait_us(run.trace, name)
                      for name in LAYERS) / run.kcol
