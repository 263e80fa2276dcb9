"""The host's waits for the device per block: the runtime calls that
block until the device has done the work queued before them (a
synchronise, or a copy to the host) that began while the program's
``ecrad.step`` span was open, over the number of ``ecrad.step`` spans
(one per NPROMA block).  Each drains the card's queue inside the step."""

from benchmark import spans


def read(run):
    steps = spans.count(run.trace, spans.STEP)
    if not steps:
        return None
    return spans.waits_in(run.trace, spans.STEP) / steps
