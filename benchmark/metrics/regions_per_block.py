"""How many times a block builds its regions: the opens of the program's
``ecrad.solvers.regions`` span over the number of ``ecrad.step`` spans
(one per NPROMA block).  Each band set builds the same region fractions
and overlap matrices, so a block that builds them once would read 1."""

from benchmark import spans

REGIONS = "ecrad.solvers.regions"


def read(run):
    steps = spans.count(run.trace, spans.STEP)
    opens = spans.count(run.trace, REGIONS)
    if not steps or not opens:
        return None
    return opens / steps
