"""The share of the device's idle time in the traced stretch during which
no span of the program (``ecrad.*``) was open on the calls' thread: the
idle time the program's spans cannot put down to a layer (between calls,
the harness's synchronise, the blocking's own Python)."""

from benchmark import spans


def read(run):
    return spans.unspanned_idle_pct(run)
