"""The 95th percentile of the window's call times, each from the call's
start to its synchronised end (the nearest-rank percentile over all
calls)."""

import math


def read(run):
    if not run.calls:
        return None
    times = sorted(end - start for start, end in run.calls)
    return 1e3 * times[max(0, math.ceil(0.95 * len(times)) - 1)]
