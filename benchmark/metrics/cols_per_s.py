"""Columns per second: every column of the calls completed in the window,
over the time from the window's start to the end of the last call."""


def read(run):
    if not run.calls:
        return None
    return len(run.calls) * run.ncol / (run.calls[-1][1] - run.window_start)
